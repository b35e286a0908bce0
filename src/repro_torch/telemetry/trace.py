"""Host-side span tracer: a ring-buffered, ``perf_counter``-stamped record
of named intervals around the runtime's host phases (cohort sampling,
``round_step`` dispatch, page-in scatters, admission bursts, decode steps,
metrics fetches, checkpoint I/O...) and, inside a step, around each layer
it launches (:func:`span`).

Design constraints (the whole point of this module):

* **Zero device work.**  The tracer never imports torch on the hot path and
  never touches device tensors — wrapping an asynchronous dispatch in a span
  measures host *enqueue* time, exactly what the dispatch-count regression
  tests measure in counts.  No host syncs, no extra dispatches.
* **Strictly no-op when disabled.**  ``span()`` on a disabled tracer returns
  one shared null context manager — no allocation, no clock read, no
  counter bump.  A disabled engine/trainer is bitwise-invisible: tests
  assert identical dispatch counts and identical outputs either way.
* **Bounded memory.**  Events land in a ring of ``capacity`` tuples, grown
  as events arrive (a disabled tracer holds none); overflow overwrites the
  oldest and bumps ``dropped`` (the per-name ``counts`` Counter keeps exact
  totals regardless — the ``--quick-telemetry`` bench modes assert span
  counts == dispatch counts off it, which must survive ring wrap).

Layer code deep in the model and the kernels' wrappers takes no tracer
argument: it opens :func:`span`, which records into the tracer that the
running step made current (:meth:`SpanTracer.current`; the serving
engine's ``step`` and the trainer's dispatches do) and is the shared null
span otherwise — one global read and one ``None`` test.  There is one
current tracer per process, as a step runs on one thread (autograd's
backward threads open no span).  A profiler trace
of the device can charge each kernel to the innermost span open when the
host launched it, since every span is stamped on the host's
``perf_counter``.
"""

from __future__ import annotations

import collections
import time
import types
from typing import Any

# one event = (name, cat, t0, t1, depth, args); t1 is None for instants
Event = tuple

#: the arguments of every layer span (none; shared, read-only)
_NO_ARGS = types.MappingProxyType({})

#: the tracer the running step records layer spans into (``None``: no
#: step of an enabled runtime is running)
_current: "SpanTracer | None" = None


class _NullSpan:
    """Shared do-nothing context manager — the disabled-path span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: counts on enter, records the interval on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        tr = self._tracer
        tr.counts[self._name] += 1
        tr._depth += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._depth -= 1
        tr._record((self._name, self._cat, self._t0, t1, tr._depth,
                    self._args))
        return False


class _Current:
    """Makes a tracer current for :func:`span` until exit, then restores
    the one that was."""

    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer: "SpanTracer"):
        self._tracer = tracer

    def __enter__(self):
        global _current
        self._prev, _current = _current, self._tracer
        return self

    def __exit__(self, *exc):
        global _current
        _current = self._prev
        return False


def span(name: str, cat: str = "layer"):
    """A span, with no arguments, on the tracer that the running step made
    current; the shared null span when none is."""
    tr = _current
    if tr is None:
        return _NULL_SPAN
    return _Span(tr, name, cat, _NO_ARGS)


class SpanTracer:
    """Ring-buffered host span recorder (see module docstring).

    ``counts`` maps span name -> times entered (exact, never dropped);
    ``events()`` returns the retained window oldest-first.
    """

    def __init__(self, capacity: int = 1 << 18, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        self.counts: collections.Counter = collections.Counter()
        self._buf: list[Event] = []
        self._n = 0                      # total events ever recorded
        self._depth = 0                  # current nesting depth
        self.t_origin = time.perf_counter()

    # ------------------------------------------------------------- recording
    def span(self, name: str, cat: str = "host", **args: Any):
        """Context manager timing one named interval.  Disabled tracers
        return a shared null context — no clock read, no allocation."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def current(self):
        """Context manager under which :func:`span` records here (a null
        context when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Current(self)

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        """Record a zero-duration marker (completion events etc.)."""
        if not self.enabled:
            return
        self.counts[name] += 1
        self._record((name, cat, time.perf_counter(), None, self._depth,
                      args))

    def _record(self, event: Event) -> None:
        if self._n < self.capacity:
            self._buf.append(event)
        else:
            self._buf[self._n % self.capacity] = event
        self._n += 1

    # --------------------------------------------------------------- reading
    @property
    def n_recorded(self) -> int:
        """Total events ever recorded (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events lost to ring overwrite."""
        return max(0, self._n - self.capacity)

    def events(self) -> list[Event]:
        """Retained events, oldest first."""
        if self._n <= self.capacity:
            return list(self._buf)
        i = self._n % self.capacity
        return self._buf[i:] + self._buf[:i]

    def clear(self) -> None:
        self._buf = []
        self._n = 0
        self._depth = 0
        self.counts.clear()
        self.t_origin = time.perf_counter()
