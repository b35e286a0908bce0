"""Host-side span tracer: a ring-buffered, ``perf_counter``-stamped record
of named intervals around the runtime's host phases (cohort sampling,
``round_step`` dispatch, page-in scatters, admission bursts, decode steps,
metrics fetches, checkpoint I/O...).

Design constraints (the whole point of this module):

* **Zero device work.**  The tracer never imports torch on the hot path and
  never touches device tensors — wrapping an asynchronous dispatch in a span
  measures host *enqueue* time, exactly what the dispatch-count regression
  tests measure in counts.  No host syncs, no extra dispatches.
* **Strictly no-op when disabled.**  ``span()`` on a disabled tracer returns
  one shared null context manager — no allocation, no clock read, no
  counter bump.  A disabled engine/trainer is bitwise-invisible: tests
  assert identical dispatch counts and identical outputs either way.
* **Bounded memory.**  Events land in a preallocated ring of ``capacity``
  tuples; overflow overwrites the oldest and bumps ``dropped`` (the
  per-name ``counts`` Counter keeps exact totals regardless — the
  ``--quick-telemetry`` bench modes assert span counts == dispatch counts
  off it, which must survive ring wrap).

``annotate=True`` additionally enters a ``torch.profiler.record_function``
per span so host spans line up with device kernels in a ``torch.profiler``
trace; the import is lazy.
"""

from __future__ import annotations

import collections
import time
from typing import Any

# one event = (name, cat, t0, t1, depth, args); t1 is None for instants
Event = tuple


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

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        tr.counts[self._name] += 1
        tr._depth += 1
        if tr._annotation is not None:
            self._ann = tr._annotation(self._name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr._depth -= 1
        tr._record(self._name, self._cat, self._t0, t1, tr._depth,
                   self._args)
        return False


class SpanTracer:
    """Ring-buffered host span recorder (see module docstring).

    ``counts`` maps span name -> times entered (exact, never dropped);
    ``events()`` returns the retained window oldest-first.
    """

    def __init__(self, capacity: int = 65536, *, enabled: bool = True,
                 annotate: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        self.counts: collections.Counter = collections.Counter()
        self._buf: list[Event | None] = [None] * capacity
        self._n = 0                      # total events ever recorded
        self._depth = 0                  # current nesting depth
        self.t_origin = time.perf_counter()
        self._annotation = None
        if annotate and enabled:
            from torch.profiler import record_function
            self._annotation = record_function

    # ------------------------------------------------------------- recording
    def span(self, name: str, cat: str = "host", **args: Any):
        """Context manager timing one named interval.  Disabled tracers
        return a shared null context — no clock read, no allocation."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        """Record a zero-duration marker (completion events etc.)."""
        if not self.enabled:
            return
        self.counts[name] += 1
        self._record(name, cat, time.perf_counter(), None, self._depth, args)

    def _record(self, name, cat, t0, t1, depth, args) -> None:
        self._buf[self._n % self.capacity] = (name, cat, t0, t1, depth, args)
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
            return [e for e in self._buf[: self._n]]
        i = self._n % self.capacity
        return [e for e in self._buf[i:] + self._buf[:i]]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._n = 0
        self._depth = 0
        self.counts.clear()
        self.t_origin = time.perf_counter()
