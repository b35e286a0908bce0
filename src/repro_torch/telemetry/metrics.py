"""Metrics registry: named counters, gauges (direct or callback-backed) and
streaming histograms with reservoir-sampled quantiles.

The registry is ALWAYS live — unlike spans, metric recording predates this
module (``dispatch_count``, ``trainer.health``, pager eviction counts were
already host Counters) and costs O(1) host float work with zero device
traffic, so there is nothing to gate.  Disabling telemetry disables
*tracing*; the metrics a runtime was already keeping stay exact.

Back-compat is structural: :meth:`MetricsRegistry.counter_group` registers
a real ``collections.Counter`` (optionally one the caller already owns), so
``trainer.dispatch_count`` / ``trainer.health`` / ``store.dispatch_count``
remain genuine Counters — every existing ``dict(...)`` / ``[name] += 1`` /
``.clear()`` call site works unchanged while the registry's snapshot and
Prometheus exposition see the same live object.

:class:`StreamingHistogram` keeps exact count/sum/min/max plus a
reservoir-sampled window (algorithm R, deterministic seed): for streams no
longer than the reservoir the quantiles are *exactly* ``np.quantile`` of
the full stream (tested); beyond that they are an unbiased uniform sample.
"""

from __future__ import annotations

import collections
import math
from typing import Any, Callable

import numpy as np

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


class Counter:
    """Monotonic scalar counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value gauge."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class StreamingHistogram:
    """Streaming quantile estimator: exact count/sum/min/max + reservoir.

    ``quantile(q)`` equals ``np.quantile`` over the full stream whenever
    ``count <= reservoir`` (the buffer IS the stream); larger streams get
    an unbiased uniform subsample (algorithm R) with a deterministic PRNG
    so repeated runs snapshot identically.
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_buf", "_cap",
                 "_rng")

    def __init__(self, name: str, reservoir: int = 4096, seed: int = 0):
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buf: list[float] = []
        self._cap = reservoir
        self._rng = np.random.default_rng(seed)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._buf) < self._cap:
            self._buf.append(x)
        else:                           # algorithm R replacement
            j = int(self._rng.integers(0, self.count))
            if j < self._cap:
                self._buf[j] = x

    def quantile(self, q: float) -> float:
        if not self._buf:
            return math.nan
        return float(np.quantile(np.asarray(self._buf), q))

    def quantiles(self, qs=DEFAULT_QUANTILES) -> dict:
        if not self._buf:
            return {q: math.nan for q in qs}
        vals = np.quantile(np.asarray(self._buf), list(qs))
        return {q: float(v) for q, v in zip(qs, vals)}

    def summary(self) -> dict:
        qs = self.quantiles()
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else math.nan,
                "max": self.max if self.count else math.nan,
                "p50": qs[0.5], "p95": qs[0.95], "p99": qs[0.99]}


class MetricsRegistry:
    """Name-keyed registry of counters / gauges / histograms / counter
    groups.  Registration is idempotent by name (same kind returns the
    existing object; a kind clash raises — two subsystems silently sharing
    a name across kinds is a bug, not a merge)."""

    def __init__(self):
        self._metrics: dict[str, tuple[str, Any]] = {}

    # ---------------------------------------------------------- registration
    def _get_or_make(self, name: str, kind: str, make: Callable[[], Any]):
        if name in self._metrics:
            k, obj = self._metrics[name]
            if k != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {k}, not {kind}")
            return obj
        obj = make()
        self._metrics[name] = (kind, obj)
        return obj

    def counter(self, name: str) -> Counter:
        return self._get_or_make(name, "counter", lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_make(name, "gauge", lambda: Gauge(name))

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Callback gauge: ``fn`` is evaluated lazily at snapshot/export
        time (queue depth, slot occupancy, pager hit rate — values that are
        free to read but pointless to push).  Re-registering replaces the
        callback (an engine rebuilt over the same registry wins)."""
        if name in self._metrics and self._metrics[name][0] != "gauge_fn":
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{self._metrics[name][0]}, not gauge_fn")
        self._metrics[name] = ("gauge_fn", fn)

    def histogram(self, name: str, *, reservoir: int = 4096,
                  seed: int = 0) -> StreamingHistogram:
        return self._get_or_make(
            name, "histogram",
            lambda: StreamingHistogram(name, reservoir, seed))

    def counter_group(self, name: str,
                      counter: collections.Counter | None = None
                      ) -> collections.Counter:
        """Register (or adopt) a labelled counter family backed by a real
        ``collections.Counter`` — THE back-compat bridge: the returned
        object is a genuine Counter the owner mutates directly
        (``dispatch_count["round_step"] += 1``), while snapshots and the
        Prometheus exposition read it live.  Passing ``counter`` adopts an
        existing instance (e.g. a store's counter shared with an engine);
        re-registering the same name with a different instance rebinds to
        the new one (latest owner wins)."""
        if counter is None:
            if name in self._metrics:
                k, obj = self._metrics[name]
                if k != "counter_group":
                    raise ValueError(
                        f"metric {name!r} already registered as {k}, not "
                        "counter_group")
                return obj
            counter = collections.Counter()
        self._metrics[name] = ("counter_group", counter)
        return counter

    # --------------------------------------------------------------- reading
    def kinds(self) -> dict:
        return {n: k for n, (k, _) in self._metrics.items()}

    def get(self, name: str):
        """The registered object for ``name`` (``None`` when absent) —
        readers (benches, SLO reports) inspect a histogram or counter
        without registering one as a side effect."""
        entry = self._metrics.get(name)
        return entry[1] if entry is not None else None

    def snapshot(self) -> dict:
        """Plain-JSON view of every metric (gauge callbacks evaluated
        now; histograms summarised to count/sum/min/max/p50/p95/p99)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "counter_groups": {}}
        for name, (kind, obj) in sorted(self._metrics.items()):
            if kind == "counter":
                out["counters"][name] = obj.value
            elif kind == "gauge":
                out["gauges"][name] = obj.value
            elif kind == "gauge_fn":
                out["gauges"][name] = float(obj())
            elif kind == "histogram":
                out["histograms"][name] = obj.summary()
            elif kind == "counter_group":
                out["counter_groups"][name] = {str(k): float(v)
                                               for k, v in obj.items()}
        return out
