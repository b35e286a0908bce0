"""Unified telemetry: host span tracing, a metrics registry, and
Perfetto/Prometheus exporters — the measurement layer under the serving
runtime.

One :class:`Telemetry` object bundles a :class:`~repro_torch.telemetry.trace.
SpanTracer` and a :class:`~repro_torch.telemetry.metrics.MetricsRegistry` and is
threaded through ``ServingEngine(telemetry=...)`` and the adapter store.  Everything it records is
host-side only: spans time host phases (including the host *enqueue* of
asynchronous kernel launches), metrics absorb the pre-existing
``dispatch_count`` / ``health`` Counters plus pager hit rates, queue
depth, TTFT/latency/queue-wait histograms.  It therefore adds ZERO host
syncs and ZERO extra dispatches — the dispatch-count regression tests pass
with telemetry enabled or disabled, bit-identically.

Enablement gates the *tracer* (``enabled=False`` makes ``span()`` a shared
no-op); an enabled runtime makes its tracer current for each step
(:meth:`Telemetry.current`), so the layers it launches open spans through
the module-level :func:`span` without a tracer argument.  The metrics
registry is always live because its counters predate
this module (see ``metrics.py``).  Runtimes constructed without a
``telemetry=`` argument get their own private disabled instance, so
registries are never accidentally shared across trainers/engines.

Typical use::

    tel = Telemetry(enabled=True)
    engine = ServingEngine(..., telemetry=tel)
    engine.run(requests)
    tel.save_chrome_trace("serve.trace.json")   # open in ui.perfetto.dev
    print(tel.prometheus())                     # scrape-style snapshot
"""

from __future__ import annotations

from repro_torch.telemetry.export import (chrome_trace, prometheus_text,
                                    save_chrome_trace)
from repro_torch.telemetry.metrics import (Counter, Gauge, MetricsRegistry,
                                     StreamingHistogram)
from repro_torch.telemetry.trace import SpanTracer, span

__all__ = ["Telemetry", "SpanTracer", "span", "MetricsRegistry",
           "StreamingHistogram", "Counter", "Gauge", "chrome_trace",
           "save_chrome_trace", "prometheus_text"]


class Telemetry:
    """Tracer + registry bundle (see module docstring).

    ``enabled`` gates tracing; ``capacity`` bounds the span ring buffer
    (the default holds about 5,000 engine steps of a hybrid MoE stack's
    layer spans).
    """

    def __init__(self, enabled: bool = True, *, capacity: int = 1 << 18):
        self.enabled = enabled
        self.tracer = SpanTracer(capacity, enabled=enabled)
        self.metrics = MetricsRegistry()

    # ---------------------------------------------------------------- spans
    def span(self, name: str, cat: str = "host", **args):
        return self.tracer.span(name, cat, **args)

    def current(self):
        """Make this tracer the one :func:`span` records into, until exit
        (a null context when tracing is disabled)."""
        return self.tracer.current()

    def instant(self, name: str, cat: str = "host", **args) -> None:
        self.tracer.instant(name, cat, **args)

    # -------------------------------------------------------------- exports
    def chrome_trace(self) -> dict:
        return chrome_trace(self.tracer)

    def save_chrome_trace(self, path: str) -> None:
        save_chrome_trace(path, self.tracer)

    def prometheus(self) -> str:
        return prometheus_text(self.metrics)

    def snapshot(self) -> dict:
        return self.metrics.snapshot()
