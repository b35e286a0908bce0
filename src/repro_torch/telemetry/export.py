"""Exporters: Chrome/Perfetto trace-event JSON (timelines) and Prometheus
text exposition (scrape-style metric snapshots).

Chrome trace format (the subset emitted here, loadable by ``ui.perfetto.dev``
and ``chrome://tracing``):

* spans -> complete events ``{"ph": "X", "ts": <µs>, "dur": <µs>, "name",
  "cat", "pid", "tid", "args"}`` — timestamps are microseconds relative to
  the tracer's origin, so a timeline always starts near 0;
* instants -> ``{"ph": "i", "ts": <µs>, "s": "t"}``;
* one ``"M"`` (metadata) event names the process.

Prometheus exposition: counters as ``<name>_total``, counter groups as
``<name>_total{key="..."}``, gauges plain, histograms as summaries
(``{quantile="0.5|0.95|0.99"}`` samples plus ``_sum`` / ``_count``).
Metric names are sanitised to ``[a-zA-Z0-9_:]``.
"""

from __future__ import annotations

import json
import math
import re

from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.trace import SpanTracer

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def chrome_trace(tracer: SpanTracer, *, pid: int = 0, tid: int = 0,
                 process_name: str = "repro") -> dict:
    """Export the tracer's retained events as a Chrome trace-event JSON
    document (``{"traceEvents": [...], "displayTimeUnit": "ms"}``)."""
    t0 = tracer.t_origin
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": tid,
        "args": {"name": process_name}}]
    spans = []
    for name, cat, s0, s1, depth, args in tracer.events():
        ev = {"name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": (s0 - t0) * 1e6}
        if s1 is None:                       # instant marker
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = (s1 - s0) * 1e6
        if args:
            ev["args"] = dict(args)
        spans.append(ev)
    spans.sort(key=lambda e: e["ts"])
    events.extend(spans)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.dropped}}


def save_chrome_trace(path: str, tracer: SpanTracer, **kw) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, **kw), f)


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry as Prometheus text exposition format."""
    lines: list[str] = []
    snap = registry.snapshot()
    for name, value in snap["counters"].items():
        n = _sanitize(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n}_total {_fmt(value)}")
    for name, group in snap["counter_groups"].items():
        n = _sanitize(name)
        lines.append(f"# TYPE {n} counter")
        for key, value in sorted(group.items()):
            k = key.replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f'{n}_total{{key="{k}"}} {_fmt(value)}')
    for name, value in snap["gauges"].items():
        n = _sanitize(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(value)}")
    for name, s in snap["histograms"].items():
        n = _sanitize(name)
        lines.append(f"# TYPE {n} summary")
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            lines.append(f'{n}{{quantile="{q}"}} {_fmt(s[key])}')
        lines.append(f"{n}_sum {_fmt(s['sum'])}")
        lines.append(f"{n}_count {_fmt(s['count'])}")
    return "\n".join(lines) + "\n"
