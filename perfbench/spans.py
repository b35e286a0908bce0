"""Device time by the port's spans: each device operation of a traced
window is charged, as self time, to the innermost ``Telemetry`` span open
on the host when it was launched.

A CUPTI trace links each kernel, copy and memset to the CUDA runtime or
driver call that issued it (the device event's ``linked_correlation_id``
is the launch's ``correlation_id``), and the launch carries a timestamp
on the trace's clock.  The host's spans go onto that clock through two
groups of marks, as the trace starts and before it stops: launches of a
no-op kernel (``torch.cuda._sleep(0)``), each between two ``perf_counter``
reads, give the clocks' offset at each end, to within about ten microseconds,
and the line through both takes up their drift (a group the trace lost
leaves the other's offset alone; ``marks`` in the output counts each).
``tracing.py``'s one anchor, the host's clock read before a
``cudaDeviceSynchronize``, puts the spans 0.07-0.15 ms late on one H100's
host, which charges a span's first launches to the span before it
(``clock_us`` in the output: that anchor's error at each end).  The kernels that autograd's thread launches
during a backward are charged to the span open on the main thread at that
moment (``fwd_bwd``).

``tracing.Trace.summary`` reads no launches, so the result line of
``run.py`` has no such split.  This module's command runs one cell as
``run.py --trace 1`` does, prints that result line, and then, on standard
error, one line ``spans: {...}`` with the split and what it gives per
step or round::

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import heapq
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

#: launches in each group of clock marks, and the kernel they launch
MARKS, MARK_KERNEL = 32, "spin_kernel"

#: where an operation goes whose launch the window's spans cannot place
BEFORE = "launched before the window"
OUTSIDE = "launched outside any span"
UNLINKED = "launch not in the trace"


def charge(dev, launches: dict, spans, w0: int, w1: int) -> dict:
    """``{(span, operation name): (ops, device seconds)}`` over device
    events ``(start_ns, end_ns, name, correlation)``, clipped to the window
    ``w0`` .. ``w1`` as ``tracing.reduce_events`` clips them (given its
    window, the seconds sum to its ``ops`` total).  ``launches`` maps a
    correlation id to its launch's start; ``spans`` are ``(name, start,
    end)``; all in ns on the trace's clock.  Each operation goes to the
    innermost span open at its launch, or to :data:`BEFORE`,
    :data:`OUTSIDE` or :data:`UNLINKED`."""
    out: dict = defaultdict(lambda: [0, 0.0])
    placed = []
    for s, t, name, corr in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        at = launches.get(corr)
        if at is None:
            label = UNLINKED
        elif at < w0:
            label = BEFORE
        else:
            placed.append((at, t - s, name))
            continue
        out[label, name][0] += 1
        out[label, name][1] += (t - s) / 1e9
    host = sorted((a, b, n) for n, a, b in spans)
    heap: list = []            # (-start, end, name): the latest start first
    i = 0
    for at, ns, name in sorted(placed):
        while i < len(host) and host[i][0] <= at:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < at:
            heapq.heappop(heap)
        label = heap[0][2] if heap else OUTSIDE
        out[label, name][0] += 1
        out[label, name][1] += ns / 1e9
    return {k: (v[0], v[1]) for k, v in out.items()}


def by_span(charged: dict) -> dict:
    """:func:`charge`'s result summed by span: ``{span: (ops, device
    seconds)}``."""
    out: dict = defaultdict(lambda: [0, 0.0])
    for (label, _), (n, s) in charged.items():
        out[label][0] += n
        out[label][1] += s
    return {k: (v[0], v[1]) for k, v in out.items()}


def top_ops(charged: dict, k: int = 3) -> dict:
    """The ``k`` operations with most device time under each span, as
    ``[name (its first 80 characters), ops, seconds]``."""
    out: dict = defaultdict(list)
    for (label, name), (n, s) in charged.items():
        out[label].append([name[:80], n, s])
    return {lab: sorted(v, key=lambda x: -x[2])[:k] for lab, v in out.items()}


def host_seconds(spans, t0: float, t1: float) -> dict:
    """``{span: (count, host seconds)}`` of the spans that start in the
    window ``t0`` .. ``t1``: what the host spent inside each, its enqueue
    and any wait for a full launch queue."""
    out: dict = defaultdict(lambda: [0, 0.0])
    for n, a, b in spans:
        if t0 <= a < t1:
            out[n][0] += 1
            out[n][1] += b - a
    return {k: (v[0], v[1]) for k, v in out.items()}


def to_trace(h0: int, s0: int, h1: int, s1: int):
    """Host seconds → ns on the trace's clock, the line through two
    moments known on both: host ns ``h0`` at trace ns ``s0``, ``h1`` at
    ``s1``."""
    rate = (s1 - s0) / (h1 - h0)
    return lambda t: s0 + round((t * 1e9 - h0) * rate)


def marks(pause: float = 0.0) -> list:
    """Host ns ``(before, after)`` around each of :data:`MARKS` launches
    of a no-op kernel, after ``pause`` seconds."""
    import time

    import torch
    time.sleep(pause)
    out = []
    for _ in range(MARKS):
        a = time.perf_counter_ns()
        torch.cuda._sleep(0)
        out.append((a, time.perf_counter_ns()))
    return out


def anchor(host: list, stamps: list) -> tuple[int, int]:
    """One moment on both clocks from a group of marks: the median of the
    host's midpoints, and that plus the median of each launch's stamp
    minus its midpoint."""
    mids = [(a + b) // 2 for a, b in host]
    mid = int(statistics.median(mids))
    return mid, mid + int(statistics.median(
        s - m for s, m in zip(sorted(stamps), mids)))


def read_events(prof) -> tuple[list, dict, list]:
    """The device events ``(start_ns, end_ns, name, correlation)``, the
    launches ``{correlation: start_ns}`` and the ``(start_ns, end_ns)`` of
    each ``cudaDeviceSynchronize`` of a finished ``torch.profiler`` run."""
    import torch

    from perfbench.tracing import SYNC, _span_ns
    dev, launches, syncs = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((*_span_ns(e), e.name(), e.linked_correlation_id()
                        or e.correlation_id()))
            continue
        if e.correlation_id():
            launches[e.correlation_id()] = _span_ns(e)[0]
        if e.name() == SYNC:
            syncs.append(_span_ns(e))
    return dev, launches, sorted(syncs)


def _per(rec: dict, spans: dict) -> dict:
    """What the split gives per engine step or per round, with each
    roofline over the device time charged to the operation's own span."""
    from perfbench import peaks
    sec = {k: s for k, (_, s) in spans.items()}
    out = {}
    if rec.get("rounds"):
        n = rec["rounds"]
        out["fwd_bwd_s"] = sec.get("fwd_bwd", 0.0) / n
        out["optimizer_s"] = sec.get("optimizer", 0.0) / n
        out["server_ms"] = 1e3 * sum(sec.get(k, 0.0) for k in (
            "edit", "aggregate", "dim_agg", "scatter")) / n
        if sec.get("dim_agg"):
            f, b = rec["dim_agg_work_per_round"]
            out["dim_agg_span_roofline"] = (
                100.0 * peaks.roofline_seconds(f * n, b * n)
                / sec["dim_agg"])
    if rec.get("steps"):
        n = rec["steps"]
        for k in ("mamba_mixer", "attn_mixer", "moe", "bgmv", "serve_embed",
                  "serve_head", "serve_step"):
            out[f"{k}_ms"] = 1e3 * sec.get(k, 0.0) / n
        if sec.get("bgmv"):
            out["bgmv_span_roofline"] = (
                100.0 * peaks.roofline_seconds(*rec["bgmv_work"])
                / sec["bgmv"])
    return out


def main(argv=None) -> int:
    """Run one cell traced through ``run.main`` with the trace's reduction
    and the host spans read besides, then print the split."""
    from perfbench import harness, run, tracing
    got: dict = {}

    class SpanTrace(tracing.Trace):
        def start(self):
            super().start()
            if self.enabled:
                self.marks = [marks()]

        def stop(self):
            if self.prof is not None:
                # 2 ms on, past the window's end as tracing.py places it
                self.marks.append(marks(0.002))
            super().stop()

        def summary(self, spans, t0, t1):
            out = super().summary(spans, t0, t1)
            if out is not None:
                dev, launches, syncs = read_events(self.prof)
                # the window as tracing.reduce_events clips it
                off = syncs[0][0] - self._sync_ns
                half = int((t0 + t1) / 2 * 1e9) + off
                stamps = sorted(launches[c] for _, _, n, c in dev
                                if MARK_KERNEL in n)
                groups = ([s for s in stamps if s < half],
                          [s for s in stamps if s >= half])
                got["marks"] = [len(g) for g in groups]
                ends = [anchor(m, g) for m, g in zip(self.marks, groups)
                        if len(g) == MARKS]
                if not ends:
                    raise RuntimeError(f"clock marks in the trace: "
                                       f"{got['marks']}, not {MARKS} each")
                h, s = ends[0]        # one group alone: its offset, no drift
                clock = to_trace(*ends[0], *ends[-1]) if len(ends) == 2 \
                    else to_trace(h, s, h + 10**9, s + 10**9)
                got["charged"] = charge(
                    dev, launches, [(n, clock(a), clock(b))
                                    for n, a, b in spans],
                    int(t0 * 1e9) + off, int(t1 * 1e9) + off)
                got["clock_us"] = [(h + off - s) / 1e3 for h, s in ends]
                got["ops_s"] = sum(s for _, s in out["ops"].values())
                got["host"] = host_seconds(spans, t0, t1)
            return out

    def host_spans(telemetry):
        got["spans_dropped"] = telemetry.tracer.dropped
        return host_spans_orig(telemetry)

    def driver(reg, name):
        mod = driver_orig(reg, name)
        run_orig = mod.run

        def run_and_keep(ctx):
            out = run_orig(ctx)
            got["record"] = out["record"]
            return out
        mod.run = run_and_keep
        return mod

    host_spans_orig, driver_orig = tracing.host_spans, harness.Registry.driver
    trace_orig = tracing.Trace
    tracing.Trace, tracing.host_spans = SpanTrace, host_spans
    harness.Registry.driver = driver
    try:
        rc = run.main(list(argv if argv is not None else sys.argv[1:])
                      + ["--trace", "1"])
    finally:
        tracing.Trace, tracing.host_spans = trace_orig, host_spans_orig
        harness.Registry.driver = driver_orig
    if rc == 0:
        spans = by_span(got["charged"])
        print("spans: " + json.dumps({
            "device_by_span": spans, "ops_s": got["ops_s"],
            "clock_us": got["clock_us"], "marks": got["marks"],
            "spans_dropped": got["spans_dropped"],
            "host_by_span": got["host"],
            "per": _per(got["record"], spans),
            "top_ops": top_ops(got["charged"])}), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
