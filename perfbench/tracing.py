"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
window, reduced to what the per-layer metrics and the breakdown read.

Only the device's activity is traced (CUPTI: kernels, copies, memsets and
the CUDA runtime calls); recording every host operator as well made a
round of the training cell 37 s against 18 s untraced on one H100, where
the device-only trace costs little.  The host's ranges are the port's
``Telemetry`` spans, taken on the host's ``perf_counter`` and put on the
trace's clock by one ``cudaDeviceSynchronize`` the harness calls, at a
known host time, as the trace starts.

The device's busy time is the *union* of its intervals inside the window
(overlapping operations count once).  Each idle gap between them is
labelled with the innermost host span open at its middle.  The raw events
are read from ``kineto_results``: the profiler's ``key_averages()``
builds a tree that takes minutes on the 10^5-10^6 events of a window.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict

import torch

SYNC = "cudaDeviceSynchronize"


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
    else:
        s = int(e.start_us() * 1000)
    return s, s + e.duration_ns()


class Trace:
    """Profile the device over the window when ``enabled``; otherwise a
    no-op."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._sync_ns = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._sync_ns = time.perf_counter_ns()
        torch.cuda.synchronize()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def summary(self, spans, t0: float, t1: float) -> dict | None:
        """``busy_s``, ``window_s`` (``t0`` .. ``t1``, host seconds), device
        time and count by operation name, the kernel count, and idle
        seconds by the host span (``(name, start, end)``, host seconds)
        open during each gap."""
        if self.prof is None:
            return None
        dev, anchor = [], None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((*_span_ns(e), e.name()))
            elif anchor is None and e.name() == SYNC:
                anchor = _span_ns(e)[0]
        if anchor is None:
            raise RuntimeError(f"the trace holds no {SYNC} to anchor the "
                               "host's clock on")
        return reduce_events(dev, anchor - self._sync_ns, spans, t0, t1)


def reduce_events(dev, off: int, spans, t0: float, t1: float) -> dict:
    """:meth:`Trace.summary` over device events ``(start_ns, end_ns,
    name)`` on the trace's clock, which is the host's plus ``off`` ns."""
    w0, w1 = int(t0 * 1e9) + off, int(t1 * 1e9) + off
    host = [(int(a * 1e9) + off, int(b * 1e9) + off, n)
            for n, a, b in spans]
    ops: dict = defaultdict(lambda: [0, 0.0])
    clipped = []
    kernels = 0
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        ops[name][0] += 1
        ops[name][1] += (t - s) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    clipped.sort()
    union: list = []
    for s, t in clipped:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    busy = sum(t - s for s, t in union)
    gaps, prev = [], w0
    for s, t in union:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "kernels": kernels, "idle_by_host": _label_gaps(gaps, host)}


def host_spans(telemetry) -> list:
    """``(name, start, end)`` of the port's completed ``Telemetry`` spans."""
    return [(n, a, b) for n, _, a, b, _, _ in telemetry.tracer.events()
            if b is not None]


def _label_gaps(gaps, host) -> dict:
    """Idle seconds summed by the innermost host range open at each gap's
    middle ("host code outside any range" where none is)."""
    host.sort()
    out: dict = defaultdict(float)
    heap: list = []            # (-start, end, name): the latest start first
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "host code outside any range"] += \
            (b - a) / 1e9
    return dict(out)


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten host ranges with most idle time under
    them, in seconds as measured."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}


def kernel_seconds(summary: dict, names) -> tuple[int, float]:
    """Launches and device seconds of the operations whose names hold one
    of ``names``."""
    n, s = 0, 0.0
    for op, (c, sec) in summary["ops"].items():
        if any(k in op for k in names):
            n += c
            s += sec
    return n, s
