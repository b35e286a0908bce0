"""The trace's reduction and the metric files that read it, on made-up
events: overlapping device work counts once, events are clipped to the
window, each idle gap goes to the innermost host span open at its middle,
and a kernel roofline that finds no kernel raises rather than read 0."""

from __future__ import annotations

import pytest

from perfbench.tests.checkout import ROOT
from perfbench import harness, peaks
from perfbench.tracing import breakdown, kernel_seconds, reduce_events

MS = 1_000_000            # ns


def _summary():
    off = 5 * MS          # the trace's clock runs 5 ms ahead of the host's
    dev = [(off + 0 * MS, off + 4 * MS, "gemm"),
           (off + 2 * MS, off + 6 * MS, "dim_agg_kernel<4>"),   # overlaps
           (off + 8 * MS, off + 9 * MS, "Memcpy HtoD"),
           (off + 15 * MS, off + 30 * MS, "gemm")]              # clipped
    spans = [("round", 0.0, 0.020), ("metrics_fetch", 0.006, 0.0085)]
    return reduce_events(dev, off, spans, 0.0, 0.020)


def test_union_clip_and_labels():
    s = _summary()
    assert s["window_s"] == pytest.approx(0.020)
    assert s["busy_s"] == pytest.approx((6 + 1 + 5) / 1000)
    assert s["kernels"] == 3
    assert s["ops"]["gemm"] == (2, pytest.approx(0.009))
    idle = s["idle_by_host"]
    assert idle["metrics_fetch"] == pytest.approx(0.002)     # 6 .. 8 ms
    assert idle["round"] == pytest.approx(0.006)             # 9 .. 15 ms
    assert kernel_seconds(s, ("dim_agg_kernel",)) == (1, pytest.approx(
        0.004))
    b = breakdown(s)
    assert b["device_ops"][0][0] == "gemm" and len(b["idle_gaps"]) == 2


def test_metric_files_read_the_summary():
    reg = harness.Registry(ROOT)
    s = _summary()
    rec = {"trace": s, "rounds": 1, "flops_per_round": 1e9,
           "dim_agg_work_per_round": (0.0, 3.35e6),
           "peak_window_bytes": 2e9, "round_walls": [0.02]}
    assert reg.metric("idle.train").read(rec) == pytest.approx(40.0)
    assert reg.metric("mfu.train").read(rec) == pytest.approx(
        100 * 1e9 / (0.020 * peaks.BF16_FLOPS))
    assert reg.metric("dim_agg_roofline").read(rec) == pytest.approx(
        100 * 1e-6 / 0.004)
    assert reg.metric("launches_per_round.train").read(rec) == 3
    assert reg.metric("peak_mem_gb.train").read(rec) == 2.0
    assert reg.metric("round_s_p50.train").read(rec) == 0.02
    with pytest.raises(RuntimeError):
        reg.metric("bgmv_roofline").read(dict(rec, steps=1,
                                              bgmv_work=(1.0, 1.0)))
