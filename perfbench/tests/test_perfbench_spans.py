"""Device time charged to the port's spans (``spans.charge``), on made-up
events: each operation goes to the innermost span open at its launch, an
operation launched before the window or outside every span goes to its
named bucket, and the charged seconds sum to ``reduce_events``' ``ops``
total over the same events; the host's spans go onto the trace's clock
through two anchors."""

from __future__ import annotations

import pytest

from perfbench import spans as S
from perfbench.tracing import reduce_events

MS = 1_000_000            # ns
OFF = 5 * MS              # the trace's clock runs 5 ms ahead of the host's
HOST = [("serve_step", 0.001, 0.015), ("mamba_mixer", 0.002, 0.008),
        ("bgmv", 0.004, 0.006)]


def _events():
    """A window of 0 .. 20 ms (host): ``serve_step`` 1 .. 15 ms holding
    ``mamba_mixer`` 2 .. 8 ms, which holds ``bgmv`` 4 .. 6 ms."""
    spans = [(n, OFF + int(a * 1e9), OFF + int(b * 1e9)) for n, a, b in HOST]
    launch_ms = {1: -2, 2: 3, 3: 5, 4: 7, 5: 12, 6: 17, 7: 4.5}
    launches = {c: OFF + int(ms * MS) for c, ms in launch_ms.items()}
    dev = [(OFF - 1 * MS, OFF + 1 * MS, "copy", 1),   # clipped to 1 ms
           (OFF + 3 * MS, OFF + 4 * MS, "mixer_op", 2),
           (OFF + 5 * MS, OFF + 7 * MS, "shrink", 3),
           (OFF + 8 * MS, OFF + 9 * MS, "mixer_op", 4),
           (OFF + 12 * MS, OFF + 13 * MS, "step_op", 5),
           (OFF + 18 * MS, OFF + 25 * MS, "late", 6),    # clipped to 2 ms
           (OFF + 6 * MS, OFF + 6 * MS + MS // 2, "expand", 7),
           (OFF + 9 * MS, OFF + 10 * MS, "unknown", 99)]
    return dev, launches, spans


def _charge(dev, launches, spans):
    return S.charge(dev, launches, spans, OFF, OFF + 20 * MS)


def test_each_op_goes_to_the_innermost_span_open_at_its_launch():
    charged = _charge(*_events())
    assert charged["bgmv", "expand"] == (1, pytest.approx(0.0005))
    got = S.by_span(charged)
    assert got["bgmv"] == (2, pytest.approx(0.0025))
    assert got["mamba_mixer"] == (2, pytest.approx(0.002))
    assert got["serve_step"] == (1, pytest.approx(0.001))
    assert got[S.BEFORE] == (1, pytest.approx(0.001))
    assert got[S.OUTSIDE] == (1, pytest.approx(0.002))
    assert got[S.UNLINKED] == (1, pytest.approx(0.001))
    assert S.top_ops(charged, 1)["mamba_mixer"] == [
        ["mixer_op", 2, pytest.approx(0.002)]]


def test_charged_seconds_sum_to_the_ops_total():
    dev, launches, spans = _events()
    got = _charge(dev, launches, spans)
    ops = reduce_events([d[:3] for d in dev], OFF, HOST, 0.0, 0.020)["ops"]
    assert sum(n for n, _ in got.values()) == sum(n for n, _ in ops.values())
    assert sum(s for _, s in got.values()) == pytest.approx(
        sum(s for _, s in ops.values()), rel=1e-12)


def test_a_launch_at_a_span_boundary_and_an_empty_window():
    dev, launches, spans = _events()
    launches[2] = OFF + 2 * MS           # at mamba_mixer's first instant
    assert S.by_span(_charge(dev, launches, spans))["mamba_mixer"][0] == 2
    assert S.charge(dev, launches, spans, OFF + MS, OFF + MS) == {}


def test_the_host_clock_maps_through_two_anchors():
    """A trace clock 5 ms ahead that gains 50 µs over a 10 s window: both
    anchors land exactly, the middle by half the gain; ``host_seconds``
    keeps the spans that start in the window."""
    clock = S.to_trace(1_000, OFF + 1_000, 10 * 10**9, OFF + 10 * 10**9
                       + 50_000)
    assert clock(1e-6) == OFF + 1_000
    assert clock(10.0) == OFF + 10 * 10**9 + 50_000
    assert abs(clock(5.0) - (OFF + 5 * 10**9 + 25_000)) <= 1
    assert S.host_seconds(HOST + [("late", 0.03, 0.04)], 0.0, 0.02) == {
        "serve_step": (1, pytest.approx(0.014)),
        "mamba_mixer": (1, pytest.approx(0.006)),
        "bgmv": (1, pytest.approx(0.002))}
