"""The port's other round timelines against the JAX package's on the CPU:
``run_round_reference`` (the host loop), ``run_round_pipelined`` with
``flush_rounds`` and ``run_round`` draining a pending round, and the
buffered-async ``run_round_async`` with its delays, buffer and fault
deferral.  Each pair of trainers starts from the reference's state
(``interop.load_reference_state``) on the corpora of
``tests/test_torch_faults.py``.

Exact: cohorts, edited modules, ranks, ticks, merges, staleness lists,
versions, buffer fill and health counts, and the step-time EMA fed the
same seconds on both sides.  Within tolerance: losses (atol 1e-5) and
adapters (every element within ticks × local steps × lr, the mean within
1e-6, as ``tests/test_torch_fedround.py`` argues for AdamW)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_faults import (N, assert_adapters_close,  # noqa: E402
                               make_pair)

ASYNC_FAULTS = dict(enabled=True, dropout_rate=0.25, straggler_rate=0.25,
                    straggler_ticks=2, corrupt_rate=0.3, corrupt_mode="inf",
                    seed=5)


def assert_records_equal(rp, rr, loss_atol=1e-5):
    assert (rp is None) == (rr is None)
    if rp is None:
        return
    assert rp.keys() == rr.keys()
    for k in rr:
        if k == "train_loss":
            np.testing.assert_allclose(rp[k], rr[k], atol=loss_atol)
        elif k == "sampled":
            assert rp[k] == [int(c) for c in rr[k]]
        else:
            assert rp[k] == rr[k], (k, rp[k], rr[k])


@pytest.mark.parametrize("aggregator,kw", [
    ("fedilora", {}),
    ("hetlora", dict(hetlora_prune_gamma=0.9)),
    ("fedilora_clip", dict(clip_norm=24.0)),
], ids=["fedilora", "hetlora_prune", "fedilora_clip"])
def test_reference_loop_matches_reference(aggregator, kw):
    ref, port = make_pair(aggregator, sample_rate=0.6, measure_delays=True,
                          **kw)
    for t in range(2):
        assert_records_equal(port.run_round_reference(),
                             ref.run_round_reference())
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        assert_adapters_close(port.server.global_lora,
                              ref.server.global_lora, "global", t + 1)
        assert_adapters_close(port.server.prev_global,
                              ref.server.prev_global, "prev", t + 1)
        assert_adapters_close(port.stacked_lora, ref.stacked_lora, "stacked",
                              t + 1)
    # each client timed one by one; the path's first (warm-up) discarded
    np.testing.assert_array_equal(port._ema_seen, ref._ema_seen)
    assert port._measure_warm == ref._measure_warm == {"local_train"}
    if aggregator == "hetlora":
        assert list(port.client_ranks) != [4, 8, 8, 16, 8]


def test_pipelined_lag_flush_and_drain():
    """Records one round stale, ``None`` first, ``flush_rounds`` drains the
    last and ``run_round`` drains a pending round first.  HetLoRA prunes
    ranks every round, so a record fetched after the next round's in-place
    update would show the wrong ranks."""
    ref, port = make_pair("hetlora", sample_rate=0.6, hetlora_prune_gamma=0.9)
    calls = ["pipelined", "pipelined", "pipelined", "round", "flush",
             "pipelined", "flush", "flush"]
    for t, call in enumerate(calls):
        fn = {"pipelined": "run_round_pipelined", "round": "run_round",
              "flush": "flush_rounds"}[call]
        rp, rr = getattr(port, fn)(), getattr(ref, fn)()
        assert_records_equal(rp, rr)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        assert (port._pending is None) == (ref._pending is None)
    assert [r["round"] for r in port.history] == [1, 2, 3, 4, 5]
    for rp, rr in zip(port.history, ref.history):
        assert_records_equal(rp, rr)
    assert_adapters_close(port.server.global_lora, ref.server.global_lora,
                          "global", 5)
    assert_adapters_close(port.stacked_lora, ref.stacked_lora, "stacked", 5)
    assert port.dispatch_count["round_step"] == 5


def test_async_zero_delays_is_the_sync_round():
    """Zero delays and M = cohort: every tick trains, retires and merges
    one whole cohort at staleness 0, which is the synchronous fedilora
    round; the reference's ticks agree with the port's."""
    ref, port = make_pair("fedbuff_kernel", sample_rate=0.4)
    _, sync = make_pair("fedilora_kernel", sample_rate=0.4)
    for t in range(3):
        ra, rr, rs = port.run_round_async(), ref.run_round_async(), \
            sync.run_round()
        assert_records_equal(ra, rr)
        assert ra["merges"] == 1 and ra["staleness"] == [0.0, 0.0]
        assert ra["sampled"] == rs["sampled"]
        np.testing.assert_allclose(ra["train_loss"], rs["train_loss"],
                                   atol=1e-6)
        for n, e in sync.server.global_lora.items():
            for m in ("A", "B"):
                torch.testing.assert_close(port.server.global_lora[n][m],
                                           e[m], rtol=0, atol=1e-6)
        assert_adapters_close(port.server.global_lora,
                              ref.server.global_lora, "global", t + 1)
    assert port.dispatch_count["client_update"] == 3
    assert port.dispatch_count["buffer_merge"] == 3


def test_async_delays_buffer_and_faults_match_reference():
    ref, port = make_pair("fedbuff_kernel", ASYNC_FAULTS, sample_rate=0.4,
                          buffer_size=2, async_delays=(0, 1, 0, 2, 0))
    ticks = 8
    for t in range(ticks):
        assert_records_equal(port.run_round_async(), ref.run_round_async())
        assert [(e["client"], e["row"], e["version"], e["finish"])
                for e in port._inflight] == \
            [(e["client"], e["row"], e["version"], e["finish"])
             for e in ref._inflight]
        assert len(port._buffer) == len(ref._buffer)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
    assert dict(port.health) == dict(ref.health)
    for k in ("n_dropped", "n_deferred", "n_nonfinite", "n_corrupted"):
        assert port.health[k] > 0, k
    assert any(s > 0 for r in port.history for s in r["staleness"])
    assert port._global_version == ref._global_version
    assert_adapters_close(port.server.global_lora, ref.server.global_lora,
                          "global", ticks)
    assert_adapters_close(port.stacked_lora, ref.stacked_lora, "stacked",
                          ticks)
    for e in port.server.global_lora.values():
        assert all(torch.isfinite(x).all() for x in e.values())


def test_buffered_update_is_not_a_view_of_stacked_state():
    """A client whose update waits in the buffer is idle and can be
    sampled again; its new training overwrites its stacked row in place,
    and the buffered update must keep the old one.  M = 6 merges three
    cohorts' rows at the third tick."""
    ref, port = make_pair("fedbuff", sample_rate=0.4, buffer_size=6)
    first = port.run_round_async()
    ref.run_round_async()
    second = port.run_round_async()
    ref.run_round_async()
    again = set(first["sampled"]) & set(second["sampled"])
    assert again, (first, second)
    for e in port._buffer:
        if e["client"] in again and e["version"] == 0 and \
                e["cohort"] is port._buffer[0]["cohort"]:
            for n, entry in port.stacked_lora.items():
                assert not torch.equal(
                    e["cohort"]["update"][n]["A"][e["row"]],
                    entry["A"][e["client"]])
    rp, rr = port.run_round_async(), ref.run_round_async()
    assert_records_equal(rp, rr)
    assert rp["merges"] == 1 and rp["staleness"] == [0.0] * 6
    assert_adapters_close(port.server.global_lora, ref.server.global_lora,
                          "global", 3)


def test_step_time_ema_and_derived_delays():
    """The EMA and the derived delays fed the same seconds on both sides
    are equal exactly; with every client measured, ``measure_delays``
    drives the async delays from them and the ticks agree."""
    ref, port = make_pair("fedbuff", sample_rate=0.4, measure_delays=True,
                          delay_ema_beta=0.25)
    feed = [(0, 0.5, "local_train", False),        # warm-up: discarded
            (0, 0.20, "local_train", False), (1, 0.45, "local_train", False),
            ([2, 3], 0.9, "client_update", False),  # warm-up: discarded
            ([0, 2, 3], 0.61, "client_update", True),
            (1, 0.40, None, False), (4, 1.3, None, False),
            ([0, 1, 2, 3, 4], 2.0, None, True)]
    for tr in (ref, port):
        assert tr.derived_async_delays() == (0,) * N
    for clients, sec, path, unseen in feed:
        for tr in (ref, port):
            tr._record_step_time(clients, sec, path=path, only_unseen=unseen)
        np.testing.assert_array_equal(port.client_step_ema,
                                      ref.client_step_ema)
        np.testing.assert_array_equal(port._ema_seen, ref._ema_seen)
        assert port.derived_async_delays() == ref.derived_async_delays()
    assert port._ema_seen.all()
    assert port.derived_async_delays() == (0, 1, 2, 2, 5)
    snap = port.telemetry.metrics.snapshot()
    assert snap["histograms"]["fed.client_step_seconds"]["count"] == 6
    assert snap["gauges"]["fed.client_step_ema_mean"] == \
        float(port.client_step_ema.mean())
    for _ in range(6):
        assert_records_equal(port.run_round_async(), ref.run_round_async())
    assert port.history[-1]["merges"] >= 0
    assert any(s > 0 for r in port.history for s in r["staleness"])
