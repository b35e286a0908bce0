"""Fault injection in the port against the JAX package on the CPU.

The schedule's numpy draws must equal the reference's bit for bit.  A
faulted fused round of the port, started from the reference trainer's
state through ``repro_torch.interop``, must give the reference's cohorts,
edited modules, ranks and health counts exactly, and its adapters within
the tolerance ``tests/test_torch_fedround.py`` states: AdamW divides each
update by the gradient's own magnitude, so an element may move by up to
one step (lr) a local step where the gradient is as small as eps, and
every element must agree within rounds × local steps × lr, the mean
difference within 1e-6.  The reference side of ``*_kernel`` aggregators
runs its Pallas kernels in interpret mode.

The fault configuration (seed 11 over 5 clients, every client sampled)
draws, over two rounds: dropped clients, forfeited stragglers, a NaN on a
client that still counts (``n_nonfinite``), a NaN on a forfeited one
(not counted) and the Byzantine client's sign flip."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.data.synthetic import (SyntheticTaskConfig,  # noqa: E402
                                  make_federated_datasets)
from repro.federated import FaultConfig, FederatedConfig  # noqa: E402
from repro.federated import FederatedTrainer  # noqa: E402
from repro.federated import faults as JF  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core.editing import EditConfig as TEdit  # noqa: E402
from repro_torch.federated import FaultConfig as TFault  # noqa: E402
from repro_torch.federated import FederatedConfig as TFed  # noqa: E402
from repro_torch.federated import FederatedTrainer as TTrainer  # noqa: E402
from repro_torch.federated import faults as TF  # noqa: E402
from repro_torch.interop import load_reference_state  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402

LR, STEPS = 3e-3, 2
N, RANKS, SIZES = 5, (4, 8, 8, 16, 8), np.array([24, 32, 40, 24, 32])
FAULTS = dict(enabled=True, dropout_rate=0.25, straggler_rate=0.25,
              corrupt_rate=0.3, corrupt_mode="nan", byzantine_clients=(3,),
              seed=11)
_DATA = {}


def _data():
    if not _DATA:
        task = dict(caption_len=8)
        _DATA["ref"] = make_federated_datasets(SyntheticTaskConfig(**task),
                                               N, SIZES)
        _DATA["port"] = TD.make_federated_datasets(
            TD.SyntheticTaskConfig(**task), N, SIZES)
    return _DATA


def fed_kwargs(aggregator, **kw):
    kw.setdefault("sample_rate", 1.0)
    return dict(num_clients=N, ranks=RANKS, local_steps=STEPS, batch_size=4,
                aggregator=aggregator, **kw)


def port_trainer(aggregator, faults=None, edit=True, **kw):
    clients, gtest = _data()["port"]
    return TTrainer(
        t_config("fedbench-tiny"),
        TFed(edit=TEdit(enabled=edit),
             faults=TFault(**(faults or {})), **fed_kwargs(aggregator, **kw)),
        TOpt(peak_lr=LR, total_steps=50), clients, clients, gtest, seed=0,
        device="cpu")


def make_pair(aggregator, faults=None, edit=True, **kw):
    """(reference trainer, port trainer) on the same corpora, the port's
    started from the reference's initial state."""
    clients, gtest = _data()["ref"]
    ref = FederatedTrainer(
        get_config("fedbench-tiny"),
        FederatedConfig(edit=EditConfig(enabled=edit),
                        faults=FaultConfig(**(faults or {})),
                        **fed_kwargs(aggregator, **kw)),
        OptimizerConfig(peak_lr=LR, total_steps=50), clients, clients, gtest,
        seed=0)
    port = port_trainer(aggregator, faults, edit, **kw)
    load_reference_state(
        port, base_params=jax.device_get(ref.base_params),
        global_lora=jax.device_get(ref.server.global_lora),
        prev_global=jax.device_get(ref.server.prev_global),
        stacked_lora=jax.device_get(ref.stacked_lora))
    return ref, port


def assert_adapters_close(port_tree, ref_tree, what, rounds):
    ref_tree = jax.device_get(ref_tree)
    for n in ref_tree:
        for m in ("A", "B"):
            diff = np.abs(port_tree[n][m].numpy() - np.asarray(ref_tree[n][m]))
            assert diff.max() <= rounds * STEPS * LR, (what, n, m, diff.max())
            assert diff.mean() <= 1e-6, (what, n, m, diff.mean())


def clone(tree):
    return {n: {m: e[m].clone() for m in ("A", "B")} for n, e in tree.items()}


def assert_equal(a, b):
    for n in b:
        for m in ("A", "B"):
            torch.testing.assert_close(a[n][m], b[n][m], rtol=0, atol=0)


# ------------------------------------------------------------- schedule
SCHEDULES = [
    dict(enabled=True, dropout_rate=0.3, straggler_rate=0.3,
         corrupt_rate=0.3, seed=11),
    dict(enabled=True, dropout_rate=0.5, corrupt_rate=0.5,
         corrupt_mode="scale", corrupt_scale=7.0, byzantine_clients=(2, 5),
         seed=3),
    dict(enabled=True, straggler_rate=0.2, round_deadline=0.5,
         straggler_ticks=3, corrupt_rate=0.4, corrupt_mode="inf", seed=0),
    dict(enabled=True, corrupt_rate=1.0, corrupt_mode="nan", seed=12345),
    dict(enabled=True, seed=2),                       # inactive: no rates
]


@pytest.mark.parametrize("cfg", SCHEDULES,
                         ids=[f"s{i}" for i in range(len(SCHEDULES))])
def test_schedule_draws_match_reference(cfg):
    K = 12
    js, ts = JF.FaultSchedule(FaultConfig(**cfg), K), \
        TF.FaultSchedule(TFault(**cfg), K)
    assert ts.cfg.active == js.cfg.active
    ema = np.where(np.arange(K) % 3 == 0, np.nan,
                   np.linspace(0.1, 1.2, K))
    for r in range(6):
        assert ts.offline(r) == js.offline(r)
        for cid in range(K):
            np.testing.assert_array_equal(ts._draws(r, cid),
                                          js._draws(r, cid))
            assert ts.dropped(r, cid) == js.dropped(r, cid)
            assert ts.straggling(r, cid, ema[cid]) == \
                js.straggling(r, cid, ema[cid])
            assert ts.corrupted(r, cid) == js.corrupted(r, cid)
        cids = list(np.random.default_rng(r).choice(K, 7, replace=False))
        for step_ema in (None, ema):
            a = ts.cohort(r, cids, step_ema=step_ema)
            b = js.cohort(r, cids, step_ema=step_ema)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in TF.FaultSchedule.clean(4).items():
        np.testing.assert_array_equal(v, JF.FaultSchedule.clean(4)[k])
    for mode in TF._CORRUPT_MODES:
        assert np.array_equal(TF._corrupt_wire(mode, 3.0),
                              JF._corrupt_wire(mode, 3.0), equal_nan=True)
    with pytest.raises(ValueError, match="corrupt_mode"):
        TFault(corrupt_mode="bogus")


# ----------------------------------------------------- faulted rounds
@pytest.mark.parametrize("aggregator,kw", [
    ("fedilora", {}),
    ("fedilora_kernel", {}),
    ("fedilora_clip_kernel", dict(clip_norm=24.0)),
    ("fedilora_trimmed_kernel", dict(trim_frac=0.25)),
], ids=["fedilora", "fedilora_kernel", "clip_kernel", "trimmed_kernel"])
def test_faulted_rounds_match_reference(aggregator, kw):
    ref, port = make_pair(aggregator, FAULTS, **kw)
    rounds = 2
    for t in range(rounds):
        rr, rp = ref.run_round(), port.run_round()
        for key in ("round", "sampled", "edited_layers", "health"):
            assert rp[key] == rr[key], (t, key, rp[key], rr[key])
        np.testing.assert_allclose(rp["train_loss"], rr["train_loss"],
                                   atol=1e-5)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        assert_adapters_close(port.server.global_lora,
                              ref.server.global_lora, "global", t + 1)
        assert_adapters_close(port.stacked_lora, ref.stacked_lora, "stacked",
                              t + 1)
        for tree in (port.server.global_lora, port.stacked_lora):
            assert all(torch.isfinite(x).all() for e in tree.values()
                       for x in e.values())
    assert dict(port.health) == dict(ref.health)
    assert port.health["n_dropped"] > 0 and port.health["n_forfeited"] > 0
    assert port.health["n_nonfinite"] == 1 and port.health["n_corrupted"] > 1
    if aggregator == "fedilora_clip_kernel":
        assert port.health["clip_rate_sum"] > 0
    assert port.dispatch_count["round_step"] == rounds


# ---------------------------------------------------- fault semantics
def test_all_dropped_cohort_leaves_state_untouched():
    tr = port_trainer("fedilora_kernel", dict(enabled=True,
                                              dropout_rate=1.0))
    g0, s0 = clone(tr.server.global_lora), clone(tr.stacked_lora)
    r0 = tr._ranks_dev.clone()
    rec = tr.run_round()
    assert rec["health"] == {"n_dropped": float(N), "n_forfeited": 0.0,
                             "n_nonfinite": 0.0, "clip_rate": 0.0}
    assert_equal(tr.server.global_lora, g0)       # fallback: the old global
    assert_equal(tr.stacked_lora, s0)             # nothing scattered back
    torch.testing.assert_close(tr._ranks_dev, r0, rtol=0, atol=0)
    assert tr.dispatch_count["round_step"] == 1


def test_inactive_fault_config_matches_plain_round():
    a = port_trainer("fedilora")
    b = port_trainer("fedilora", dict(enabled=True))
    assert b.fault_schedule is None
    ra, rb = a.run_round(), b.run_round()
    assert ra == rb and "health" not in rb
    assert_equal(b.server.global_lora, a.server.global_lora)


def test_corruption_stays_on_the_wire():
    """A corrupted client's stored adapter is the one a clean trainer
    stores, bit for bit; only the aggregate sees the corruption, and
    non-finite wire copies are dropped from it."""
    clean = port_trainer("fedilora")
    byz = port_trainer("fedilora", dict(enabled=True,
                                        byzantine_clients=(0, 2)))
    poison = port_trainer("fedilora", dict(enabled=True, corrupt_rate=1.0,
                                           corrupt_mode="inf", seed=1))
    rc, rb, rp = clean.run_round(), byz.run_round(), poison.run_round()
    assert rc["sampled"] == rb["sampled"] == rp["sampled"]
    for tr in (byz, poison):
        assert_equal(tr.stacked_lora, clean.stacked_lora)
    assert byz.health["n_corrupted"] == 2 and rb["health"]["n_nonfinite"] == 0
    assert not torch.equal(byz.server.global_lora["s0.attn.wq"]["A"],
                           clean.server.global_lora["s0.attn.wq"]["A"])
    assert rp["health"]["n_nonfinite"] == N
    assert_equal(poison.server.global_lora, poison.server.prev_global)


def test_straggler_is_scattered_but_not_aggregated():
    clean = port_trainer("fedilora")
    slow = port_trainer("fedilora", dict(enabled=True, straggler_rate=1.0))
    g0 = clone(slow.server.global_lora)
    clean.run_round()
    rec = slow.run_round()
    assert rec["health"]["n_forfeited"] == N
    assert_equal(slow.server.global_lora, g0)     # no survivor: fallback
    assert_equal(slow.stacked_lora, clean.stacked_lora)   # they finished


def test_availability_sampling_routes_around_offline_clients():
    """Availability sampling with measured EMAs and an active schedule:
    the offline clients are left out and the weighted draws equal the
    reference's, round after round."""
    faults = dict(enabled=True, dropout_rate=0.4, seed=7)
    ref, port = make_pair("fedilora", faults, sample_rate=0.4,
                          sampling="availability")
    ema = np.asarray([0.2, 0.5, 0.0, 0.3, 0.9])
    for tr in (ref, port):
        tr.client_step_ema[:] = ema
        tr._ema_seen[:] = ema > 0
    hits = 0
    for _ in range(12):
        off = port.fault_schedule.offline(port.server.round)
        assert off == ref.fault_schedule.offline(ref.server.round)
        sp, bp = port._build_round_inputs()
        sr, br = ref._build_round_inputs()
        assert sp == [int(k) for k in sr]
        np.testing.assert_array_equal(bp, br)
        if len(set(range(N)) - off) >= port._n_sample:
            assert not set(sp) & off
            hits += len(off)
        port.server.round += 1
        ref.server.round += 1
    assert hits > 0


def test_uniform_sampling_stream_untouched_by_faults():
    plain = port_trainer("fedilora", sample_rate=0.4)
    faulty = port_trainer("fedilora", dict(enabled=True, dropout_rate=0.3,
                                           seed=2), sample_rate=0.4)
    clients, gtest = _data()["ref"]
    ref = FederatedTrainer(
        get_config("fedbench-tiny"),
        FederatedConfig(faults=FaultConfig(enabled=True, dropout_rate=0.3,
                                           seed=2),
                        **fed_kwargs("fedilora", sample_rate=0.4)),
        OptimizerConfig(), clients, clients, gtest, seed=0)
    for _ in range(6):
        s0, _ = plain._build_round_inputs()
        s1, _ = faulty._build_round_inputs()
        s2, _ = ref._build_round_inputs()
        assert s0 == s1 == [int(k) for k in s2]


def test_fault_config_moved_to_faults_module():
    from repro_torch.federated import config as C
    assert C.FaultConfig is TF.FaultConfig
    assert [(f.name, f.default) for f in dataclasses.fields(TFault)] == \
        [(f.name, f.default) for f in dataclasses.fields(FaultConfig)]
