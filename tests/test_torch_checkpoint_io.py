"""Checkpoint writing in the port (``repro_torch.checkpoint``) against the
JAX package's ``repro.checkpoint`` on the CPU, the evaluation's reference
arguments and the training CLI.

* Checkpoints cross in both directions — resident, paged and FLoRA:
  whatever one package writes, the other loads to the same arrays, ranks,
  counters and numpy generator states, bit for bit, and both then draw
  the same next cohort.  A paged checkpoint holds only materialised
  clients; the others come from the LOADING trainer's own init, which
  across packages is not the writer's, so only materialised clients are
  compared.
* A port trainer saved in the middle of a fault sequence — async ticks
  with delays, a buffer and faults, or faulted rounds across paged and
  resident state — resumes bit for bit against the uninterrupted run.
* ``evaluate_personalized(vmapped=False)`` and ``generation_scores(
  cached=False)`` give the reference's tokens (BLEU/RSUM equal) and the
  cached, batched versions' numbers; losses within 1e-4 of the reference.
* ``python -m repro_torch.launch.train`` runs on the CPU and writes a
  checkpoint that ``AdapterStore.from_checkpoint`` reads."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import load_federated as j_load  # noqa: E402
from repro.checkpoint import save_federated as j_save  # noqa: E402
from test_torch_faults import (FAULTS, _data, fed_kwargs,  # noqa: E402
                               make_pair, port_trainer)
from repro.configs import get_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.federated import FaultConfig, FederatedConfig  # noqa: E402
from repro.federated import FederatedTrainer  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro_torch.checkpoint import (load_federated, load_pytree,  # noqa: E402
                                    save_federated, save_pytree)
from repro_torch.interop import load_reference_state  # noqa: E402
from repro_torch.serving import AdapterStore  # noqa: E402

ASYNC = dict(aggregator="fedbuff", async_delays=(0, 2, 0, 1, 0),
             buffer_size=2, sample_rate=0.4)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _tree_equal(a, b, tag=""):
    if isinstance(b, dict):
        assert set(a) == set(b), tag
        for k in b:
            _tree_equal(a[k], b[k], f"{tag}/{k}")
        return
    np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=tag)


def _client_tree(tr, k):
    """Client k's current adapter as numpy, from either package."""
    return jax.tree_util.tree_map(_np, jax.device_get(tr.clients[k].lora))


def _same_state(a, b, ids=None):
    """Server adapters, round, ranks, counters and generator states equal
    bit for bit; client adapters too (``ids``: the ones to compare)."""
    _tree_equal(a.server.global_lora, jax.device_get(b.server.global_lora),
                "global")
    _tree_equal(a.server.prev_global, jax.device_get(b.server.prev_global),
                "prev")
    assert a.server.round == b.server.round
    assert list(a.client_ranks) == list(b.client_ranks)
    assert a._global_version == b._global_version
    assert a._async_tick == b._async_tick
    assert {k: float(v) for k, v in a.health.items()} == \
        {k: float(v) for k, v in b.health.items()}
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    for ca, cb in zip(a.clients, b.clients):
        assert ca.rng.bit_generator.state == cb.rng.bit_generator.state
    for k in (range(len(a.clients)) if ids is None else ids):
        _tree_equal(_client_tree(a, k), _client_tree(b, k), f"client{k}")


def _ref(aggregator, faults=None, edit=True, **kw):
    clients, gtest = _data()["ref"]
    return FederatedTrainer(
        get_config("fedbench-tiny"),
        FederatedConfig(edit=EditConfig(enabled=edit),
                        faults=FaultConfig(**(faults or {})),
                        **fed_kwargs(aggregator, **kw)),
        OptimizerConfig(peak_lr=3e-3, total_steps=50), clients, clients,
        gtest, seed=0)


# ------------------------------------------------------------------ trees
def test_pytree_roundtrip_and_refused_dtypes(tmp_path):
    tree = {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "c": torch.tensor([1.5]), "d": [np.int32(3), np.zeros(2)]}
    p = os.path.join(tmp_path, "t.npz")
    save_pytree(p, tree)
    back = load_pytree(p)
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"].numpy())
    np.testing.assert_array_equal(back["c"], [1.5])
    np.testing.assert_array_equal(back["d"]["1"], np.zeros(2))
    # the reference reads the same keys
    from repro.checkpoint import load_pytree as j_load_pytree
    np.testing.assert_array_equal(np.asarray(j_load_pytree(p)["a"]["b"]),
                                  back["a"]["b"])
    with pytest.raises(TypeError, match="'w/x'"):
        save_pytree(p, {"w": {"x": torch.zeros(2, dtype=torch.bfloat16)}})


# --------------------------------------------------- across the packages
@pytest.mark.parametrize("kind", ["resident", "paged", "flora"])
def test_port_checkpoint_loads_into_reference(kind, tmp_path):
    kw = {"resident": dict(aggregator="fedilora", sample_rate=0.6),
          "paged": dict(aggregator="fedilora", sample_rate=0.4, paged=True,
                        store_slots=3),
          "flora": dict(aggregator="flora", edit=False, sample_rate=0.6)}[kind]
    agg = kw.pop("aggregator")
    port = port_trainer(agg, **kw)
    for _ in range(2):
        port.run_round()
    d = os.path.join(tmp_path, "ck")
    save_federated(d, port)
    ref = _ref(agg, **kw)
    j_load(d, ref)
    ids = port.store.materialized_ids if kind == "paged" else None
    _same_state(port, ref, ids)
    if kind == "paged":
        assert ref.store.materialized_ids == ids
        assert sorted(ref.store.pager.lru, key=ref.store.pager.lru.get) == \
            sorted(port.store.pager.lru, key=port.store.pager.lru.get)
    if kind == "flora":
        _tree_equal(port.base_params, jax.device_get(ref.base_params), "base")
    # the crossed generator states draw the same next cohort
    assert port.run_round()["sampled"] == \
        [int(k) for k in ref.run_round()["sampled"]]


@pytest.mark.parametrize("kind", ["resident", "paged", "flora"])
def test_reference_checkpoint_loads_into_port(kind, tmp_path):
    kw = {"resident": dict(aggregator="hetlora", hetlora_prune_gamma=0.9,
                           sample_rate=0.6),
          "paged": dict(aggregator="fedilora", sample_rate=0.4, paged=True,
                        store_slots=3),
          "flora": dict(aggregator="flora", edit=False, sample_rate=0.6)}[kind]
    agg = kw.pop("aggregator")
    ref = _ref(agg, **kw)
    for _ in range(2):
        ref.run_round()
    d = os.path.join(tmp_path, "ck")
    j_save(d, ref)
    port = port_trainer(agg, **kw)
    port.run_round()                    # diverge, then load over it
    load_federated(d, port)
    ids = ref.store.materialized_ids if kind == "paged" else None
    _same_state(port, ref, ids)
    if kind == "paged":
        assert port.store.materialized_ids == ids
        assert sorted(port.store.pager.lru, key=port.store.pager.lru.get) \
            == json.load(open(os.path.join(d, "meta.json")))["resident"]
    if kind == "flora":
        _tree_equal(port.base_params, jax.device_get(ref.base_params), "base")
    assert port.run_round()["sampled"] == \
        [int(k) for k in ref.run_round()["sampled"]]


# ------------------------------------------------ resume inside the timeline
def test_async_checkpoint_mid_fault_sequence_resumes_bit_for_bit(tmp_path):
    """Async ticks with delays, a buffer of 2 and faults: in-flight and
    buffered entries (with their shared cohorts), health counters and the
    generator states round-trip; the resumed ticks equal the uninterrupted
    ones bit for bit."""
    a = port_trainer(faults=FAULTS, edit=False, **ASYNC)
    for _ in range(2):
        a.run_round_async()
    assert a._inflight                  # mid-flight state to persist
    d = os.path.join(tmp_path, "ck")
    save_federated(d, a)
    b = port_trainer(faults=FAULTS, edit=False, **ASYNC)
    load_federated(d, b)
    _same_state(a, b)
    assert [(e["client"], e["row"], e["version"], e["finish"])
            for e in b._inflight + b._buffer] == \
        [(e["client"], e["row"], e["version"], e["finish"])
         for e in a._inflight + a._buffer]
    for _ in range(4):
        assert a.run_round_async() == b.run_round_async()
    _same_state(a, b)
    assert a.health["n_deferred"] + a.health["n_dropped"] > 0


@pytest.mark.parametrize("src_paged,dst_paged", [(False, True), (True, False),
                                                 (True, True)])
def test_faulted_rounds_resume_bit_for_bit(src_paged, dst_paged, tmp_path):
    def mk(paged):
        return port_trainer("fedilora", faults=FAULTS, sample_rate=0.6,
                            paged=paged, store_slots=3 if paged else 0)

    a = mk(src_paged)
    for _ in range(2):
        a.run_round()
    assert a.health["fault_rounds"] == 2
    d = os.path.join(tmp_path, "ck")
    save_federated(d, a)
    b = mk(dst_paged)
    load_federated(d, b)
    for _ in range(2):
        assert a.run_round() == b.run_round()
    _same_state(a, b)


def test_paged_checkpoint_with_pinned_rows_raises(tmp_path):
    port = port_trainer(paged=True, store_slots=5, edit=False, **ASYNC)
    for _ in range(4):
        port.run_round_async()
        if port.store.pinned_ids:
            break
    assert port.store.pinned_ids == sorted(e["client"]
                                           for e in port._inflight)
    with pytest.raises(ValueError, match="pinned"):
        save_federated(os.path.join(tmp_path, "ck"), port)
    assert not os.path.exists(os.path.join(tmp_path, "ck"))


def test_paged_checkpoint_flushes_pending_round_and_spilled_rows(tmp_path):
    """A paged trainer with a disk-spill tier and a pending pipelined round:
    the save drains the round, writes only materialised clients and the
    resident set coldest first, and loads into paged and resident trainers
    to the same evaluation."""
    kw = dict(sample_rate=0.4, paged=True, store_slots=3, store_host_slots=1,
              store_spill_dir=os.path.join(tmp_path, "spill"))
    a = port_trainer("fedilora", **kw)
    a.run_round()
    a.run_round_pipelined()
    d = os.path.join(tmp_path, "ck")
    save_federated(d, a)
    assert a._pending is None and a.store.spills > 0
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["paged"] is True
    assert meta["materialized"] == a.store.materialized_ids
    assert sorted(meta["resident"]) == sorted(a.store.resident_ids)
    for k in range(5):
        assert os.path.exists(os.path.join(d, f"client_{k}.npz")) == \
            (k in meta["materialized"])
    ev = a.evaluate_personalized(generate=False)
    for b in (port_trainer("fedilora", sample_rate=0.4, paged=True,
                           store_slots=3),
              port_trainer("fedilora", sample_rate=0.4)):
        load_federated(d, b)
        assert b.evaluate_personalized(generate=False) == ev
        _same_state(a, b, a.store.materialized_ids)


# ------------------------------------------- the evaluation's reference args
def test_reference_evaluation_arguments_match_reference():
    ref, port = make_pair("fedilora", sample_rate=0.6)
    ref.run_round()
    port.run_round()
    r = ref.evaluate_personalized(n=4, loss_n=8, vmapped=False)
    p = port.evaluate_personalized(n=4, loss_n=8, vmapped=False)
    assert p["bleu"] == r["bleu"] and p["rsum"] == r["rsum"]
    np.testing.assert_allclose(p["loss"], r["loss"], atol=1e-4)
    assert port.evaluate_personalized(n=4, loss_n=8) == p
    assert port.dispatch_count["eval_loss"] == port.fcfg.num_clients
    g = port.server.global_lora
    rg = ref.generation_scores(ref.server.global_lora, ref.global_test, 4,
                               cached=False)
    pg = port.generation_scores(g, port.global_test, 4, cached=False)
    assert pg == rg
    assert pg == port.generation_scores(g, port.global_test, 4)
    gen_len = int(np.asarray(port.global_test["loss_mask"])[0].sum())
    assert port.dispatch_count["next_logits"] == gen_len


# ------------------------------------------------------------------ the CLI
def test_training_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    d = os.path.join(tmp_path, "ck")
    main(["--arch", "fedbench-tiny", "--rounds", "2", "--local-steps", "1",
          "--clients", "3", "--ranks", "4,8,16", "--examples", "150",
          "--sample-rate", "0.67", "--eval-every", "2", "--device", "cpu",
          "--checkpoint-dir", d])
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(x) for x in lines[:-1]]
    assert [r["round"] for r in recs] == [1, 2]
    assert "global" not in recs[0]
    assert set(recs[1]["global"]) == {"loss", "acc", "bleu", "rsum"}
    assert set(recs[1]["personalized"]) == {"loss", "acc", "bleu", "rsum"}
    assert all(len(r["edited_layers"]) == 2 for r in recs)
    assert lines[-1] == f"checkpoint written to {d}"
    store = AdapterStore.from_checkpoint(d, device="cpu")
    assert store.ranks == {"client0": 4, "client1": 8, "client2": 16}
    assert json.load(open(os.path.join(d, "meta.json")))["round"] == 2


def test_load_reference_state_refuses_a_stack_for_a_paged_trainer():
    port = port_trainer("fedilora", paged=True, sample_rate=0.4)
    with pytest.raises(ValueError, match="client_lora"):
        load_reference_state(port, base_params={}, global_lora={},
                             prev_global={}, stacked_lora={})
