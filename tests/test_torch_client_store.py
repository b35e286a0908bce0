"""The port's paged client store (``repro_torch.federated.client_store``)
on the CPU: what ``tests/test_client_store.py`` asserts of the reference,
asserted of the port, and the port's paged rounds against the reference's.

Within the port, paged and resident trainers from one seed must agree bit
for bit (records, ranks, global adapters, every exported client adapter)
for the five aggregators of the reference's test across the sync,
pipelined and async timelines: every per-client computation is row-local,
so moving rows into bank slots changes no arithmetic.  Against the
reference, a paged port trainer starts from the reference's state through
``interop.load_reference_state`` (its per-client initial adapters written
into the store's host tier); cohorts and edited modules must be equal, the
loss within atol 1e-5 and the adapters within the tolerance
``tests/test_torch_fedround.py`` states for AdamW (every element within
rounds × local steps × lr, the mean within 1e-6)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.data.synthetic import (SyntheticTaskConfig,  # noqa: E402
                                  make_federated_datasets)
from repro.federated import FederatedConfig, FederatedTrainer  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core.editing import EditConfig as TEdit  # noqa: E402
from repro_torch.core.paging import LRUPager  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.federated import FederatedConfig as TFed  # noqa: E402
from repro_torch.federated import FederatedTrainer as TTrainer  # noqa: E402
from repro_torch.interop import load_reference_state  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.serving import AdapterStore  # noqa: E402

LR = 3e-3
_DATA: dict = {}


def _corpus(n, sizes, port=True):
    """The same numpy corpus for either package (made once per shape)."""
    key = (n, tuple(sizes), port)
    if key not in _DATA:
        if port:
            _DATA[key] = TD.make_federated_datasets(
                TD.SyntheticTaskConfig(caption_len=8), n, np.asarray(sizes))
        else:
            _DATA[key] = make_federated_datasets(
                SyntheticTaskConfig(caption_len=8), n, np.asarray(sizes))
    return _DATA[key]


def _fed(aggregator, n_clients, sample_rate, ranks, local_steps, **kw):
    edit = kw.pop("edit", True)
    return dict(num_clients=n_clients, sample_rate=sample_rate, ranks=ranks,
                local_steps=local_steps, batch_size=4,
                aggregator=aggregator, **kw), edit


def mk(aggregator="fedilora", n_clients=3, sizes=(24, 24, 24),
       sample_rate=0.67, ranks=(4, 8, 16), local_steps=1, **kw):
    """A port trainer (the reference test's ``_mk``)."""
    fed, edit = _fed(aggregator, n_clients, sample_rate, ranks, local_steps,
                     **kw)
    clients, gtest = _corpus(n_clients, sizes)
    return TTrainer(t_config("fedbench-tiny"),
                    TFed(edit=TEdit(enabled=edit), **fed),
                    TOpt(peak_lr=LR, total_steps=30), clients, clients, gtest,
                    seed=0, device="cpu")


def assert_tree_equal(a, b, tag=""):
    for n in b:
        for m in ("A", "B"):
            np.testing.assert_array_equal(np.asarray(a[n][m]),
                                          np.asarray(b[n][m]),
                                          err_msg=f"{tag}/{n}/{m}")


def assert_same_state(tr, tp, tag=""):
    assert list(tr.client_ranks) == list(tp.client_ranks), tag
    assert_tree_equal(tr.server.global_lora, tp.server.global_lora,
                      f"{tag}/global")
    assert_tree_equal(tr.server.prev_global, tp.server.prev_global,
                      f"{tag}/prev")
    ra, rb = tr.export_adapters(), tp.export_adapters()
    assert ra.keys() == rb.keys()
    for cid in ra:
        assert ra[cid][1] == rb[cid][1], (tag, cid)
        assert_tree_equal(ra[cid][0], rb[cid][0], f"{tag}/{cid}")


# ---------------------------------------------------------------- pager
def test_lru_pager_assign_evict_order():
    p = LRUPager(2, kind="client")
    s0, ev = p.assign("a")
    assert ev is None and p.lookup("a") == s0
    s1, ev = p.assign("b")
    assert ev is None and s1 != s0
    p.touch("a")
    s2, ev = p.assign("c")
    assert ev == "b" and s2 == s1
    assert p.evictions == 1 and p.lookup("b") is None
    assert sorted(p.resident_ids) == ["a", "c"]
    assert p.stats() == {"hits": 0, "misses": 3, "evictions": 1,
                         "hit_rate": 0.0}


def test_lru_pager_pins_block_eviction():
    p = LRUPager(2, kind="client")
    p.assign("a")
    p.assign("b")
    p.pin("a")
    p.pin("b")
    with pytest.raises(RuntimeError, match="pinned by in-flight"):
        p.assign("c")
    p.unpin("b")
    _, ev = p.assign("c")
    assert ev == "b"
    with pytest.raises(RuntimeError, match="not pinned"):
        p.unpin("b")
    with pytest.raises(KeyError):
        p.pin("zzz")
    with pytest.raises(ValueError):
        LRUPager(0)


# --------------------------------------------- paged == resident, bit for bit
@pytest.mark.parametrize("aggregator,kw", [
    ("fedavg", {}),
    ("hetlora", dict(hetlora_prune_gamma=0.9)),
    ("fedilora", {}),
    ("fedilora_kernel", {}),
    ("flora", dict(edit=False)),
], ids=["fedavg", "hetlora_prune", "fedilora", "fedilora_kernel", "flora"])
def test_paged_rounds_bit_identical_sync(aggregator, kw):
    """slots == cohort < K: real eviction churn across three rounds."""
    tr = mk(aggregator, **kw)
    tp = mk(aggregator, paged=True, **kw)
    for _ in range(3):
        assert tr.run_round() == tp.run_round()
    assert_same_state(tr, tp, aggregator)
    if aggregator == "flora":
        for a, b in zip(tree_leaves(tr.base_params),
                        tree_leaves(tp.base_params)):
            assert torch.equal(a, b)
    assert tp.dispatch_count["round_step"] == 3
    assert 0 < tp.dispatch_count["page_in"] <= 3
    assert tp.store.evictions > 0


@pytest.mark.parametrize("aggregator,kw", [
    ("fedilora", {}), ("hetlora", dict(hetlora_prune_gamma=0.9)),
], ids=["fedilora", "hetlora_prune"])
def test_paged_rounds_bit_identical_pipelined(aggregator, kw):
    """A pipelined round's fetch maps the bank's ranks back through the
    cohort's slots before the next round pages its cohort in."""
    tr = mk(aggregator, **kw)
    tp = mk(aggregator, paged=True, store_slots=3, **kw)
    ra = [tr.run_round_pipelined() for _ in range(4)] + [tr.flush_rounds()]
    rb = [tp.run_round_pipelined() for _ in range(4)] + [tp.flush_rounds()]
    assert ra == rb
    assert_same_state(tr, tp, "pipelined")
    assert tp.dispatch_count["round_step"] == 4


@pytest.mark.parametrize("aggregator", ["fedbuff", "fedbuff_kernel"])
def test_paged_rounds_bit_identical_async_with_delays(aggregator):
    """FedBuff ticks with a straggler: each in-flight cohort stays pinned
    until it retires, and the timeline equals the resident one tick for
    tick."""
    kw = dict(async_delays=(0, 1, 0), buffer_size=2, edit=False)
    tr = mk(aggregator, **kw)
    tp = mk(aggregator, paged=True, store_slots=3, **kw)
    pinned = []
    for _ in range(6):
        assert tr.run_round_async() == tp.run_round_async()
        assert tp.store.pinned_ids == sorted(e["client"]
                                             for e in tp._inflight)
        pinned.append(tp.store.pinned_ids)
    assert any(pinned)                  # the straggler was held pinned
    assert_same_state(tr, tp, "async")


def test_paged_reference_loop_matches_fused():
    """``run_round_reference`` on a paged trainer (``write_client``) tracks
    the paged fused round within 1e-4 in loss, ranks exact."""
    tf = mk("fedilora", paged=True)
    tr = mk("fedilora", paged=True)
    for _ in range(2):
        rf, rr = tf.run_round(), tr.run_round_reference()
        assert rf["sampled"] == rr["sampled"]
        assert abs(rf["train_loss"] - rr["train_loss"]) < 1e-4
    assert list(tf.client_ranks) == list(tr.client_ranks)


def test_paged_sweep_matches_resident():
    """The tiled paged sweep: ceil(K / slots) population_eval calls, the
    resident sweep's numbers exactly, and the host loop's too."""
    tr, tp = mk(), mk(paged=True)
    tr.run_round()
    tp.run_round()
    ea = tr.evaluate_personalized(n=4, loss_n=8)
    eb = tp.evaluate_personalized(n=4, loss_n=8)
    assert ea == eb
    assert tp.dispatch_count["population_eval"] == 2
    assert tp.evaluate_personalized(n=4, loss_n=8, vmapped=False) == ea


# ------------------------------------- residency bounds, lazy init, config
def test_paged_device_residency_bounded_by_cohort():
    tp = mk(paged=True)                # store_slots=0 -> the cohort (2)
    for _ in range(4):
        tp.run_round()
    S = tp.store.slots
    assert S == tp._n_sample == 2
    assert tp.store.peak_resident <= S
    banks = [tp.store.lora_bank, tp.store.ranks_bank, tp.store.sizes_bank,
             tp.store.data_bank]
    leaves = [x for b in banks for x in tree_leaves(b)]
    assert all(x.shape[0] == S for x in leaves)
    assert tp.stacked_lora is None and tp._stacked_data is None
    assert tp.store.device_bytes() == sum(x.numel() * x.element_size()
                                          for x in leaves)


def test_paged_lazy_init_materialises_only_sampled():
    tp = mk(paged=True, n_clients=6, sizes=(24,) * 6,
            ranks=(4, 8, 8, 16, 16, 8), sample_rate=1 / 3)
    tp.run_round()
    mat = tp.store.materialized_ids
    assert mat == tp.history[-1]["sampled"]
    assert len(mat) == 2 < 6
    # a never-sampled client reads as its lazy init, which is the resident
    # trainer's initial adapter
    tr = mk(n_clients=6, sizes=(24,) * 6, ranks=(4, 8, 8, 16, 16, 8),
            sample_rate=1 / 3)
    k = next(c for c in range(6) if c not in mat)
    assert_tree_equal(tp.clients[k].lora,
                      {n: {m: e[m][k] for m in "AB"}
                       for n, e in tr.stacked_lora.items()}, "lazy")


def test_paged_config_validation():
    with pytest.raises(ValueError, match="store_slots"):
        mk(paged=True, store_slots=1)  # the cohort is 2
    with pytest.raises(ValueError, match="spill_dir"):
        mk(paged=True, store_host_slots=1)
    with pytest.raises(NotImplementedError, match="mesh"):
        clients, gtest = _corpus(3, (24, 24, 24))
        TTrainer(t_config("fedbench-tiny"),
                 TFed(num_clients=3, sample_rate=0.67, ranks=(4, 8, 16),
                      paged=True), TOpt(), clients, clients, gtest,
                 device="cpu", mesh=object())


def test_paged_cohort_larger_than_bank_raises():
    tp = mk(paged=True, store_slots=2)
    with pytest.raises(ValueError, match="store_slots"):
        tp.store.acquire_cohort([0, 1, 2])


def test_client_state_lora_view_and_rank_subspace():
    tp = mk(paged=True)
    tp.run_round()
    for c in tp.clients:
        for entry in c.lora.values():
            tail = float(entry["A"][:, c.rank:, :].abs().sum())
            tail += float(entry["B"][..., c.rank:].abs().sum())
            assert tail == 0.0


def test_eviction_capture_is_a_copy():
    """A dirty row evicted by a page-in into the same slot keeps the
    adapter it had: the capture is a copy, not a view of the bank row the
    page-in overwrites."""
    tp = mk(paged=True, store_slots=2)
    tp.run_round()                               # cohort of 2 fills the bank
    first = tp.history[-1]["sampled"]
    want = {k: tp.store.client_lora(k) for k in first}
    other = [k for k in range(3) if k not in first]
    tp.store.prefetch(other + first[:1])         # evicts first[1]
    gone = first[1]
    assert tp.store.pager.lookup(gone) is None
    assert_tree_equal(tp.store.client_lora(gone), want[gone], "capture")
    tp.store.flush()
    assert_tree_equal(tp.store.host_adapter(gone), want[gone], "flushed")


# ----------------------------------------------------------- disk cold tier
def test_paged_disk_spill_tier_roundtrips_state(tmp_path):
    spill = os.path.join(str(tmp_path), "spill")
    tr = mk()
    tp = mk(paged=True, store_host_slots=1, store_spill_dir=spill)
    for _ in range(3):
        assert tr.run_round() == tp.run_round()
    assert tp.store.spills > 0
    assert os.listdir(spill)
    assert tp.store.paging_stats["spills"] == tp.store.spills
    assert_same_state(tr, tp, "spill")   # the export reads spilled files
    assert tp.store.spill_loads > 0


# ----------------------------------------------------- availability sampling
def test_uniform_sampling_stream_unchanged_by_flag():
    a = mk(paged=True)
    b = mk(paged=True, sampling="availability")
    for _ in range(3):
        assert a._sample_clients() == b._sample_clients()


def test_availability_sampling_drives_paged_async_pool():
    """Availability weighting under paging: a slow measured client is
    dispatched far less often than uniform sampling would."""
    kw = dict(edit=False, n_clients=4, sizes=(24,) * 4, ranks=(4, 8, 8, 16),
              sample_rate=0.5, sampling="availability",
              availability_alpha=4.0)
    tp = mk("fedbuff", paged=True, store_slots=4, **kw)
    tp.client_step_ema[:] = [0.01, 0.01, 0.01, 2.0]
    tp._ema_seen[:] = True
    picked = []
    for _ in range(8):
        picked += tp.run_round_async()["sampled"]
    assert picked.count(3) < 4


def test_unknown_sampling_raises():
    with pytest.raises(ValueError, match="sampling"):
        mk(paged=True, sampling="nope")._sample_clients()


# ----------------------------------------------------------- serving export
def test_adapter_store_from_paged_trainer():
    tr, tp = mk(), mk(paged=True)
    tr.run_round()
    tp.run_round()
    store = AdapterStore.from_trainer(tp, device="cpu")
    want = AdapterStore.from_trainer(tr, device="cpu")
    assert len(store.ranks) == 3 and store.ranks == want.ranks
    for k in range(3):
        slot = store.acquire(f"client{k}")
        assert 0 <= slot < store.slots
        store.release(f"client{k}")
        assert_tree_equal(store._host[f"client{k}"], want._host[f"client{k}"])


# ---------------------------------------------- the port against the reference
def _ref_pair(aggregator, **kw):
    """(reference paged trainer, port paged trainer), the port's clients
    written from the reference's per-client initial adapters."""
    n, sizes, ranks = 4, (24, 32, 24, 40), (4, 8, 8, 16)
    fed, edit = _fed(aggregator, n, 0.5, ranks, 2, paged=True, **kw)
    clients, gtest = _corpus(n, sizes, port=False)
    ref = FederatedTrainer(get_config("fedbench-tiny"),
                           FederatedConfig(edit=EditConfig(enabled=edit),
                                           **fed),
                           OptimizerConfig(peak_lr=LR, total_steps=30),
                           clients, clients, gtest, seed=0)
    t_clients, t_gtest = _corpus(n, sizes)
    port = TTrainer(t_config("fedbench-tiny"),
                    TFed(edit=TEdit(enabled=edit), **fed),
                    TOpt(peak_lr=LR, total_steps=30), t_clients, t_clients,
                    t_gtest, seed=0, device="cpu")
    load_reference_state(
        port, base_params=jax.device_get(ref.base_params),
        global_lora=jax.device_get(ref.server.global_lora),
        prev_global=jax.device_get(ref.server.prev_global),
        client_lora={k: jax.device_get(ref._init_lora_fn(k))
                     for k in range(n)})
    return ref, port


def _close(port_tree, ref_tree, rounds, what):
    for n in ref_tree:
        for m in ("A", "B"):
            d = np.abs(np.asarray(port_tree[n][m])
                       - np.asarray(jax.device_get(ref_tree[n][m])))
            assert d.max() <= rounds * 2 * LR, (what, n, m, d.max())
            assert d.mean() <= 1e-6, (what, n, m, d.mean())


@pytest.mark.parametrize("aggregator", ["fedilora", "fedilora_kernel"])
def test_paged_rounds_match_reference(aggregator):
    """Two paged rounds (store_slots = cohort = 2 of 4, so the second
    round evicts) against the reference's paged rounds."""
    ref, port = _ref_pair(aggregator)
    for t in range(2):
        rr, rp = ref.run_round(), port.run_round()
        assert rp["sampled"] == [int(k) for k in rr["sampled"]]
        assert rp["edited_layers"] == rr["edited_layers"]
        np.testing.assert_allclose(rp["train_loss"], rr["train_loss"],
                                   atol=1e-5)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        _close(port.server.global_lora, ref.server.global_lora, t + 1,
               "global")
    assert port.store.materialized_ids == ref.store.materialized_ids
    assert port.store.paging_stats == ref.store.paging_stats
    assert port.dispatch_count["page_in"] == ref.dispatch_count["page_in"]
    er, ep = ref.export_adapters(), port.export_adapters()
    for cid in er:
        assert ep[cid][1] == er[cid][1]
        _close(ep[cid][0], er[cid][0], 2, cid)
