"""The port's round meshes on the CPU: ``FederatedTrainer(mesh=...)`` over
gloo process groups of 2 and 4 ranks, spawned per test, against the JAX
package's unmeshed rounds on ``fedbench-tiny`` (the cases of
``tests/test_mesh2d.py``), every port trainer started from the
reference's state (``interop.load_reference_state``; FLoRA's draws
injected through ``FederatedTrainer.flora_reinit``).

Limits, the reference's own: ``train_loss`` within 1e-4; ``sampled``,
``edited_layers``, ``merges`` and the ranks exact; the adapters within
5e-4 — for all but 0.1 % of each leaf's elements: where a gradient is
rounding noise (|g| near AdamW's eps), the update ``g / (|g| + eps)``
moves that element by up to a whole step either way, so every element is
held within one step per local step and round and the mean within 1e-6
(as ``tests/test_torch_fedround.py`` holds the unmeshed round).  Every
rank's global and stacked state must be bit for bit the same, and a 1-D
mesh whose cohort it splits evenly must give the port's unmeshed round
bit for bit.

The reference's test runs one local step.  Its adapters' ``B`` start at
0, so that step leaves every ``A`` moved by weight decay alone and every
module's similarity to the previous global exactly 1: the edited module
is then picked by rounding (the port's unmeshed round picks ``[2, 0]``
where the reference's picks ``[0, 4]``).  So these cases run two local
steps, where the similarities differ.

The ranks import this module (spawn), so JAX is imported only inside the
functions that run the reference."""

import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
mp = pytest.importorskip("torch.multiprocessing")

LR, TOTAL, STEPS, ROUNDS = 3e-3, 10, 2, 2


# ----------------------------------------------------------------- harness
def spawn(fn, world: int, *args, timeout: float = 240.0):
    """Run ``fn(rank, world, rendezvous, *args)`` in ``world`` spawned
    processes joined by a gloo group; raises if a rank fails or the run
    outlasts ``timeout``."""
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(fn, args=(world, os.path.join(d, "rdv"))
                                 + args, nprocs=world, join=False,
                                 start_method="spawn")
        import time
        end = time.monotonic() + timeout
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() > end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ranks still running after {timeout} s")


def join_mesh(rank, world, rdv, shape, names):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, init_distributed
    init_distributed(init_method=f"file://{rdv}", world_size=world,
                     rank=rank, device="cpu")
    return Mesh(shape, names)


def corpus(n, sizes):
    from repro_torch import data as TD
    return TD.make_federated_datasets(TD.SyntheticTaskConfig(), n,
                                      np.array(sizes))


def port_trainer(case, mesh=None):
    from repro_torch.configs import get_config
    from repro_torch.core.editing import EditConfig
    from repro_torch.federated import FederatedConfig, FederatedTrainer
    from repro_torch.interop import (flora_reinit_from_numpy,
                                     load_reference_state)
    from repro_torch.optim import OptimizerConfig
    clients, gtest = corpus(case["n"], case["sizes"])
    fcfg = FederatedConfig(num_clients=case["n"], sample_rate=1.0,
                           ranks=case["ranks"], local_steps=STEPS,
                           batch_size=4, aggregator=case["agg"],
                           edit=EditConfig(enabled=case["agg"] != "flora"),
                           **case["kw"])
    tr = FederatedTrainer(get_config("fedbench-tiny"), fcfg,
                          OptimizerConfig(peak_lr=LR, total_steps=TOTAL),
                          clients, clients, gtest, seed=0, mesh=mesh,
                          device="cpu")
    load_reference_state(tr, **case["state"])
    if case.get("flora"):
        tr.flora_reinit = flora_reinit_from_numpy(*case["flora"],
                                                  device="cpu")
    return tr


def host(tree):
    return {n: {m: e[m].detach().clone() for m in ("A", "B")}
            for n, e in tree.items()}


def run_case(case, mesh, async_=False):
    tr = port_trainer(case, mesh)
    step = tr.run_round_async if async_ else tr.run_round
    recs = [step() for _ in range(ROUNDS)]
    return {"recs": recs, "ranks": tr.client_ranks.copy(),
            "global": host(tr.server.global_lora),
            "stacked": host(tr.stacked_lora),
            "dispatch": dict(tr.dispatch_count)}, tr


# --------------------------------------------------------------- reference
def reference_case(agg, n=2, sizes=(24, 24), ranks=(4, 8), async_=False,
                   **kw):
    """The reference's unmeshed rounds and initial state for one case."""
    import jax

    from repro.configs import get_config
    from repro.core.editing import EditConfig
    from repro.core.lora import LoRAConfig, init_lora_params
    from repro.data.synthetic import (SyntheticTaskConfig,
                                      make_federated_datasets)
    from repro.federated import FederatedConfig, FederatedTrainer
    from repro.optim import OptimizerConfig

    clients, gtest = make_federated_datasets(SyntheticTaskConfig(), n,
                                             np.array(sizes))
    fcfg = FederatedConfig(num_clients=n, sample_rate=1.0, ranks=ranks,
                           local_steps=STEPS, batch_size=4, aggregator=agg,
                           edit=EditConfig(enabled=agg != "flora"), **kw)
    ref = FederatedTrainer(get_config("fedbench-tiny"), fcfg,
                           OptimizerConfig(peak_lr=LR, total_steps=TOTAL),
                           clients, clients, gtest, seed=0)
    case = {"agg": agg, "n": n, "sizes": sizes, "ranks": ranks, "kw": kw,
            "state": {"base_params": jax.device_get(ref.base_params),
                      "global_lora": jax.device_get(ref.server.global_lora),
                      "prev_global": jax.device_get(ref.server.prev_global),
                      "stacked_lora": jax.device_get(ref.stacked_lora)}}
    if agg == "flora":
        lcfg = LoRAConfig(rank=ref.lcfg.rank)
        case["flora"] = (
            {(r, k): jax.device_get(init_lora_params(
                jax.random.PRNGKey(1000 * r + k), ref.specs, lcfg))
             for r in range(ROUNDS) for k in range(n)},
            {r: jax.device_get(init_lora_params(
                jax.random.PRNGKey(r + 77), ref.specs, lcfg))
             for r in range(ROUNDS)})
    step = ref.run_round_async if async_ else ref.run_round
    recs = [step() for _ in range(ROUNDS)]
    want = {"recs": recs, "ranks": np.asarray(ref.client_ranks),
            "global": jax.device_get(ref.server.global_lora),
            "stacked": jax.device_get(ref.stacked_lora)}
    return case, want


def assert_adapters_close(got, want, what):
    for n in want:
        for m in ("A", "B"):
            diff = np.abs(got[n][m].numpy() - np.asarray(want[n][m]))
            assert np.mean(diff > 5e-4) <= 1e-3, (what, n, m, diff.max())
            assert diff.max() <= ROUNDS * STEPS * LR, (what, n, m, diff.max())
            assert diff.mean() <= 1e-6, (what, n, m, diff.mean())


def assert_round_matches(got, want, async_=False):
    for rg, rw in zip(got["recs"], want["recs"]):
        assert rg["sampled"] == list(map(int, rw["sampled"])), (rg, rw)
        if async_:
            assert rg["merges"] == rw["merges"], (rg, rw)
        else:
            assert rg["edited_layers"] == rw["edited_layers"], (rg, rw)
        assert abs(rg["train_loss"] - rw["train_loss"]) < 1e-4, (rg, rw)
    np.testing.assert_array_equal(got["ranks"], want["ranks"])
    assert_adapters_close(got["global"], want["global"], "global")
    if not async_:
        assert_adapters_close(got["stacked"], want["stacked"], "stacked")


def assert_trees_equal(a, b, what):
    for n in b:
        for m in ("A", "B"):
            assert torch.equal(a[n][m], b[n][m]), (what, n, m)


def load_ranks(d, world):
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def assert_ranks_agree(outs):
    for o in outs[1:]:
        assert_trees_equal(o["global"], outs[0]["global"], "global")
        assert_trees_equal(o["stacked"], outs[0]["stacked"], "stacked")


# ------------------------------------------------------------- 2x2 rounds
def _rank_2x2(rank, world, rdv, case, out):
    mesh = join_mesh(rank, world, rdv, (2, 2), ("client", "model"))
    res, tm = run_case(case, mesh)
    if case["agg"] == "fedilora":
        # the population eval over the 2-D mesh against the per-client loop
        ev = tm.evaluate_personalized(generate=True, n=4)
        el = tm.evaluate_personalized(generate=True, n=4, vmapped=False)
        res["eval"] = (ev, el, tm.dispatch_count["population_eval"])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.mark.parametrize("agg,kw", [
    ("fedavg", {}), ("hetlora", {"hetlora_prune_gamma": 0.9}),
    ("fedilora", {}), ("fedilora_kernel", {}), ("flora", {})],
    ids=["fedavg", "hetlora_prune", "fedilora", "fedilora_kernel", "flora"])
def test_round_2x2_matches_reference(agg, kw, tmp_path):
    """Two rounds on a 2×2 (client, model) mesh: clients split over
    ``"client"``, each group's training tensor-parallel over ``"model"``;
    one ``round_step`` a round and nothing else dispatched."""
    case, want = reference_case(agg, **kw)
    spawn(_rank_2x2, 4, case, str(tmp_path))
    outs = load_ranks(tmp_path, 4)
    assert_ranks_agree(outs)
    for o in outs:
        assert_round_matches(o, want)
        assert o["dispatch"] == {"round_step": 2}, o["dispatch"]
    if agg == "hetlora":
        assert list(want["ranks"]) != [4, 8]             # pruning happened
    if agg == "fedilora":
        ev, el, n_pop = outs[0]["eval"]
        assert ev["bleu"] == el["bleu"] and ev["rsum"] == el["rsum"]
        assert abs(ev["loss"] - el["loss"]) < 1e-5
        assert n_pop == 1


# ------------------------------------------------------ 1-D client meshes
def _rank_1d(rank, world, rdv, cases, out):
    import warnings

    mesh = join_mesh(rank, world, rdv, (world,), ("clients",))
    res = {}
    for name, (case, async_) in cases.items():
        res[name], tm = run_case(case, mesh, async_)
        # the same rounds unmeshed in this process
        res[name + ".unmeshed"], ts = run_case(case, None, async_)
        if name == "pad.fedilora":
            # 3 clients do not split over 2 ranks: the population eval
            # warns and evaluates every client on every rank
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ev = tm.evaluate_personalized(generate=True, n=4)
            res["eval"] = (ev, ts.evaluate_personalized(generate=True, n=4),
                           [str(w.message) for w in caught])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


THREE = dict(n=3, sizes=(24, 30, 24), ranks=(4, 8, 8))
CLIENT_MESH_CASES = {
    "pad": [("pad.fedilora", "fedilora", False, THREE),
            ("pad.fedbuff", "fedbuff", True, THREE)],
    "even": [("even.fedavg", "fedavg", False, {}),
             ("even.hetlora", "hetlora", False, {"hetlora_prune_gamma": 0.9}),
             ("even.fedilora_kernel", "fedilora_kernel", False, {}),
             ("even.flora", "flora", False, {})]}


@pytest.mark.parametrize("group", ["pad", "even"])
def test_client_mesh_pads_the_cohort(group, tmp_path):
    """``pad``: n_sample 3 over a 2-rank client mesh pads the cohort to 4
    with a zero-weight dummy (no fallback), for the synchronous fedilora
    round and the async fedbuff tick, against the reference's unmeshed
    rounds, and the population eval of 3 clients warns and runs
    unsharded.  ``even``: a cohort of 2, which the mesh splits evenly, bit
    for bit against the port's unmeshed round for four aggregators."""
    cases, wants = {}, {}
    for name, agg, async_, kw in CLIENT_MESH_CASES[group]:
        case, want = reference_case(agg, async_=async_, **kw)
        cases[name], wants[name] = (case, async_), want
    spawn(_rank_1d, 2, cases, str(tmp_path))
    outs = load_ranks(tmp_path, 2)
    if group == "pad":
        ev, plain, caught = outs[0]["eval"]
        assert any("unsharded" in w for w in caught), caught
        assert ev == plain, (ev, plain)
    for name, (case, async_) in cases.items():
        assert_ranks_agree([o[name] for o in outs])
        got = outs[0][name]
        assert_round_matches(got, wants[name], async_)
        if name.startswith("pad"):
            if not async_:
                assert all(len(r["edited_layers"]) == 3
                           for r in got["recs"])       # sliced to n_sample
            continue
        plain = outs[0][name + ".unmeshed"]
        assert [r["train_loss"] for r in got["recs"]] == \
            [r["train_loss"] for r in plain["recs"]]
        assert_trees_equal(got["global"], plain["global"], name)
        assert_trees_equal(got["stacked"], plain["stacked"], name)


# ---------------------------------------------- collectives on a 1x2 mesh
def _rank_1x2(rank, world, rdv, case, out):
    mesh = join_mesh(rank, world, rdv, (1, 2), ("client", "model"))
    tr = port_trainer(case, mesh)
    tr.run_round()                         # cuts the base weights
    mesh.reset_collectives()
    tr.run_round()
    calls, largest = dict(mesh.collectives), dict(mesh.collective_largest)
    whole = list(_leaves(tr.base_params_whole()))   # the pieces re-joined
    want = list(_leaves(case["state"]["base_params"]))
    joined = len(whole) == len(want) and all(
        np.array_equal(w.numpy(), np.asarray(x)) for w, x in zip(whole, want))
    big = max(t.numel() * t.element_size() for t in whole if t.dim() >= 2)
    torch.save({"calls": calls, "largest": largest, "limit": big,
                "joined": joined}, os.path.join(out, f"rank{rank}.pt"))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_round_1x2_gathers_no_base_weight(tmp_path):
    """The analogue of the reference's HLO check on a 1×2 (client, model)
    mesh: the round's tensor-parallel products all-reduce over ``"model"``,
    and nothing the round all-gathers is as large as a base weight (the
    base weights stay cut; only activation-sized pieces move)."""
    case, _ = reference_case("fedilora")
    spawn(_rank_1x2, 2, case, str(tmp_path))
    for o in load_ranks(tmp_path, 2):
        assert o["joined"], "the base weights' pieces do not re-join"
        assert o["calls"][("all_reduce", "model")] > 0, o
        gathers = {k: v for k, v in o["largest"].items()
                   if k[0] == "all_gather"}
        assert all(b < o["limit"] for b in gathers.values()), (gathers, o)
