"""Round meshes for every non-dense family on the CPU: the reduced
mamba2-130m, hybrid Jamba, DeepSeek-V2 (MLA + MoE), llama4-scout (MoE)
and llama-3.2-vision (gated cross layers, the gates opened to 0.5 — the
reference's closed gates make the cross path inert) through
``FederatedTrainer(mesh=...)`` on (1, 2) and 2×2 ``(client, "model")``
meshes of spawned gloo ranks, against the JAX package's unmeshed rounds
(``fedilora_kernel``, two rounds of three local steps), every port trainer
started from the reference's state (``interop.load_reference_state``).
Every head count, SSM head count and ``d_ff_expert`` of these configs
divides 2, so each sublayer runs split.

Limits, those of ``tests/test_torch_mesh_round.py``: ``train_loss``
within 1e-4; cohorts, edited layers and ranks exact; the adapters by the
AdamW rule (each element within one step per local step and round, all
but 0.1 % within 5e-4, the mean within 1e-6).  The rounds take three
local steps: the first leaves every ``A`` moved by nothing but the
(zero) weight decay, and after two, llama4-scout's module similarities
still differ by a few units in the last place (0.99997956 against
0.99997962), so the edited module would be picked by rounding — the
port's unmeshed round already picks another than the reference's there.
Every rank's global and stacked adapters agree bit for bit, and on the
MoE stacks every rank of a client group routes, places and drops the
same picks.  On the 2×2 mesh the population eval gives the per-client
loop's scores, and on the 1×2 mesh the async client update follows the
port's unmeshed one.  A (1, 1) mesh in a one-rank group is the port's
unmeshed round bit for bit.

The ranks import this module (spawn), so JAX is imported only inside the
functions that run the reference.  This file runs the two families with
SSM layers, mamba2-130m and Jamba; ``tests/test_torch_mesh_families_attn.py``
runs DeepSeek-V2, llama4-scout and llama-3.2-vision through the same
harness, each file with its own ranks."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
mp = pytest.importorskip("torch.multiprocessing")

from test_torch_mesh_round import (LR, ROUNDS, TOTAL,  # noqa: E402
                                   assert_ranks_agree, assert_trees_equal,
                                   host, join_mesh, leave_mesh, load_ranks)

FAMILIES = ["mamba2-130m", "jamba-v0.1-52b", "deepseek-v2-236b",
            "llama4-scout-17b-a16e", "llama-3.2-vision-11b"]
MOE = ["jamba-v0.1-52b", "deepseek-v2-236b", "llama4-scout-17b-a16e"]
HERE = FAMILIES[:2]           # this file's; the other file takes the rest
AGG, GATE, STEPS = "fedilora_kernel", 0.5, 3
FED = dict(num_clients=2, sample_rate=1.0, ranks=(4, 8), local_steps=STEPS,
           batch_size=4, aggregator=AGG)
SIZES = (24, 24)


def _task(name) -> dict:
    """The synthetic task's fields: the VLM's images are its vision
    width."""
    return {"image_dim": 64} if name == "llama-3.2-vision-11b" else {}


# --------------------------------------------------------------- reference
def reference_family(name):
    """The reference's trainer on ``name`` (its gates opened) and the
    port's case: the reference's initial state."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.core.editing import EditConfig
    from repro.data.synthetic import (SyntheticTaskConfig,
                                      make_federated_datasets)
    from repro.federated import FederatedConfig, FederatedTrainer
    from repro.optim import OptimizerConfig

    clients, gtest = make_federated_datasets(SyntheticTaskConfig(
        **_task(name)), 2, np.array(SIZES))
    ref = FederatedTrainer(get_reduced_config(name),
                           FederatedConfig(edit=EditConfig(), **FED),
                           OptimizerConfig(peak_lr=LR, total_steps=TOTAL),
                           clients, clients, gtest, seed=0)
    base = jax.device_get(ref.base_params)
    for sp in base["blocks"].values():
        if "cross" in sp:
            sp["cross"]["gate"] = np.full_like(sp["cross"]["gate"], GATE)
    ref.base_params = jax.tree_util.tree_map(jnp.asarray, base)
    case = {"name": name,
            "state": {"base_params": base,
                      "global_lora": jax.device_get(ref.server.global_lora),
                      "prev_global": jax.device_get(ref.server.prev_global),
                      "stacked_lora": jax.device_get(ref.stacked_lora)}}
    return case, ref


def reference_rounds(ref) -> dict:
    """The reference's unmeshed rounds."""
    import jax
    recs = [ref.run_round() for _ in range(ROUNDS)]
    return {"recs": recs, "ranks": np.asarray(ref.client_ranks),
            "global": jax.device_get(ref.server.global_lora),
            "stacked": jax.device_get(ref.stacked_lora)}


# -------------------------------------------------------------------- port
def port_family(case, mesh=None, aggregator=AGG):
    from repro_torch import data as TD
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.editing import EditConfig
    from repro_torch.federated import FederatedConfig, FederatedTrainer
    from repro_torch.interop import load_reference_state
    from repro_torch.optim import OptimizerConfig
    clients, gtest = TD.make_federated_datasets(TD.SyntheticTaskConfig(
        **_task(case["name"])), 2, np.array(SIZES))
    tr = FederatedTrainer(get_reduced_config(case["name"]),
                          FederatedConfig(edit=EditConfig(),
                                          **dict(FED, aggregator=aggregator)),
                          OptimizerConfig(peak_lr=LR, total_steps=TOTAL),
                          clients, clients, gtest, seed=0, mesh=mesh,
                          device="cpu")
    load_reference_state(tr, **case["state"])
    return tr


def run_family(case, mesh=None, async_=False):
    tr = port_family(case, mesh, "fedbuff" if async_ else AGG)
    step = tr.run_round_async if async_ else tr.run_round
    recs = [step() for _ in range(ROUNDS)]
    return {"recs": recs, "ranks": tr.client_ranks.copy(),
            "global": host(tr.server.global_lora),
            "stacked": host(tr.stacked_lora),
            "dispatch": dict(tr.dispatch_count)}, tr


def assert_round_close(got, want):
    for rg, rw in zip(got["recs"], want["recs"]):
        assert rg["sampled"] == list(map(int, rw["sampled"])), (rg, rw)
        assert rg["edited_layers"] == rw["edited_layers"], (rg, rw)
        assert abs(rg["train_loss"] - rw["train_loss"]) < 1e-4, (rg, rw)
    np.testing.assert_array_equal(got["ranks"], want["ranks"])
    for tree in ("global", "stacked"):
        for n, e in want[tree].items():
            for m in ("A", "B"):
                diff = np.abs(got[tree][n][m].numpy() - np.asarray(e[m]))
                what = (tree, n, m, diff.max())
                assert np.mean(diff > 5e-4) <= 1e-3, what
                assert diff.max() <= ROUNDS * STEPS * LR, what
                assert diff.mean() <= 1e-6, what


def _record_routes() -> list:
    """Record every MoE routing decision of this process: ids, places and
    kept flags of each ``moe_route`` call, in call order."""
    from repro_torch.models import layers as L
    seen, route = [], L.moe_route

    def recorded(router, xf, cfg):
        out = route(router, xf, cfg)
        seen.append(torch.stack([out[2], out[3], out[4].long()]).clone())
        return out

    L.moe_route = recorded
    return seen


def _rank_rounds(rank, world, rdv, shape, case_dir, names, out):
    """One rank: the rounds of each family of ``names`` on a ``(client,
    "model")`` mesh of ``shape``, each as soon as its case appears in
    ``case_dir``."""
    mesh = join_mesh(rank, world, rdv, shape, ("client", "model"))
    routes = _record_routes()
    res = {}
    for name in names:
        path = os.path.join(case_dir, f"{name}.pt")
        while not os.path.exists(path):
            time.sleep(0.05)
        case = torch.load(path, weights_only=False)
        routes.clear()
        res[name], tr = run_family(case, mesh)
        res[name]["routes"] = list(routes)
        if shape[0] > 1:
            # the population eval over the 2-D mesh against the per-client
            # loop
            res[name]["eval"] = (
                tr.evaluate_personalized(generate=True, n=4),
                tr.evaluate_personalized(generate=True, n=4, vmapped=False),
                tr.dispatch_count["population_eval"])
        else:
            # the async client update, meshed and unmeshed
            res[name]["async"] = (run_family(case, mesh, async_=True)[0],
                                  run_family(case, None, async_=True)[0])
    res["client"] = mesh.coord("client")
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    leave_mesh()


MESHES = {"1x2": ((1, 2), 2), "2x2": ((2, 2), 4)}


def make_runs(tmp_path_factory, names):
    """``(cases, the reference's rounds, the meshed ranks' results)`` for
    the families ``names``: one spawned group per mesh runs each family as
    soon as this process has written its case, while this process goes on
    to the reference's rounds."""
    case_dir = str(tmp_path_factory.mktemp("cases"))
    groups = {}
    for what, (shape, world) in MESHES.items():
        d = tmp_path_factory.mktemp(what)
        groups[what] = (start(_rank_rounds, world, str(d), shape, case_dir,
                              list(names)), d, world)
    cases, refs = {}, {}
    for name in names:
        cases[name], refs[name] = reference_family(name)
        path = os.path.join(case_dir, f"{name}.pt")
        torch.save(cases[name], path + ".part")
        os.replace(path + ".part", path)
    wants = {name: reference_rounds(ref) for name, ref in refs.items()}
    meshed = {}
    for what, (ctx, d, world) in groups.items():
        finish(ctx, timeout=300.0)
        meshed[what] = load_ranks(d, world)
    return cases, wants, meshed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory, HERE)


def start(fn, world: int, out: str, *args):
    """``fn(rank, world, rendezvous, *args, out)`` in ``world`` spawned
    processes (a gloo group), not waited for."""
    return mp.start_processes(fn, args=(world, os.path.join(out, "rdv"))
                              + args + (out,), nprocs=world, join=False,
                              start_method="spawn")


def finish(ctx, timeout: float) -> None:
    """Wait for spawned ranks; raises if one fails or they outlast
    ``timeout``."""
    end = time.monotonic() + timeout
    while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", HERE)
def test_family_rounds_on_mesh_match_reference(name, mesh, runs):
    """Clients over ``"client"``, each group's local training
    tensor-parallel over ``"model"``: one ``round_step`` a round, every
    rank the same state, within the reference's limits."""
    _, wants, meshed = runs
    outs = [o[name] for o in meshed[mesh]]
    assert_ranks_agree(outs)
    for o in outs:
        assert_round_close(o, wants[name])
        assert o["dispatch"] == {"round_step": ROUNDS}, o["dispatch"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", [n for n in MOE if n in HERE])
def test_moe_routes_agree_on_every_rank(name, mesh, runs):
    """The router runs whole on every rank: the ranks of one client group
    make the same routing decisions, call for call."""
    by_group: dict = {}
    for o in runs[2][mesh]:
        by_group.setdefault(o["client"], []).append(o[name]["routes"])
    for group in by_group.values():
        assert len(group[0]) > 0
        for other in group[1:]:
            assert len(other) == len(group[0])
            assert all(torch.equal(a, b) for a, b in zip(other, group[0]))


@pytest.mark.parametrize("name", HERE)
def test_population_eval_on_2x2_mesh(name, runs):
    """The personalized sweep with greedy decoding on the 2×2 mesh (each
    client group its block of clients, tensor-parallel) in one dispatch
    gives the per-client loop's BLEU / RSUM and its loss within 1e-5."""
    for o in runs[2]["2x2"]:
        ev, loop, n_pop = o[name]["eval"]
        assert (ev["bleu"], ev["rsum"]) == (loop["bleu"], loop["rsum"])
        assert abs(ev["loss"] - loop["loss"]) < 1e-5, (ev, loop)
        assert n_pop == 1


@pytest.mark.parametrize("name", HERE)
def test_async_update_on_1x2_mesh(name, runs):
    """``run_round_async`` (fedbuff's buffered client update) on the 1×2 mesh
    against the port's unmeshed async rounds: the same merges, losses
    within 1e-4 and global adapters by the AdamW rule."""
    for o in runs[2]["1x2"]:
        got, want = o[name]["async"]
        for rg, rw in zip(got["recs"], want["recs"]):
            assert rg["merges"] == rw["merges"], (rg, rw)
            assert abs(rg["train_loss"] - rw["train_loss"]) < 1e-4
        for n, e in want["global"].items():
            for m in ("A", "B"):
                diff = (got["global"][n][m] - e[m]).abs()
                assert diff.max() <= ROUNDS * STEPS * LR, (n, m)
                assert diff.mean() <= 1e-6, (n, m)


# -------------------------------------------------- (1, 1) in one process
@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    rdv = tmp_path_factory.mktemp("rdv1") / "file"
    init_distributed(init_method=f"file://{rdv}", world_size=1, rank=0,
                     device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", HERE)
def test_family_round_1x1_is_the_unmeshed_round(name, runs, world1):
    """At a model axis of size 1 every piece is whole and every
    collective returns its operand: the records and adapters equal the
    unmeshed round's bit for bit."""
    from repro_torch.launch.mesh import Mesh
    case = runs[0][name]
    got = run_family(case, Mesh((1, 1), ("client", "model")))[0]
    want = run_family(case)[0]
    assert got["recs"] == want["recs"]
    assert_trees_equal(got["global"], want["global"], "global")
    assert_trees_equal(got["stacked"], want["stacked"], "stacked")
