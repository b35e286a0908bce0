"""Batch-sharded steps on the CPU against the JAX package's steps on the
whole batch: ``make_train_step(mesh=)``, ``make_prefill_step(mesh=)`` and
``make_serve_step(mesh=)`` on spawned gloo ranks of ``("data",
"model")`` meshes (2, 1) and (2, 2), on fedbench-tiny and the reduced
llama4-scout and Jamba, with FSDP over ``"data"`` (the production steps'
placement).

Each rank holds its share of the global batch by the row contract
(``repro_torch.sharding.global_rows``): its block of each of the
reference's microbatches.  The loss masks' counts differ from row to row,
and the MoE routing drops picks (the test counts them), so the steps
agree only where the mask count and the MoE capacity, queue places, drops
and aux loss are the global batch's.

Limits: the loss, aux and accuracy within 1e-4; the adapters after one
SGD step at learning rate 1 (so their change is the gradient) within
1e-5 + 1e-4 relative; logits within 1e-4; MoE ids, places and drops
exact against the port's unmeshed step on the whole batch (itself equal
to the reference's routing bit for bit, ``tests/test_torch_families.py``);
every rank's adapters bit for bit the same.

The ranks import this module (spawn): JAX is imported only inside the
functions that run the reference.  ``tests/test_torch_placements.py``
runs its placements through the same harness."""

import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
mp = pytest.importorskip("torch.multiprocessing")

B, S, N_MICRO, R, SCALE, P, MAXLEN = 8, 16, 2, 4, 2.0, 6, 8
GATE = 0.5
TOL = dict(atol=1e-4, rtol=0)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# capacity factor 1: the reduced MoE configs drop picks on these batches
MOE_OVER = {"capacity_factor": 1.0}


# ----------------------------------------------------------------- inputs
def config(arch: str, over: dict, torch_side: bool):
    if torch_side:
        from repro_torch.configs import get_reduced_config
    else:
        from repro.configs import get_reduced_config
    cfg = get_reduced_config(arch)
    over = dict(over)
    moe = over.pop("moe", None)
    if moe and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **over)


def make_case(arch: str, over: dict, seed: int, batch: int = B) -> dict:
    """The reference's weights (gates opened to ``GATE``), an adapter, a
    batch whose loss masks' counts differ by row, and a prompt, as
    numpy."""
    import jax

    from repro.models import transformer as JT
    jc = config(arch, over, False)
    tree = jax.device_get(jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jc))
    for sp in tree["blocks"].values():
        if "cross" in sp:
            sp["cross"]["gate"] = np.full_like(sp["cross"]["gate"], GATE)
    rng = np.random.default_rng(seed + 1)
    lora = {s.name: {
        "A": (0.2 * rng.standard_normal((s.num_layers, R, s.in_dim))
              ).astype(np.float32),
        "B": (0.2 * rng.standard_normal((s.num_layers, s.out_dim, R))
              ).astype(np.float32)} for s in JT.lora_specs(jc)}
    tok = lambda *shape: rng.integers(0, jc.vocab_size, shape).astype(
        np.int32)
    keep = rng.uniform(0.2, 1.0, (batch, 1))
    data = {"tokens": tok(batch, S), "labels": tok(batch, S),
            "loss_mask": (rng.uniform(size=(batch, S)) < keep
                          ).astype(np.float32)}
    if jc.family == "vlm":
        data["image"] = rng.standard_normal(
            (batch, jc.num_vision_tokens, jc.vision_dim)).astype(np.float32)
        data["image_mask"] = (np.arange(batch) % 3 != 1).astype(np.float32)
    if jc.family == "encdec":
        data["audio"] = rng.standard_normal(
            (batch, 8, jc.audio_dim)).astype(np.float32)
    return {"arch": arch, "over": over, "params": tree, "lora": lora,
            "batch": data, "prompt": tok(batch, P)}


# -------------------------------------------------------------- reference
def reference(case: dict, steps) -> dict:
    """The JAX package's steps on the whole batch: the adapter after one
    SGD step (lr 1, no clip) and its metrics, the prefill logits, and the
    serve logits of a teacher-forced prompt."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as JS
    from repro.models import transformer as JT
    from repro.optim import OptimizerConfig as JOpt
    from repro.optim import sgdm_init
    jc = config(case["arch"], case["over"], False)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    lora = jax.tree_util.tree_map(jnp.asarray, case["lora"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    out = {}
    if "train" in steps:
        step = jax.jit(JS.make_train_step(
            jc, JOpt(name="sgdm", peak_lr=1.0, grad_clip=0.0),
            lora_scale=SCALE, num_microbatches=N_MICRO))
        new, _, m = step(params, lora, sgdm_init(lora), batch)
        out["lora"] = jax.device_get(new)
        out["metrics"] = {k: float(v) for k, v in m.items()}
    if "prefill" in steps:
        pre = {k: v for k, v in batch.items()
               if k in ("tokens", "image", "audio")}
        out["prefill"] = np.asarray(jax.jit(JS.make_prefill_step(
            jc, lora_scale=SCALE))(params, lora, pre))
    if "serve" in steps:
        serve = jax.jit(JS.make_serve_step(jc, lora_scale=SCALE))
        nb = case["prompt"].shape[0]
        cache = JT.init_cache(jc, params, nb, MAXLEN)
        logits = []
        for t in range(P):
            lg, cache = serve(params, lora, cache,
                              jnp.asarray(case["prompt"][:, t]), t)
            logits.append(np.asarray(lg))
        out["serve"] = np.stack(logits, 1)
    return out


# ------------------------------------------------------------ port, ranks
def record_routes() -> list:
    """Record the global places of every MoE routing of this process:
    ``(ids, places, kept)`` of each ``layers.moe_places`` call."""
    from repro_torch.models import layers as L
    seen, places = [], L.moe_places

    def recorded(ids, pos, cfg, tp=None):
        out = places(ids, pos, cfg, tp)
        seen.append(torch.stack([ids, out[0], out[1].long()]).clone())
        return out

    L.moe_places = recorded
    return seen


def port_steps(case: dict, job: dict, mesh=None) -> dict:
    """The port's steps of ``job`` on ``case``: on ``mesh`` this rank's
    share (its rows, its pieces; results gathered to the whole batch and
    vocabulary), else unmeshed on the whole batch."""
    from repro_torch.interop import lora_from_numpy, params_from_numpy
    from repro_torch.launch import steps as TS
    from repro_torch.models import transformer as T
    from repro_torch.models.tensor_parallel import TensorParallel
    from repro_torch.optim import OptimizerConfig, sgdm_init
    from repro_torch.sharding import batch_axes, global_rows
    cfg = config(case["arch"], case["over"], True)
    params = params_from_numpy(cfg, case["params"], device="cpu")
    lora = lora_from_numpy(case["lora"], device="cpu")
    data = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    prompt = torch.from_numpy(case["prompt"]).long()
    tp, ba, dp, c, split = None, None, 1, 0, None
    if mesh is not None:
        if job.get("tp", True):
            tp = TensorParallel(cfg, mesh, fsdp=job.get("fsdp", True),
                                ep=job.get("ep", False),
                                sp=job.get("sp", False))
            params = tp.shard_params(params)
        ba = batch_axes(mesh)
        dp, c = mesh.shape[ba], mesh.coord(ba)
        nb = prompt.shape[0]
        split = mesh if nb % dp == 0 else None
    whole = (lambda x: x) if tp is None else tp.full_logits
    rows_of = lambda x: x if split is None else x.reshape(
        (dp, -1) + tuple(x.shape[1:]))[c]
    gather = lambda x: x if split is None else mesh.all_gather(x, ba)
    routes = record_routes()
    out: dict = {"routes": {}}
    steps = job["steps"]
    if "train" in steps:
        routes.clear()
        rows = (list(range(B)) if split is None else
                global_rows(B, N_MICRO, dp, c))
        batch = {k: v[rows] for k, v in data.items()}
        step = TS.make_train_step(
            cfg, OptimizerConfig(name="sgdm", peak_lr=1.0, grad_clip=0.0),
            lora_scale=SCALE, num_microbatches=N_MICRO, tp=tp, mesh=split)
        new, _, m = step(params, lora, sgdm_init(lora), batch)
        out["lora"] = {n: {k: v.detach() for k, v in e.items()}
                       for n, e in new.items()}
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["routes"]["train"] = list(routes)
    if "prefill" in steps:
        routes.clear()
        pre = {k: rows_of(v) for k, v in data.items()
               if k in ("tokens", "image", "audio")}
        lg = TS.make_prefill_step(cfg, lora_scale=SCALE, tp=tp,
                                  mesh=split)(params, lora, pre)
        out["prefill"] = gather(whole(lg))
        out["routes"]["prefill"] = list(routes)
    if "serve" in steps:
        routes.clear()
        toks = rows_of(prompt)
        cache_axis, score_axis = job.get("cache_axis"), job.get("score_axis")
        cache = T.init_cache(cfg, params, toks.shape[0], MAXLEN, tp=tp,
                             cache_axis=cache_axis)
        serve = TS.make_serve_step(cfg, lora_scale=SCALE, tp=tp, mesh=split,
                                   cache_axis=cache_axis,
                                   score_axis=score_axis)
        lo = lora if tp is None else tp.local_lora(lora)
        logits = []
        for t in range(P):
            lg, cache = serve(params, lo, cache, toks[:, t], t)
            logits.append(gather(whole(lg)))
        out["serve"] = torch.stack(logits, 1)
        out["routes"]["serve"] = list(routes)
    if mesh is not None:
        # the model ranks of one batch block route alike
        agree = True
        for calls in out["routes"].values():
            for r in calls:
                every = mesh.all_gather(r[None], "model")
                agree &= bool((every == every[:1]).all())
        out["routes_agree"] = agree
        if job.get("shapes"):
            out["shapes"] = {}

            def walk(tree, path=()):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        walk(v, path + (k,))
                    else:
                        out["shapes"][path + (k,)] = tuple(v.shape)
            walk(params)
            out["placement"] = {"kv_groups": tp.kv_groups, "attn": tp.attn,
                                "ep": tp.ep, "sp": tp.sp}
        # routes: every batch rank's block, in batch-coordinate order
        out["routes"] = {k: [r if split is None else
                             mesh.all_gather(r, ba, dim=1) for r in v]
                         for k, v in out["routes"].items()}
        out["collectives"] = {f"{op}|{ax}": n for (op, ax), n in
                              mesh.collectives.items()}
        if split is None:
            # a batch the batch axes do not split: every rank's logits are
            # the whole batch's
            for step in ("prefill", "serve"):
                if step in out:
                    every = mesh.all_gather(out[step][None], mesh.axis_names)
                    out[f"{step}_ranks_gap"] = float(
                        (every - every[:1]).abs().max())
        if "lora" in out:
            flat = torch.cat([out["lora"][n][k].reshape(-1)
                              for n in sorted(out["lora"]) for k in "AB"])
            every = mesh.all_gather(flat[None], mesh.axis_names)
            out["ranks_agree"] = bool((every == every[:1]).all())
    return out


def rank_jobs(rank, world, rdv, shape, names, case_dir, jobs, out):
    """One rank: every job of a ``shape`` mesh (a fresh ``Mesh`` each),
    each as soon as its case appears in ``case_dir``."""
    from test_torch_mesh_round import join_mesh, leave_mesh
    from repro_torch.launch.mesh import Mesh
    join_mesh(rank, world, rdv, shape, names)
    res = {}
    for job in jobs:
        path = os.path.join(case_dir, f"{job['case']}.pt")
        while not os.path.exists(path):
            time.sleep(0.05)
        case = torch.load(path, weights_only=False)
        mesh = Mesh(job["mesh"], names)
        mesh.reset_collectives()
        res[job["name"]] = port_steps(case, job, mesh)
    if rank == 0:
        torch.save(res, os.path.join(out, "rank0.pt"))
    leave_mesh()


def start(world: int, out: str, *args):
    return mp.start_processes(rank_jobs, args=(world, os.path.join(out, "rdv"))
                              + args + (out,), nprocs=world, join=False,
                              start_method="spawn")


def finish(ctx, timeout: float) -> None:
    end = time.monotonic() + timeout
    while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


def run_all(tmp_path_factory, cases: dict, groups: dict) -> tuple:
    """Start every group's ranks (``{world: (shape, jobs)}``), write each
    case as it is built (``cases``: name -> (arch, over, seed, batch)),
    compute the reference's steps and the port's unmeshed ones meanwhile,
    then wait.  Returns ``(reference, unmeshed, meshed)`` keyed by case
    name and job name."""
    case_dir = str(tmp_path_factory.mktemp("cases"))
    running = {}
    for world, (shape, jobs) in groups.items():
        d = str(tmp_path_factory.mktemp(f"w{world}"))
        running[world] = (start(world, d, shape, ("data", "model"),
                                case_dir, jobs), d)
    steps: dict = {}
    for _, jobs in groups.values():
        for job in jobs:
            steps.setdefault(job["case"], set()).update(job["steps"])
    refs, plain = {}, {}
    for name, (arch, over, seed, nb) in cases.items():
        case = make_case(arch, over, seed, nb)
        path = os.path.join(case_dir, f"{name}.pt")
        torch.save(case, path + ".part")
        os.replace(path + ".part", path)
        refs[name] = reference(case, steps[name])
        plain[name] = port_steps(case, {"steps": steps[name]})
    meshed = {}
    for world, (ctx, d) in running.items():
        finish(ctx, timeout=400.0)
        meshed.update(torch.load(os.path.join(d, "rank0.pt"),
                                 weights_only=False))
    return refs, plain, meshed


# ------------------------------------------------------------ assertions
def assert_train(got: dict, want: dict) -> None:
    for k in ("loss", "aux", "acc", "total_loss"):
        assert abs(got["metrics"][k] - want["metrics"][k]) <= 1e-4, (
            k, got["metrics"], want["metrics"])
    for n, e in want["lora"].items():
        for k in ("A", "B"):
            np.testing.assert_allclose(got["lora"][n][k].numpy(),
                                       np.asarray(e[k]), err_msg=n + k,
                                       **GRAD_TOL)


def assert_logits(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def assert_routes(got: dict, plain: dict) -> int:
    """Ids, places and kept flags equal call for call; returns the picks
    dropped."""
    dropped = 0
    for step, mine in got.items():
        calls = plain[step]
        assert len(mine) == len(calls), step
        for g, w in zip(mine, calls):
            assert torch.equal(g, w), step
            dropped += int((w[2] == 0).sum())
    return dropped


# ----------------------------------------------------------------- tests
CASES = {"fedbench-tiny": ("fedbench-tiny", {}, 3, B),
         "llama4": ("llama4-scout-17b-a16e", {"moe": MOE_OVER}, 4, B),
         "jamba": ("jamba-v0.1-52b", {"moe": MOE_OVER}, 5, B)}
STEPS = ("train", "prefill", "serve")
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
JOBS = [{"name": f"{c}/{m}", "case": c, "mesh": shape, "steps": STEPS}
        for c in CASES for m, shape in MESHES.items()] + [
    # no tensor-parallel plan: whole weights, the batch over "data"
    {"name": "llama4/2x1-whole", "case": "llama4", "mesh": (2, 1),
     "steps": STEPS, "tp": False}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    groups = {2: ((2, 1), [j for j in JOBS if j["mesh"] == (2, 1)]),
              4: ((2, 2), [j for j in JOBS if j["mesh"] == (2, 2)])}
    return run_all(tmp_path_factory, CASES, groups)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_batch_sharded_train_step_is_the_global_batchs(runs, case, mesh):
    refs, _, meshed = runs
    got = meshed[f"{case}/{mesh}"]
    assert got["ranks_agree"]
    assert_train(got, refs[case])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_batch_sharded_prefill_and_serve(runs, case, mesh):
    refs, _, meshed = runs
    got = meshed[f"{case}/{mesh}"]
    assert_logits(got["prefill"], refs[case]["prefill"])
    assert_logits(got["serve"], refs[case]["serve"])


def test_batch_sharded_steps_over_whole_weights(runs):
    """``mesh=`` without a tensor-parallel plan: the steps build one that
    splits no weight."""
    refs, plain, meshed = runs
    got = meshed["llama4/2x1-whole"]
    assert got["ranks_agree"]
    assert_train(got, refs["llama4"])
    assert_logits(got["prefill"], refs["llama4"]["prefill"])
    assert_logits(got["serve"], refs["llama4"]["serve"])
    assert assert_routes(got["routes"], plain["llama4"]["routes"]) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["llama4", "jamba"])
def test_moe_routing_is_the_global_batchs(runs, case, mesh):
    """Ids, global places and drops of every routing call equal the
    unmeshed step's on the whole batch; picks were dropped."""
    _, plain, meshed = runs
    got = meshed[f"{case}/{mesh}"]
    assert assert_routes(got["routes"], plain[case]["routes"]) > 0
    assert got["collectives"]["all_gather|data"] > 0


def test_unmeshed_port_is_the_reference(runs):
    refs, plain, _ = runs
    for case in CASES:
        assert_train(plain[case], refs[case])
        assert_logits(plain[case]["prefill"], refs[case]["prefill"])
        assert_logits(plain[case]["serve"], refs[case]["serve"])


def test_row_contract():
    from repro_torch.sharding import global_rows
    assert global_rows(8, 2, 2, 0) == [0, 1, 4, 5]
    assert global_rows(8, 2, 2, 1) == [2, 3, 6, 7]
    assert sorted(global_rows(12, 3, 2, 0) + global_rows(12, 3, 2, 1)) == \
        list(range(12))
    with pytest.raises(ValueError):
        global_rows(8, 3, 2, 0)


@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_moe_tiles_are_the_dense_buffers(skew):
    """A batch-sharded rank's experts over tiles of its kept picks equal
    the ``[E, R, d]`` buffers over every place, pick for pick, with one
    expert taking most picks (``skew``) and a capacity that drops some."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(7)
    T, K, E, d, ff = 24, 2, 4, 8, 6
    params = {k: torch.randn(s, generator=g) / s[1] ** 0.5 for k, s in
              (("w1", (E, d, ff)), ("w3", (E, d, ff)), ("w2", (E, ff, d)))}
    xf = torch.randn((T, d), generator=g)
    logits = torch.randn((T, E), generator=g)
    logits[:, 0] += skew
    ids = logits.argsort(dim=-1, descending=True, stable=True)[:, :K]
    order = ids.reshape(-1).argsort(stable=True)
    starts = torch.searchsorted(ids.reshape(-1)[order], torch.arange(E))
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K) - starts[ids.reshape(-1)[order]]
    pos = pos.reshape(T, K)
    kept = pos < 9
    assert (~kept).any() and kept.any()
    out, row = L._moe_tiles(params, xf, ids, pos, kept)
    R = T
    buf = torch.zeros((E * R, d))
    buf[(ids * R + pos).reshape(-1)] = xf.repeat_interleave(K, 0)
    dense = L._experts(params, buf.reshape(E, R, d)).reshape(E * R, d)
    want = dense[(ids * R + pos)[kept]]
    torch.testing.assert_close(out[row[kept]], want, rtol=1e-5, atol=1e-5)
    assert out.shape[0] <= 1.25 * T * K + 4 * E
