"""Tensor parallelism for every non-dense family on the CPU, in a gloo
group of 2 spawned ranks, against the JAX package: ``("data", "model")``
1×2 serving engines on the reduced mamba2-130m (streamed prefill), hybrid
Jamba and DeepSeek-V2 (MLA + MoE; also in chunks of 3), f32, through both
LoRA backends, must give the reference engine's greedy tokens request for
request and the unmeshed port engine's dispatch counts; seamless-m4t's
loss and LoRA gradients on a (1, 2) mesh must equal the reference's
(``loss_fn`` atol 1e-5, gradients atol 1e-5 + rtol 1e-4, the limits of
``tests/test_torch_cross_encdec.py``).  Then the plan itself at two
ranks: cutting and re-joining every family's tree is the identity,
Mamba's ``in_proj`` and conv are cut segment by segment, the gated norm
over split heads equals ``rms_norm`` over the whole ``d_in``, a bank's
``A`` / ``B`` are cut at the row- / column-parallel sites, and the enc-dec
frontend ``encoder.in_proj`` stays whole.

The ranks import this module (spawn), so JAX is imported only inside the
functions that run the reference."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_mesh_families import finish, start  # noqa: E402
from test_torch_mesh_round import (join_mesh, leave_mesh,  # noqa: E402
                                   load_ranks)

SERVED = ["mamba2-130m", "jamba-v0.1-52b", "deepseek-v2-236b"]
PLANNED = SERVED + ["llama4-scout-17b-a16e", "llama-3.2-vision-11b",
                    "seamless-m4t-medium"]
ENCDEC = "seamless-m4t-medium"
TENANTS = (4, 8, 16, 8, 4)
BANK_SLOTS, RANK, SCALE = 2, 16, 2.0
ENGINE_KW = dict(lora_scale=SCALE, max_slots=4, max_prompt=8, max_gen=6)
B, S = 2, 12
RUNS = {"gather": {}, "grouped": {"lora_backend": "grouped"}}
CHUNKED = {"grouped.chunk3": {"lora_backend": "grouped", "prefill_chunk": 3}}


# ----------------------------------------------------------------- worlds
def _adapter(specs, r, rng, scale=0.2):
    return {s.name: {
        "A": (scale * rng.standard_normal((s.num_layers, r, s.in_dim))
              ).astype(np.float32),
        "B": (scale * rng.standard_normal((s.num_layers, s.out_dim, r))
              ).astype(np.float32)} for s in specs}


def serve_world(name, seed=0) -> dict:
    """The reference's params, tenants' adapters and requests."""
    import jax

    from repro.configs import get_reduced_config
    from repro.models import transformer as JT
    cfg = get_reduced_config(name)
    tree = jax.device_get(jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    specs = JT.lora_specs(cfg)
    adapters = {f"t{t}": (_adapter(specs, r, rng), r)
                for t, r in enumerate(TENANTS)}
    reqs = [(f"t{int(rng.integers(0, len(TENANTS)))}",
             rng.integers(0, cfg.vocab_size, size=int(rng.integers(1, 9))),
             int(rng.integers(1, 7))) for _ in range(9)]
    return {"name": name, "tree": tree, "adapters": adapters, "reqs": reqs}


def encdec_world(seed=0) -> dict:
    """The reference's seamless-m4t params, an adapter on every site and
    a batch with audio."""
    import jax

    from repro.configs import get_reduced_config
    from repro.models import transformer as JT
    cfg = get_reduced_config(ENCDEC)
    tree = jax.device_get(jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)),
             "loss_mask": (rng.random((B, S)) < 0.7).astype(np.float32),
             "audio": rng.standard_normal((B, 8, cfg.audio_dim)
                                          ).astype(np.float32)}
    return {"tree": tree, "lora": _adapter(JT.lora_specs(cfg), 4, rng),
            "batch": batch}


def reference_tokens(world) -> list:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.serving import AdapterStore, Request, ServingEngine
    store = AdapterStore(slots=BANK_SLOTS, rank=RANK)
    for t, (a, r) in world["adapters"].items():
        store.register(t, a, r)
    eng = ServingEngine(get_reduced_config(world["name"]),
                        jax.tree_util.tree_map(jnp.asarray, world["tree"]),
                        store, **ENGINE_KW)
    return _bags(eng, Request, world["reqs"])


def reference_loss(world):
    """The reference's loss and LoRA gradients on seamless-m4t."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models import transformer as JT
    cfg = get_reduced_config(ENCDEC)
    conv = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda lo: JT.loss_fn(cfg, conv(world["tree"]), lo,
                              conv(world["batch"]), SCALE),
        has_aux=True))(conv(world["lora"]))
    return float(loss), jax.device_get(grads)


def _bags(engine, request_cls, reqs):
    """Each request's tokens, in submission order."""
    rs = [request_cls(adapter_id=a, prompt_tokens=p, gen_len=g)
          for a, p, g in reqs]
    order = {r.uid: i for i, r in enumerate(rs)}
    out = [None] * len(rs)
    for d in engine.run(rs):
        out[order[d["uid"]]] = np.asarray(d["tokens"]).tolist()
    return out


# ------------------------------------------------------------------ ranks
def _port_engine(world, mesh=None, **kw):
    from repro_torch.configs import get_reduced_config
    from repro_torch.interop import adapters_from_numpy, params_from_numpy
    from repro_torch.serving import AdapterStore, ServingEngine
    store = AdapterStore(slots=BANK_SLOTS, rank=RANK, device="cpu",
                         mesh=mesh)
    for t, (a, r) in world["adapters"].items():
        store.register(t, adapters_from_numpy(a), r)
    cfg = get_reduced_config(world["name"])
    return ServingEngine(cfg, params_from_numpy(cfg, world["tree"],
                                                device="cpu"),
                         store, device="cpu", mesh=mesh, **ENGINE_KW, **kw)


def _serve(world, mesh) -> dict:
    from repro_torch.serving import Request
    runs = dict(RUNS, **(CHUNKED if world["name"] == "deepseek-v2-236b"
                         else {}))
    out = {}
    for what, m in [("unmeshed", None)] + [(k, mesh) for k in runs]:
        eng = _port_engine(world, m, **runs.get(what, {}))
        out[what] = (_bags(eng, Request, world["reqs"]),
                     dict(eng.dispatch_count))
    out["bank"] = {n: {p: tuple(x.shape) for p, x in e.items()}
                   for n, e in eng.store.scan_stack.items()}
    return out


def _encdec_loss(world, mesh):
    from repro_torch.configs import get_reduced_config
    from repro_torch.interop import lora_from_numpy, params_from_numpy
    from repro_torch.launch.steps import loss_and_grad
    from repro_torch.models.tensor_parallel import TensorParallel
    cfg = get_reduced_config(ENCDEC)
    params = params_from_numpy(cfg, world["tree"], device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in world["batch"].items()}
    loss, _, grads = loss_and_grad(
        cfg, params, lora_from_numpy(world["lora"], device="cpu"), batch,
        SCALE, tp=TensorParallel(cfg, mesh))
    return float(loss), {n: {m: g.numpy() for m, g in e.items()}
                         for n, e in grads.items()}, {
        "encoder.in_proj": tuple(params["encoder"]["in_proj"].shape),
        "encoder.wq": tuple(params["encoder"]["blocks"]["s0"]["attn"][
            "wq"].shape)}


def _plan_checks(mesh) -> dict:
    """The plan at this rank: cut ∘ join, the segment cuts, the gated
    norm and the bank's cuts, per family."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.tensor_parallel import TensorParallel
    out = {}
    for name in PLANNED:
        cfg = get_reduced_config(name)
        whole = T.init_params(cfg, seed=3, device="cpu")
        tp = TensorParallel(cfg, mesh)
        piece = tp.shard_params(whole)
        back = tp.unshard_params(piece)
        res = {"identity": _trees_equal(back, whole),
               "init_cut": _trees_equal(
                   T.init_params(cfg, seed=3, device="cpu", tp=tp), piece)}
        rng = torch.Generator().manual_seed(4)
        specs = T.lora_specs(cfg)
        lora = {s.name: {"A": torch.randn(s.num_layers, 2, 4, s.in_dim,
                                          generator=rng),
                         "B": torch.randn(s.num_layers, 2, s.out_dim, 4,
                                          generator=rng)} for s in specs}
        res["bank"] = {s.name: (tp.bank_a(s.name, lora[s.name]["A"]),
                                tp.bank_b(s.name, lora[s.name]["B"]),
                                lora[s.name]["A"], lora[s.name]["B"])
                       for s in specs}
        if cfg.ssm is not None:
            mp = whole["blocks"]["s0"]["mamba"]
            res["mamba"] = {k: (mp[k], piece["blocks"]["s0"]["mamba"][k])
                            for k in ("in_proj", "conv_w", "conv_b",
                                      "A_log", "gate_norm", "out_proj")}
            d_in = cfg.ssm.expand * cfg.d_model
            y = torch.randn(3, 5, d_in, generator=rng)
            scale = 1.0 + 0.1 * torch.randn(d_in, generator=rng)
            lo = tp.rank * d_in // tp.n
            sl = slice(lo, lo + d_in // tp.n)
            res["gate_norm"] = (
                L._gate_norm(y[..., sl], scale[sl], cfg, tp),
                L.rms_norm(y, scale, cfg.norm_eps)[..., sl])
        out[name] = res
    return out


def _trees_equal(a, b) -> bool:
    if isinstance(b, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in b)
    return a.dtype == b.dtype and torch.equal(a, b)


def _rank_serving(rank, world, rdv, case_dir, out):
    """One rank of a 1×2 ``("data", "model")`` mesh: the engines, the
    enc-dec loss and the plan checks, each world as soon as it appears in
    ``case_dir``."""
    from repro_torch.launch.mesh import Mesh
    join_mesh(rank, world, rdv, (1, 2), ("data", "model"))
    mesh = Mesh((1, 2), ("data", "model"))

    def load(name):
        path = os.path.join(case_dir, f"{name}.pt")
        while not os.path.exists(path):
            time.sleep(0.05)
        return torch.load(path, weights_only=False)

    res = {"plan": _plan_checks(mesh), "rank": rank}
    res["encdec"] = _encdec_loss(load(ENCDEC), mesh)
    for name in SERVED:
        res[name] = _serve(load(name), mesh)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    leave_mesh()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference results, the ranks' results)``: the spawned group
    runs each world as soon as this process has written it, while this
    process goes on to the reference's."""
    case_dir = str(tmp_path_factory.mktemp("worlds"))
    d = tmp_path_factory.mktemp("ranks")
    ctx = start(_rank_serving, 2, str(d), case_dir)
    worlds = {}
    for name in [ENCDEC] + SERVED:
        worlds[name] = (encdec_world() if name == ENCDEC
                        else serve_world(name))
        path = os.path.join(case_dir, f"{name}.pt")
        torch.save(worlds[name], path + ".part")
        os.replace(path + ".part", path)
    want = {name: reference_tokens(worlds[name]) for name in SERVED}
    want[ENCDEC] = reference_loss(worlds[ENCDEC])
    finish(ctx, timeout=300.0)
    return want, load_ranks(d, 2), worlds


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", SERVED)
def test_tp_engines_serve_the_reference_tokens(name, runs):
    """Both ranks of a 1×2 ``("data", "model")`` engine complete every
    request with the reference engine's greedy tokens, through the
    gather and grouped backends (and chunked prefill on DeepSeek-V2), and
    the host loop dispatches as the unmeshed engine's does."""
    want, outs, _ = runs
    plain_bags, plain_counts = outs[0][name]["unmeshed"]
    assert plain_bags == want[name]
    for o in outs:
        for what, run in o[name].items():
            if what == "bank":
                continue
            bags, counts = run
            assert bags == want[name], (what, bags, want[name])
            if "chunk" not in what:
                assert counts == plain_counts, (what, counts, plain_counts)


def test_tp_engine_banks_hold_the_shard_shapes(runs):
    """A meshed engine's bank: ``B`` rows at the column-parallel sites
    (Mamba's ``in_proj`` cut segment by segment, MLA's ``wuq`` by heads),
    ``A`` columns at Mamba's row-parallel ``out_proj``; MLA's ``wkv_b``
    by heads; every other leaf whole."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    _, outs, _ = runs
    for name in SERVED:
        cfg = get_reduced_config(name)
        bank = outs[0][name]["bank"]
        for s in T.lora_specs(cfg):
            a, b = bank[s.name]["A"], bank[s.name]["B"]
            site = s.name.split(".", 1)[1]
            if site == "mamba.in_proj":
                d_in, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
                H = d_in // cfg.ssm.head_dim
                out = d_in + 2 * N + H // 2
                assert (a[-1], b[-2]) == (s.in_dim, out), (s.name, a, b)
            elif site == "mamba.out_proj":
                assert (a[-1], b[-2]) == (s.in_dim // 2, s.out_dim)
            else:
                assert (a[-1], b[-2]) == (s.in_dim, s.out_dim // 2), s.name


def test_encdec_loss_and_grads_on_a_mesh_match_reference(runs):
    """seamless-m4t on a (1, 2) mesh: the encoder's self-attention and
    MLP and the decoder's cross layers split, the frontend whole; the
    loss and every LoRA gradient (``enc.*`` and ``dec_cross.*`` too) are
    the reference's."""
    from repro_torch.configs import get_reduced_config
    want, outs, _ = runs
    jl, jg = want[ENCDEC]
    cfg = get_reduced_config(ENCDEC)
    for o in outs:
        loss, grads, shapes = o["encdec"]
        np.testing.assert_allclose(loss, jl, atol=1e-5, rtol=0)
        assert set(grads) == set(jg)
        for n in jg:
            for m in ("A", "B"):
                assert np.abs(jg[n][m]).max() > 0, (n, m)
                np.testing.assert_allclose(grads[n][m], jg[n][m], atol=1e-5,
                                           rtol=1e-4, err_msg=n + m)
        assert shapes["encoder.in_proj"] == (cfg.audio_dim, cfg.d_model)
        hd = cfg.resolved_head_dim
        assert shapes["encoder.wq"][-1] == cfg.num_heads * hd // 2
    a, b = outs[0]["encdec"][1], outs[1]["encdec"][1]
    for n in a:
        for m in ("A", "B"):
            assert np.array_equal(a[n][m], b[n][m]), (n, m)


@pytest.mark.parametrize("name", PLANNED)
def test_cut_and_join_is_the_identity(name, runs):
    """``unshard_params(shard_params(p)) == p`` bit for bit at two ranks,
    for every family's whole tree (the segment cuts included)."""
    for o in runs[1]:
        assert o["plan"][name]["identity"], name


@pytest.mark.parametrize("name", PLANNED)
def test_init_params_cut_is_the_cut_of_the_whole(name, runs):
    """``init_params(tp=)`` draws the whole tree's values in the same
    order and cuts each sublayer as it is drawn: the pieces equal
    ``shard_params(init_params())`` bit for bit."""
    for o in runs[1]:
        assert o["plan"][name]["init_cut"], name


def _segments(cfg, rank: int, n: int = 2):
    """Mamba's in_proj columns and conv channels a rank holds."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    N, H = s.state_dim, d_in // s.head_dim

    def take(size, at):
        loc = size // n
        return list(range(at + rank * loc, at + (rank + 1) * loc))
    in_cols = (take(d_in, 0) + take(d_in, d_in)
               + list(range(2 * d_in, 2 * d_in + 2 * N))
               + take(H, 2 * d_in + 2 * N))
    conv = take(d_in, 0) + list(range(d_in, d_in + 2 * N))
    return in_cols, conv, take(H, 0), take(d_in, 0)


@pytest.mark.parametrize("name", ["mamba2-130m", "jamba-v0.1-52b"])
def test_mamba_segment_cut_and_gated_norm(name, runs):
    """``in_proj``: the rank's ``z`` / ``xs`` / ``dt`` columns beside the
    whole ``B`` / ``C``; the conv channels likewise; ``A_log`` and
    ``gate_norm`` by heads; ``out_proj`` by rows.  The gated norm over the
    rank's heads equals ``rms_norm`` over the whole ``d_in`` (1e-6)."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(name)
    for o in runs[1]:
        in_cols, conv, heads, rows = _segments(cfg, o["rank"])
        m = o["plan"][name]["mamba"]
        for key, dim, idx in [("in_proj", -1, in_cols), ("conv_w", -1, conv),
                              ("conv_b", -1, conv), ("A_log", -1, heads),
                              ("gate_norm", -1, rows),
                              ("out_proj", -2, rows)]:
            whole, piece = m[key]
            want = whole.index_select(dim % whole.dim(), torch.tensor(idx))
            assert torch.equal(piece, want), key
        got, want = o["plan"][name]["gate_norm"]
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", PLANNED)
def test_bank_cuts(name, runs):
    """``bank_b`` cuts ``B``'s rows at the column-parallel sites,
    ``bank_a`` ``A``'s columns at the row-parallel one (Mamba's
    ``out_proj``); both contiguous, and the other leaf whole."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(name)
    for o in runs[1]:
        r = o["rank"]
        for site, (a_cut, b_cut, a, b) in o["plan"][name]["bank"].items():
            assert a_cut.is_contiguous() and b_cut.is_contiguous()
            if site.endswith("mamba.in_proj"):
                assert torch.equal(a_cut, a)
                idx = torch.tensor(_segments(cfg, r)[0])
                assert torch.equal(b_cut, b.index_select(-2, idx))
            elif site.endswith("mamba.out_proj"):
                assert torch.equal(b_cut, b)
                half = a.shape[-1] // 2
                assert torch.equal(a_cut, a[..., r * half:(r + 1) * half])
            else:
                assert torch.equal(a_cut, a), site
                half = b.shape[-2] // 2
                assert torch.equal(b_cut, b[..., r * half:(r + 1) * half, :])


# -------------------------------------------------- one rank, in process
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


@pytest.mark.parametrize("name", SERVED)
def test_one_rank_engine_is_the_unmeshed_engine(name, runs, world1):
    """A (1, 1) ``("data", "model")`` engine, grouped backend: every piece
    whole, every collective its operand — the unmeshed engine's tokens
    and dispatch counts."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import Request
    world = runs[2][name]
    got = _port_engine(world, Mesh((1, 1), ("data", "model")),
                       lora_backend="grouped")
    want = _port_engine(world, None, lora_backend="grouped")
    assert _bags(got, Request, world["reqs"]) == _bags(want, Request,
                                                       world["reqs"])
    assert dict(got.dispatch_count) == dict(want.dispatch_count)


def test_one_rank_encdec_loss_and_grads_bit_for_bit(runs, world1):
    """seamless-m4t on a (1, 1) mesh: the unmeshed loss and LoRA
    gradients bit for bit."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.interop import lora_from_numpy, params_from_numpy
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import loss_and_grad
    from repro_torch.models.tensor_parallel import TensorParallel
    world = runs[2][ENCDEC]
    cfg = get_reduced_config(ENCDEC)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in world["batch"].items()}
    lora = lora_from_numpy(world["lora"], device="cpu")
    mesh = Mesh((1, 1), ("data", "model"))
    got = loss_and_grad(cfg, params_from_numpy(cfg, world["tree"],
                                               device="cpu", mesh=mesh),
                        lora, batch, SCALE, tp=TensorParallel(cfg, mesh))
    want = loss_and_grad(cfg, params_from_numpy(cfg, world["tree"],
                                                device="cpu"),
                         lora, batch, SCALE)
    assert torch.equal(got[0], want[0])
    for n in want[2]:
        for m in ("A", "B"):
            assert torch.equal(got[2][n][m], want[2][n][m]), (n, m)
