"""The port's Mamba-2 (SSD), MoE and MLA layers, and the forward and loss of
the stacks built from them (mamba2-130m, jamba-v0.1-52b, deepseek-v2-236b
with and without a q-side down-projection, llama4-scout-17b-a16e; reduced
configs), against the JAX package on the CPU.  Weights cross through
``repro_torch.interop``; inputs come from numpy seeds.  The decode paths
are in ``test_torch_families_decode.py``, the engine in
``test_torch_families_serving.py``.

Tolerances, f32: logits atol 1e-4; layer outputs, caches and SSD states
atol 1e-5 (sums in another order), and after ten streamed steps the caches
1e-4 of their size more (a Mamba state under a folded adapter reaches
~100); the MoE router's integer decisions (expert ids, capacity positions,
drops) bit for bit; greedy tokens equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

LOGIT_TOL = dict(atol=1e-4, rtol=0)
STATE_TOL = dict(atol=1e-5, rtol=0)
STREAMED_TOL = dict(atol=1e-5, rtol=1e-4)


def _dense_q(cfg):
    """DeepSeek with ``q_lora_rank=0``: MLA's ``wq`` branch."""
    return dataclasses.replace(cfg, name=cfg.name + "-wq",
                               mla=dataclasses.replace(cfg.mla, q_lora_rank=0))


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def _capacity(cf):
    return lambda cfg: dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


VARIANTS = {"mamba2": ("mamba2-130m", None),
            "jamba": ("jamba-v0.1-52b", None),
            "deepseek": ("deepseek-v2-236b", None),
            "deepseek-wq": ("deepseek-v2-236b", _dense_q),
            "llama4": ("llama4-scout-17b-a16e", None)}
MOE_VARIANTS = ["jamba", "deepseek", "llama4"]


def _cfgs(variant, extra=None):
    """(reference config, port config) of one variant."""
    name, mod = VARIANTS[variant]
    jc, tc = get_reduced_config(name), t_reduced(name)
    for f in (mod, extra):
        if f is not None:
            jc, tc = f(jc), f(tc)
    return jc, tc


def _world(variant, seed=0, extra=None):
    jc, tc = _cfgs(variant, extra)
    tree = jax.device_get(jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jc))
    return jc, tc, tree, params_from_numpy(tc, tree, device="cpu")


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _lora(cfg, r, seed, lead=(), scale=0.2):
    """An adapter tree ``{spec: {"A": [L, *lead, r, in], "B": [L, *lead,
    out, r]}}`` (``lead=(G,)``: a scan-major bank)."""
    rng = np.random.default_rng(seed)
    return {s.name: {
        "A": (scale * rng.standard_normal((s.num_layers,) + lead
                                          + (r, s.in_dim))).astype(np.float32),
        "B": (scale * rng.standard_normal((s.num_layers,) + lead
                                          + (s.out_dim, r))).astype(np.float32)}
        for s in JT.lora_specs(cfg)}


def _layer0(tree):
    """Block 0 of a stacked sublayer tree, as numpy."""
    return jax.tree_util.tree_map(lambda x: np.array(x[0]), tree)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------

def test_ssd_chunked_pads_to_the_chunk():
    """S = 45 over chunks of 16: three chunks, the last padded."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 45, 3, 8, 5
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    jy, jh = jax.jit(JL.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (xh, dt, A, Bm, Cm)), 16)
    ty, th = TL.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), 16)
    assert ty.shape == (B, S, H, P) and th.shape == (B, H, P, N)
    _close(ty, jy, STATE_TOL)
    _close(th, jh, STATE_TOL)
    # the port sums each segment on its own (test_torch_mamba_scale.py):
    # the reference's -inf pattern, and the exact sums within f32 rounding
    seg = TL._segsum(torch.from_numpy(dt[0, :5, 0])).numpy()
    ref = np.asarray(JL._segsum(jnp.asarray(dt[0, :5, 0])))
    np.testing.assert_array_equal(np.isneginf(seg), np.isneginf(ref))
    cs = np.cumsum(dt[0, :5, 0].astype(np.float64))
    low = np.tril(np.ones((5, 5), bool))
    np.testing.assert_allclose(seg[low], (cs[:, None] - cs[None, :])[low],
                               rtol=0, atol=1e-6)


def test_mamba_forward_and_decode_match_reference():
    """mamba_forward over S = 40 (two chunks of 32), then mamba_decode from
    a random state: single (no LoRA, the reference's layer contract) and
    banked through both grouped paths; outputs and the in-place cache."""
    jc, tc, tree, _ = _world("mamba2")
    mp = _layer0(tree["blocks"]["s0"]["mamba"])
    rng = np.random.default_rng(1)
    B, S = 2, 40
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    _close(TL.mamba_forward(_torch(mp), torch.from_numpy(x), tc),
           jax.jit(lambda p, x: JL.mamba_forward(p, x, jc))(
               _jax(mp), jnp.asarray(x)), STATE_TOL)

    s = jc.ssm
    d_in = s.expand * jc.d_model
    cache = {"h": rng.standard_normal((B, d_in // s.head_dim, s.head_dim,
                                       s.state_dim)).astype(np.float32),
             "conv": rng.standard_normal((B, s.conv_width - 1,
                                          d_in + 2 * s.state_dim)
                                         ).astype(np.float32)}
    x1 = x[:, :1]
    bank = {k.split(".")[-1]: _layer0(v) for k, v in
            _lora(jc, 8, 2, lead=(3,)).items()}
    idx = np.array([2, 0], np.int32)
    cases = [dict(), dict(lora=bank, lora_idx=idx, lora_kernel=False),
             dict(lora=bank, lora_idx=idx, lora_kernel=True)]
    for kw in cases:
        kernel = kw.pop("lora_kernel", False)
        jkw = {k: (_jax(v) if k == "lora" else jnp.asarray(v))
               for k, v in kw.items()}
        tkw = {k: (_torch(v) if k == "lora" else torch.from_numpy(v).long())
               for k, v in kw.items()}
        tkw["lora_kernel"] = kernel
        jy, jcache = jax.jit(lambda p, x, c, kw: JL.mamba_decode(
            p, x, c, jc, lora_scale=0.5, lora_kernel=kernel, **kw))(
                _jax(mp), jnp.asarray(x1), _jax(cache), jkw)
        tcache = _torch(cache)
        ty, out = TL.mamba_decode(_torch(mp), torch.from_numpy(x1), tcache,
                                  tc, lora_scale=0.5, **tkw)
        assert out is tcache and tcache["h"].dtype == torch.float32
        _close(ty, jy, STATE_TOL)
        for k in ("h", "conv"):
            _close(tcache[k], jcache[k], STATE_TOL)


def test_init_keeps_the_reference_f32_leaves_under_bf16():
    """init_params and params_from_numpy keep the router, A_log, D and
    dt_bias in f32 under a bf16 config: every leaf's dtype, name and shape
    equal to the reference tree's."""
    for variant in ("jamba", "deepseek"):
        jc, tc, tree, port = _world(variant, extra=_bf16)
        mine = TT.init_params(tc, seed=3, device="cpu")
        ref = jax.tree_util.tree_leaves_with_path(tree)
        for got in (port, mine):
            leaves = jax.tree_util.tree_leaves_with_path(got)
            assert [p for p, _ in leaves] == [p for p, _ in ref]
            for (path, r), (_, t) in zip(ref, leaves):
                want = (torch.float32 if r.dtype == np.float32
                        else torch.bfloat16)
                assert t.dtype == want and tuple(t.shape) == r.shape, path
        f32 = [jax.tree_util.keystr(p) for p, r in ref if r.dtype == np.float32]
        assert f32 and all(k.split("'")[-2] in ("router", "A_log", "D",
                                                "dt_bias") for k in f32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _reference_routing(router, xf, cfg):
    """The reference's routing lines of ``moe_forward`` (layers.py:652-677),
    which it does not expose: ids, gates, the per-pick capacity position
    and whether the pick is kept, in [T, K] (token, k) order."""
    mo = cfg.moe
    T = xf.shape[0]
    E, K = mo.num_experts, mo.experts_per_token
    C = max(int(np.ceil(K * T / E * mo.capacity_factor)), 1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ router, axis=-1)
    gates, ids = jax.lax.top_k(probs, K)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    pos_sorted = jnp.arange(T * K) - starts[sorted_e]
    pos = jnp.zeros((T * K,), pos_sorted.dtype).at[order].set(pos_sorted)
    return ids, pos.reshape(T, K), pos.reshape(T, K) < C


@pytest.mark.parametrize("variant", MOE_VARIANTS)
def test_moe_routing_and_output_match_reference(variant):
    """At the default capacity factor, with ties (zero rows: every expert
    equally likely) and drops (repeated rows overfill their experts)."""
    jc, tc, tree, _ = _world(variant)
    sub = next(s for s in tree["blocks"].values() if "moe" in s)
    mp = _layer0(sub["moe"])
    rng = np.random.default_rng(3)
    B, S, d = 3, 8, jc.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    x[0, :3] = 0.0                               # ties
    x[1:] = x[1, 0]                              # 16 tokens, one expert set
    ids, pos, kept = jax.jit(lambda r, xf: _reference_routing(r, xf, jc))(
        jnp.asarray(mp["router"]), jnp.asarray(x.reshape(-1, d)))
    _, _, tids, tpos, tkept = TL.moe_route(torch.from_numpy(mp["router"]),
                                           torch.from_numpy(x.reshape(-1, d)),
                                           tc)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(kept))
    assert not bool(tkept.all())                 # something was dropped
    assert (tids[:3] == torch.arange(jc.moe.experts_per_token)).all()
    jy, jaux = jax.jit(lambda p, x: JL.moe_forward(p, x, jc))(
        _jax(mp), jnp.asarray(x))
    ty, taux = TL.moe_forward(_torch(mp), torch.from_numpy(x), tc)
    _close(ty, jy, STATE_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["deepseek", "deepseek-wq"])
def test_mla_forward_and_decode_batch_match_reference(variant):
    """mla_forward with one adapter; mla_decode_batch over a random
    compressed cache at ragged positions with a ragged valid mask, with one
    adapter and with a bank through both grouped paths (masked tails leave
    their cache rows untouched)."""
    jc, tc, tree, _ = _world(variant)
    mp = _layer0(tree["blocks"]["s0"]["mla"])
    rng = np.random.default_rng(4)
    B, S, d = 3, 12, jc.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    one = {k.split(".")[-1]: _layer0(v) for k, v in _lora(jc, 8, 5).items()}
    _close(TL.mla_forward(_torch(mp), torch.from_numpy(x), tc,
                          lora=_torch(one), lora_scale=0.5),
           jax.jit(lambda p, x, lo: JL.mla_forward(p, x, jc, lora=lo,
                                                   lora_scale=0.5))(
               _jax(mp), jnp.asarray(x), _jax(one)), STATE_TOL)

    m, Smax, C = jc.mla, 16, 4
    cache = {"c_kv": rng.standard_normal((B, Smax, m.kv_lora_rank)),
             "k_rope": rng.standard_normal((B, Smax, m.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    pos = np.array([0, 5, 11], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], bool)
    bank = {k.split(".")[-1]: _layer0(v) for k, v in
            _lora(jc, 8, 6, lead=(4,)).items()}
    idx = np.array([3, 0, 3], np.int32)
    xc = x[:, :C]
    for lora, lidx, kernel in [(one, None, False), (bank, idx, False),
                               (bank, idx, True)]:
        jy, jcache = jax.jit(lambda p, x, c, lo, li: JL.mla_decode_batch(
            p, x, c, jc, pos=jnp.asarray(pos), valid=jnp.asarray(valid),
            lora=lo, lora_scale=0.5, lora_idx=li, lora_kernel=kernel))(
                _jax(mp), jnp.asarray(xc), _jax(cache), _jax(lora),
                None if lidx is None else jnp.asarray(lidx))
        tcache = _torch(cache)
        ty, _ = TL.mla_decode_batch(
            _torch(mp), torch.from_numpy(xc), tcache, tc,
            pos=torch.from_numpy(pos).long(), valid=torch.from_numpy(valid),
            lora=_torch(lora), lora_scale=0.5,
            lora_idx=None if lidx is None else torch.from_numpy(lidx).long(),
            lora_kernel=kernel)
        _close(ty[valid], np.asarray(jy)[valid], STATE_TOL)
        for k in cache:
            _close(tcache[k], jcache[k], STATE_TOL)
            np.testing.assert_array_equal(tcache[k][2, 12:].numpy(),
                                          cache[k][2, 12:])


# ---------------------------------------------------------------------------
# the stacks: forward, loss, decode_step, decode_chunk, greedy generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_loss_match_reference(variant):
    """Logits and the MoE aux of ``forward`` with an adapter, then
    ``loss_fn`` (loss + aux) and its LoRA gradients."""
    jc, tc, tree, port = _world(variant)
    lora = _lora(jc, 8, 7, scale=0.1)
    rng = np.random.default_rng(8)
    B, S = 2, 40
    toks = rng.integers(0, jc.vocab_size, (B, S))
    jl, jaux = jax.jit(lambda p, t, lo: JT.forward(jc, p, t, lora=lo,
                                                   lora_scale=2.0))(
        _jax(tree), jnp.asarray(toks), _jax(lora))
    tl, taux = TT.forward(tc, port, torch.from_numpy(toks), lora=_torch(lora),
                          lora_scale=2.0)
    _close(tl, jl, LOGIT_TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    assert (float(jaux) > 0) == (jc.moe is not None)
    batch = {"tokens": toks, "labels": rng.integers(0, jc.vocab_size, (B, S)),
             "loss_mask": (rng.random((B, S)) < 0.6).astype(np.float32)}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda lo, p, b: JT.loss_fn(jc, p, lo, b, 2.0),
        has_aux=True))(_jax(lora), _jax(tree), _jax(batch))
    tloss, tm, tg = TS.loss_and_grad(tc, port, _torch(lora), _torch(batch),
                                     2.0)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]), atol=1e-6)
    for n, e in jax.device_get(jg).items():
        for p in ("A", "B"):
            np.testing.assert_allclose(tg[n][p].numpy(), e[p], atol=1e-5,
                                       rtol=1e-4)
