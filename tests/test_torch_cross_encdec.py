"""The cross-attention VLM (llama-3.2-vision-11b) and encoder-decoder
(seamless-m4t-medium) stacks of the port against the JAX package on the
CPU, at their reduced configs.  Weights cross through
``repro_torch.interop`` with every vision gate opened to 0.5 (the
reference's zero gate, tanh(0) = 0, would hide the cross path); inputs come
from numpy seeds; the adapter has random A and B on every site.

Tolerances, f32: logits atol 1e-4, ``loss_fn`` 1e-5, LoRA gradients atol
1e-5 + rtol 1e-4, decode against forward 2e-4 (the reference's own limit
in ``tests/test_decode.py``).

The reference's decode cache leaves out the adapter on the keys' and
values' source: its ``init_cache`` builds the cross K/V without
``cross.wv`` / ``dec_cross.wv`` and encodes the audio without ``enc.*``.
The port applies them, so its decode equals the reference's forward with
every adapter, and equals the reference's decode once those entries are
removed; the reference's own decode with them differs from its forward
by more than 1e-2."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.interop import lora_from_numpy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

FAMS = ["llama-3.2-vision-11b", "seamless-m4t-medium"]
B, S = 2, 12
GATE = 0.5
LOGIT_TOL = dict(atol=1e-4, rtol=0)
DECODE_ATOL = 2e-4
# the adapter entries whose source the reference's decode cache leaves out
KV_SOURCE = (".cross.wv", ".dec_cross.wv", "enc.")


def _open_gates(tree):
    for sp in tree["blocks"].values():
        if "cross" in sp:
            sp["cross"]["gate"] = np.full_like(sp["cross"]["gate"], GATE)
    return tree


def _world(name, seed=0):
    jc, tc = get_reduced_config(name), t_reduced(name)
    tree = _open_gates(jax.device_get(jax.jit(
        JT.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jc)))
    return jc, tc, tree, params_from_numpy(tc, tree, device="cpu")


def _lora(cfg, seed, r=4, scale=0.2):
    rng = np.random.default_rng(seed)
    return {s.name: {
        "A": (scale * rng.standard_normal((s.num_layers, r, s.in_dim))
              ).astype(np.float32),
        "B": (scale * rng.standard_normal((s.num_layers, s.out_dim, r))
              ).astype(np.float32)} for s in JT.lora_specs(cfg)}


def _inputs(cfg, seed):
    """(tokens [B, S], {"vision" | "audio": [B, P, dim]}) from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab_size, (B, S))
    if cfg.family == "vlm":
        extra = {"vision": rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.vision_dim)).astype(np.float32)}
    else:
        extra = {"audio": rng.standard_normal(
            (B, max(S // 4, 8), cfg.audio_dim)).astype(np.float32)}
    return toks, extra


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _batch(cfg, seed):
    toks, extra = _inputs(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": toks,
             "labels": rng.integers(0, cfg.vocab_size, (B, S)),
             "loss_mask": (rng.random((B, S)) < 0.7).astype(np.float32)}
    if cfg.family == "vlm":
        # the second row's image is missing: its cross K/V are zero
        batch["image"] = extra["vision"]
        batch["image_mask"] = np.array([1.0, 0.0], np.float32)
    else:
        batch["audio"] = extra["audio"]
    return batch


@pytest.mark.parametrize("name", FAMS)
def test_params_and_specs_match_reference(name):
    """The port's own init draws the reference's tree (every leaf's path,
    shape and dtype, in f32 and bf16: the gate, ``lnx``, ``dec_cross``,
    the encoder); the reference's weights and an adapter with ``enc.*``
    entries cross through ``interop`` bit for bit and back."""
    jc, tc, tree, port = _world(name)
    assert [(s.name, s.in_dim, s.out_dim, s.num_layers)
            for s in TT.lora_specs(tc)] == [
        (s.name, s.in_dim, s.out_dim, s.num_layers)
        for s in JT.lora_specs(jc)]
    for dt in ("float32", "bfloat16"):
        jshapes = jax.eval_shape(lambda: JT.init_params(
            jax.random.PRNGKey(0), dataclasses.replace(jc, dtype=dt)))
        mine = TT.init_params(dataclasses.replace(tc, dtype=dt), device="cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
        assert [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
                for p, x in flat_j] == [
            (jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", "")) for p, x in flat_t]
    back = jax.tree_util.tree_map(lambda t: t.numpy(), port)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    lora = _lora(jc, 1)
    tl = lora_from_numpy(lora, device="cpu")
    assert any(n.startswith("enc.") for n in tl) == (jc.family == "encdec")
    for n, e in lora.items():
        for m in ("A", "B"):
            np.testing.assert_array_equal(tl[n][m].numpy(), e[m])


@pytest.mark.parametrize("name", FAMS)
def test_forward_loss_and_grads_match_reference(name):
    jc, tc, tree, port = _world(name)
    lora = _lora(jc, 2)
    toks, extra = _inputs(jc, 3)
    jf, _ = jax.jit(lambda p, l: JT.forward(
        jc, p, jnp.asarray(toks), lora=l, lora_scale=2.0,
        **_jax(extra)))(_jax(tree), _jax(lora))
    with torch.no_grad():
        tf, _ = TT.forward(tc, port, torch.from_numpy(toks),
                           lora=_torch(lora), lora_scale=2.0,
                           **_torch(extra))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **LOGIT_TOL)

    batch = _batch(jc, 4)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda l: JT.loss_fn(jc, _jax(tree), l, _jax(batch), 2.0),
        has_aux=True))(_jax(lora))
    tl, tm, tg = TS.loss_and_grad(tc, port, _torch(lora), _torch(batch), 2.0)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]), atol=1e-6)
    jg = jax.device_get(jg)
    assert set(tg) == set(jg)
    for n in jg:
        for m in ("A", "B"):
            assert np.abs(jg[n][m]).max() > 0, (n, m)     # every site learns
            np.testing.assert_allclose(tg[n][m].numpy(), jg[n][m],
                                       atol=1e-5, rtol=1e-4, err_msg=n + m)


def _port_decode(tc, port, toks, extra, lora):
    """The port's decode_step streamed over the prompt: logits [S, B, V]."""
    tl = _torch(lora)
    kw = {k: torch.from_numpy(v) for k, v in extra.items()}
    cache = TT.init_cache(tc, port, B, S, lora=tl, lora_scale=2.0, **kw)
    out = []
    with torch.no_grad():
        for t in range(S):
            lg, cache = TT.decode_step(tc, port, cache,
                                       torch.from_numpy(toks[:, t]), t,
                                       lora=tl, lora_scale=2.0)
            out.append(lg.numpy())
    return np.stack(out), cache


def _ref_decode(jc, tree, toks, extra, lora):
    """The reference's init_cache and decode_step in one jitted scan."""
    p = _jax(tree)

    def run(l, ex):
        cache = JT.init_cache(jc, p, B, S, **ex)

        def step(c, inp):
            tok, t = inp
            lg, c = JT.decode_step(jc, p, c, tok, t, lora=l, lora_scale=2.0)
            return c, lg

        cache, lgs = jax.lax.scan(step, cache, (jnp.asarray(toks.T),
                                                jnp.arange(S)))
        return lgs, cache

    lgs, cache = jax.jit(run)(_jax(lora), _jax(extra))
    return np.asarray(lgs), jax.device_get(cache)


@pytest.mark.parametrize("name", FAMS)
def test_decode_equals_reference_forward_with_every_adapter(name):
    jc, tc, tree, port = _world(name)
    lora = _lora(jc, 5)
    toks, extra = _inputs(jc, 6)
    jf, _ = jax.jit(lambda p, l: JT.forward(
        jc, p, jnp.asarray(toks), lora=l, lora_scale=2.0,
        **_jax(extra)))(_jax(tree), _jax(lora))
    got, _ = _port_decode(tc, port, toks, extra, lora)
    err = np.abs(got - np.asarray(jf).swapaxes(0, 1)).max()
    assert err < DECODE_ATOL, err


@pytest.mark.parametrize("name", FAMS)
def test_decode_matches_reference_decode_without_kv_source_adapters(name):
    """With the entries the reference's cache drops removed, both
    packages' decode_step agree position by position, and so do their
    caches (the static cross K/V included)."""
    jc, tc, tree, port = _world(name)
    lora = {n: e for n, e in _lora(jc, 7).items()
            if not any(k in n for k in KV_SOURCE)}
    toks, extra = _inputs(jc, 8)
    jd, jcache = _ref_decode(jc, tree, toks, extra, lora)
    got, tcache = _port_decode(tc, port, toks, extra, lora)
    assert np.abs(got - jd).max() < DECODE_ATOL
    assert set(tcache) == set(jcache)
    for k, entry in jcache.items():
        for p, v in entry.items():
            np.testing.assert_allclose(tcache[k][p].numpy(), v, atol=1e-5,
                                       rtol=0, err_msg=k + p)


@pytest.mark.parametrize("name", FAMS)
def test_reference_decode_drops_the_kv_source_adapters(name):
    """Why the port departs: with every adapter, the reference's decode
    parts from its own forward by more than 1e-2."""
    jc, tc, tree, port = _world(name)
    lora = _lora(jc, 5)
    toks, extra = _inputs(jc, 6)
    jf, _ = jax.jit(lambda p, l: JT.forward(
        jc, p, jnp.asarray(toks), lora=l, lora_scale=2.0,
        **_jax(extra)))(_jax(tree), _jax(lora))
    jd, _ = _ref_decode(jc, tree, toks, extra, lora)
    assert np.abs(jd - np.asarray(jf).swapaxes(0, 1)).max() > 1e-2


@pytest.mark.parametrize("name", FAMS)
def test_decode_chunk_with_a_bank_raises_like_reference(name):
    """One adapter serves both families' decode; a bank (a per-row
    adapter index) raises in both packages with the same message."""
    jc, tc, tree, port = _world(name)
    toks, extra = _inputs(jc, 9)
    G = 2
    bank = {n: {m: np.repeat(e[m][:, None], G, 1) for m in ("A", "B")}
            for n, e in _lora(jc, 10).items() if n.startswith("s")}
    emb = np.zeros((B, 1, jc.d_model), np.float32)
    idx = np.zeros((B,), np.int32)
    jcache = JT.init_cache(jc, _jax(tree), B, S, **_jax(extra))
    tcache = TT.init_cache(tc, port, B, S, **_torch(extra))
    errs = []
    for fn, cache, arr in [(JT.decode_chunk, jcache, jnp.asarray),
                           (TT.decode_chunk, tcache,
                            lambda a: torch.from_numpy(a).long()
                            if a.dtype == np.int32 else torch.from_numpy(a))]:
        params = _jax(tree) if fn is JT.decode_chunk else port
        b = _jax(bank) if fn is JT.decode_chunk else _torch(bank)
        with pytest.raises(NotImplementedError) as e:
            fn(jc if fn is JT.decode_chunk else tc, params, cache, arr(emb),
               arr(idx), adapters=b, adapter_idx=arr(idx))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_cross_attention_chunked_and_masked_match_reference():
    """The gated cross sublayer over 2100 vision tokens (Sk > 2048: the
    online-softmax path in both packages) with masked keys, and over an
    all-zero source (a missing image: zero K and V, uniform attention,
    finite), against the reference's ``attention_forward``."""
    jc, tc, tree, port = _world("llama-3.2-vision-11b")
    rng = np.random.default_rng(13)
    lora = {n[len("s1.cross."):]: {m: e[m][0] for m in ("A", "B")}
            for n, e in _lora(jc, 14).items() if n.startswith("s1.cross.")}
    x = rng.standard_normal((B, 5, jc.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 2100, jc.vision_dim)).astype(np.float32)
    mask = rng.random((B, 2100)) < 0.8
    bp = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["s1"]["cross"])
    for kv, pm in ((src, mask), (np.zeros_like(src[:, :16]), None)):
        want = jax.jit(lambda x_, s_, m_: JL.attention_forward(
            _jax(bp), x_, jc, kind="cross_attn", lora=_jax(lora),
            lora_scale=2.0, kv_src=s_, pad_mask=m_))(
            jnp.asarray(x), jnp.asarray(kv),
            None if pm is None else jnp.asarray(pm))
        with torch.no_grad():
            got = TL.attention_forward(
                _torch(bp), torch.from_numpy(x), tc, kind="cross_attn",
                lora=_torch(lora), lora_scale=2.0,
                kv_src=torch.from_numpy(kv),
                pad_mask=None if pm is None else torch.from_numpy(pm))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_greedy_generate_equals_uncached_reference_tokens():
    """The cross VLM's KV-cached greedy generation (the text prompt
    prefilled in one chunk, the vision K/V built with the adapter) against
    the reference's uncached argmax loop over full forwards."""
    name = "llama-3.2-vision-11b"
    jc, tc, tree, port = _world(name)
    lora = _lora(jc, 11)
    toks, extra = _inputs(jc, 12)
    cap_start, gen_len = 3, 6
    gen = TS.make_greedy_generate(tc, lora_scale=2.0, cap_start=cap_start,
                                  gen_len=gen_len)
    got = gen(port, _torch(lora), torch.from_numpy(toks[:, :cap_start + 1]),
              torch.from_numpy(extra["vision"])).numpy()
    fwd = jax.jit(lambda t: JT.forward(jc, _jax(tree), t, lora=_jax(lora),
                                       lora_scale=2.0,
                                       vision=jnp.asarray(extra["vision"]))[0])
    cur = toks.copy()
    cur[:, cap_start + 1:] = 0
    want = []
    for t in range(gen_len):
        nxt = np.asarray(fwd(jnp.asarray(cur)))[:, cap_start + t].argmax(-1)
        want.append(nxt)
        if cap_start + 1 + t < S:
            cur[:, cap_start + 1 + t] = nxt
    np.testing.assert_array_equal(got, np.stack(want, 1))
