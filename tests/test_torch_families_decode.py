"""The port's decode paths on the Mamba-2, hybrid Jamba, MoE and MLA stacks
(mamba2-130m, jamba-v0.1-52b, deepseek-v2-236b with and without a q-side
down-projection, llama4-scout-17b-a16e; reduced configs) against the JAX
package on the CPU: ``decode_step`` streamed with one adapter,
``decode_chunk`` over a bank through both grouped paths, greedy generation,
and decode ≡ forward inside the port.  Helpers and tolerances are
``test_torch_families.py``'s: logits atol 1e-4, caches atol 1e-5 (after
ten streamed steps 1e-4 of their size more), greedy tokens equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_families import (LOGIT_TOL, STATE_TOL,  # noqa: E402
                                 STREAMED_TOL, VARIANTS, _capacity, _cfgs,
                                 _close, _jax, _lora, _torch, _world)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_streams_like_reference(variant):
    """The port's decode_step against the reference's, one adapter for the
    batch (folded into Mamba's projections, as the reference's
    decode_step folds it), position by position; then the caches."""
    jc, tc, tree, port = _world(variant)
    lora = _lora(jc, 8, 9)
    toks = np.random.default_rng(10).integers(0, jc.vocab_size, (2, 10))
    jcache = JT.init_cache(jc, _jax(tree), 2, 10)
    tcache = TT.init_cache(tc, port, 2, 10)
    step = jax.jit(lambda c, t, p: JT.decode_step(
        jc, _jax(tree), c, t, p, lora=_jax(lora), lora_scale=2.0))
    for t in range(toks.shape[1]):
        jl, jcache = step(jcache, jnp.asarray(toks[:, t]), t)
        tl, tcache = TT.decode_step(tc, port, tcache,
                                    torch.from_numpy(toks[:, t]), t,
                                    lora=_torch(lora), lora_scale=2.0)
        _close(tl, jl, LOGIT_TOL)
    for k, entry in jax.device_get(jcache).items():
        assert set(entry) == set(tcache[k])
        for p, v in entry.items():
            assert tcache[k][p].dtype == (torch.float32 if v.dtype
                                          == np.float32 else torch.bfloat16)
            _close(tcache[k][p], v, STREAMED_TOL)


def test_decode_step_folds_the_adapter_on_mamba():
    """With one adapter, the reference's decode_chunk leaves Mamba layers
    unadapted (``mamba_decode`` applies LoRA only in the banked form); the
    port's decode_chunk folds it, so its decode_step equals the reference's
    decode_step and differs from the reference's decode_chunk."""
    jc, tc, tree, port = _world("mamba2")
    lora = _lora(jc, 8, 11)
    emb = np.random.default_rng(12).standard_normal(
        (2, 1, jc.d_model)).astype(np.float32)
    pos = np.zeros((2,), np.int32)
    jstep, _ = JT.decode_step(jc, _jax(tree), JT.init_cache(jc, None, 2, 4),
                              None, 0, lora=_jax(lora), lora_scale=2.0,
                              embeds=jnp.asarray(emb))
    jchunk, _ = JT.decode_chunk(jc, _jax(tree), JT.init_cache(jc, None, 2, 4),
                                jnp.asarray(emb), jnp.asarray(pos),
                                adapters=_jax(lora), lora_scale=2.0)
    tl, _ = TT.decode_chunk(tc, port, TT.init_cache(tc, port, 2, 4),
                            torch.from_numpy(emb),
                            torch.from_numpy(pos).long(),
                            adapters=_torch(lora), lora_scale=2.0)
    _close(tl, jstep, LOGIT_TOL)
    assert np.abs(np.asarray(jstep) - np.asarray(jchunk)).max() > 1e-2


def _random_cache(cfg, B, max_len, seed):
    rng = np.random.default_rng(seed)
    proto = jax.device_get(JT.init_cache(cfg, None, B, max_len))
    return {k: {p: rng.standard_normal(x.shape).astype(np.float32)
                for p, x in v.items()} for k, v in proto.items()}


@pytest.mark.parametrize("lora_kernel", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_chunk_matches_reference(variant, lora_kernel):
    """The banked serving path: C = 1 at ragged per-row positions over a
    random cache; C = 4 with a ragged valid mask where the stack has no
    Mamba layer (there both packages refuse it, naming mamba)."""
    jc, tc, tree, port = _world(variant, seed=1)
    B, G, max_len = 3, 4, 16
    bank = _lora(jc, 8, 13, lead=(G,))
    cache = _random_cache(jc, B, max_len, 14)
    rng = np.random.default_rng(15)
    idx = np.array([2, 0, 2], np.int32)
    kw = dict(lora_scale=0.5, lora_kernel=lora_kernel)
    pos = np.array([3, 9, 14], np.int32)
    emb = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    jchunk = jax.jit(lambda p, c, e, ps, b, i, v, lg: JT.decode_chunk(
        jc, p, c, e, ps, adapters=b, adapter_idx=i, valid=v, logits=lg,
        **kw), static_argnums=7)
    jl, jcache = jchunk(_jax(tree), _jax(cache), jnp.asarray(emb),
                        jnp.asarray(pos), _jax(bank), jnp.asarray(idx), None,
                        True)
    tcache = _torch(cache)
    tl, _ = TT.decode_chunk(tc, port, tcache, torch.from_numpy(emb),
                            torch.from_numpy(pos).long(),
                            adapters=_torch(bank),
                            adapter_idx=torch.from_numpy(idx).long(), **kw)
    _close(tl, jl, LOGIT_TOL)
    for k, entry in jax.device_get(jcache).items():
        for p, v in entry.items():
            _close(tcache[k][p], v, STATE_TOL)

    C = 4
    pos = np.array([0, 5, 11], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], bool)
    emb = rng.standard_normal((B, C, jc.d_model)).astype(np.float32)
    args = dict(logits=False, **kw)
    if "mamba" in jc.pattern:
        for fn, cf, ca in [(JT.decode_chunk, jc, _jax), (TT.decode_chunk, tc,
                                                          _torch)]:
            with pytest.raises(NotImplementedError, match="mamba"):
                fn(cf, ca(tree) if ca is _jax else port, ca(cache),
                   ca(emb), ca(pos), adapters=ca(bank), adapter_idx=ca(idx),
                   valid=ca(valid), **args)
        return
    _, jcache = jchunk(_jax(tree), _jax(cache), jnp.asarray(emb),
                       jnp.asarray(pos), _jax(bank), jnp.asarray(idx),
                       jnp.asarray(valid), False)
    tcache = _torch(cache)
    out, _ = TT.decode_chunk(tc, port, tcache, torch.from_numpy(emb),
                             torch.from_numpy(pos).long(),
                             adapters=_torch(bank),
                             adapter_idx=torch.from_numpy(idx).long(),
                             valid=torch.from_numpy(valid), **args)
    assert out is None
    for k, entry in jax.device_get(jcache).items():
        for p, v in entry.items():
            _close(tcache[k][p], v, STATE_TOL)
            np.testing.assert_array_equal(tcache[k][p][:, 2, 12:].numpy(),
                                          cache[k][p][:, 2, 12:])


@pytest.mark.parametrize("variant", ["mamba2", "jamba", "llama4"])
def test_greedy_generate_streams_like_reference(variant):
    """make_greedy_generate streams the prompt through decode_step where a
    stack holds a Mamba layer or an MoE layer, as the reference does:
    tokens equal."""
    jc, tc, tree, port = _world(variant, seed=2)
    lora = _lora(jc, 8, 16, scale=0.3)
    toks = np.random.default_rng(17).integers(0, jc.vocab_size, (3, 12))
    kw = dict(lora_scale=2.0, cap_start=5, gen_len=6)
    jt = jax.jit(JS.make_greedy_generate(jc, **kw))(
        _jax(tree), _jax(lora), jnp.asarray(toks))
    tt = TS.make_greedy_generate(tc, **kw)(port, _torch(lora),
                                           torch.from_numpy(toks))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_matches_forward_in_the_port():
    """decode ≡ prefill inside the port, as the reference's
    ``tests/test_decode.py`` holds it (capacity factor 8, so no token is
    dropped either way), with an adapter: streamed logits against
    ``forward`` at every position, over more than one SSD chunk."""
    for variant in ("mamba2", "jamba", "deepseek"):
        _, tc = _cfgs(variant, None if variant == "mamba2"
                      else _capacity(8.0))
        port = TT.init_params(tc, seed=4, device="cpu")
        lora = _torch(_lora(get_reduced_config(VARIANTS[variant][0]), 8, 18,
                            scale=0.1))
        toks = torch.from_numpy(np.random.default_rng(19).integers(
            0, tc.vocab_size, (2, 40)))
        full, _ = TT.forward(tc, port, toks, lora=lora, lora_scale=2.0)
        cache = TT.init_cache(tc, port, 2, 40)
        for t in range(toks.shape[1]):
            lg, cache = TT.decode_step(tc, port, cache, toks[:, t], t,
                                       lora=lora, lora_scale=2.0)
            _close(lg, full[:, t].detach(), LOGIT_TOL)
