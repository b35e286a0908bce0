"""Mamba-2 at mamba2-130m's published widths (d_model 768, 24 SSD heads of
64, state 128, chunk 256; cut to 2 layers) in f32 under a strong adapter
(LoRA scale 2.0, rank 64, B ≠ 0), over a prompt longer than one SSD chunk,
against the JAX package on the CPU.

At this scale the adapter drives dt·A to hundreds over a chunk, and the
SSD's segment sums lose digits when they are taken as differences of two
cumulative sums, as the reference's ``_segsum`` takes them.  The port sums
each segment on its own, so its forward stays within the repo's logit
tolerance (atol 1e-4) of the reference's forward and of its own streamed
decode, and its decode within it of the reference's decode, position by
position."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SCALE, RANK, S = 2.0, 64, 264
LOGIT_ATOL = 1e-4


def _cut(cfg):
    return dataclasses.replace(cfg, num_layers=2, dtype="float32")


def test_segsum_sums_each_segment():
    """The decays exp(segment sum) of a chunk of large dt·A (its cumulative
    sum reaches about -600) against exact f64 ones: the port's within
    1e-7, the reference's differences of cumulative sums beyond 1e-5."""
    rng = np.random.default_rng(0)
    x = -rng.uniform(0.5, 4.0, (3, 256)).astype(np.float32)
    exact = np.cumsum(x.astype(np.float64), -1)
    exact = np.exp(exact[:, :, None] - exact[:, None, :])
    low = np.tril(np.ones((256, 256), bool))
    port = TL._segsum(torch.from_numpy(x)).numpy()
    ref = np.asarray(JL._segsum(jnp.asarray(x)))
    assert np.isneginf(port[:, ~low]).all()

    def err(seg):
        return np.abs(np.exp(seg.astype(np.float64)) - exact)[:, low].max()

    print(f"decay error: port {err(port):.3e}, reference {err(ref):.3e}")
    assert err(port) <= 1e-7 and err(ref) > 1e-5, (err(port), err(ref))


def test_decode_and_forward_match_reference_at_scale_two():
    jc, tc = _cut(get_config("mamba2-130m")), _cut(t_config("mamba2-130m"))
    assert (tc.d_model, tc.ssm.chunk_size) == (768, 256) and S > 256
    tree = jax.device_get(jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jc))
    port = params_from_numpy(tc, tree, device="cpu")
    rng = np.random.default_rng(7)
    lora = {s.name: {
        "A": (rng.standard_normal((s.num_layers, RANK, s.in_dim))
              * s.in_dim ** -0.5).astype(np.float32),
        "B": (rng.standard_normal((s.num_layers, s.out_dim, RANK))
              * RANK ** -0.5).astype(np.float32)} for s in JT.lora_specs(jc)}
    toks = np.random.default_rng(8).integers(0, jc.vocab_size, (1, S))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = {n: {m: torch.from_numpy(e[m]) for m in e} for n, e in lora.items()}

    jf, _ = jax.jit(lambda t: JT.forward(jc, jp, t, lora=jl,
                                         lora_scale=SCALE))(jnp.asarray(toks))
    jf = np.asarray(jf)
    with torch.no_grad():
        tf, _ = TT.forward(tc, port, torch.from_numpy(toks), lora=tl,
                           lora_scale=SCALE)
    tf = tf.numpy()
    fwd = np.abs(tf - jf).max()

    def stream(cache, inp):
        tok, t = inp
        logits, cache = JT.decode_step(jc, jp, cache, tok, t, lora=jl,
                                       lora_scale=SCALE)
        return cache, logits

    _, jd = jax.jit(lambda c, x: jax.lax.scan(stream, c, x))(
        JT.init_cache(jc, jp, 1, S),
        (jnp.asarray(toks.T), jnp.arange(S)))              # one dispatch
    jd = np.asarray(jd)                                     # [S, 1, V]
    tcache = TT.init_cache(tc, port, 1, S)
    vs_ref = vs_fwd = 0.0
    for t in range(S):
        with torch.no_grad():
            td, tcache = TT.decode_step(tc, port, tcache,
                                        torch.from_numpy(toks[:, t]), t,
                                        lora=tl, lora_scale=SCALE)
        td = td.numpy()
        vs_ref = max(vs_ref, np.abs(td - jd[t]).max())
        vs_fwd = max(vs_fwd, np.abs(td - tf[:, t]).max())
    print(f"forward vs reference {fwd:.3e}, decode vs reference "
          f"{vs_ref:.3e}, decode vs forward {vs_fwd:.3e}")
    assert fwd <= LOGIT_ATOL, fwd
    assert vs_ref <= LOGIT_ATOL, vs_ref
    assert vs_fwd <= LOGIT_ATOL, vs_fwd
