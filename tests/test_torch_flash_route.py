"""The flash wrapper's route (``repro_torch.kernels.flash.flash_route``) and
the error model of its tensor-core route, on the CPU.

The ``wgmma`` route rounds each probability to bf16 before P·V while the
row sum l stays f32, so an output may move, beside the one rounding of the
result (2^-7 of its magnitude), by up to 2^-9 Σ_j p_j |v_j| / l.  The card
holds the route to ``1e-4 + 2^-7·|plain| + 2^-8·plain(q, k, |v|)``; here
that bound is held by the route's arithmetic written out in PyTorch
(online softmax over 64-key tiles in the log2 domain, P rounded to bf16)
against the JAX package's f32 oracle on the same bf16 inputs.

bf16 q, k, v whose bases are not 16-byte aligned (contiguous views at an
odd element offset) take the ``"simt"`` route, whose arithmetic (f32
online softmax, the output rounded to bf16 once) is held against the JAX
package's ``ops.flash_attention`` in Pallas interpret mode."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

P_BF16_RTOL, BF16_RTOL, ATOL = 2.0 ** -8, 2.0 ** -7, 1e-4


def _widths(cfg):
    """(d, dv) of the config's attention: MLA's q·k width and value width,
    or the head width."""
    if cfg.mla is not None:
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_takes_the_tensor_core_route_in_bf16(arch):
    cfg = get_config(arch)
    d, dv = _widths(cfg)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    assert FA.flash_route(torch.bfloat16, 2, 2048, 2048, H, KV, d,
                          dv, True) == "wgmma"
    assert FA.flash_route(torch.float32, 2, 2048, 2048, H, KV, d,
                          dv, True) == "simt"
    # a base TMA refuses (a view at an odd element offset)
    assert FA.flash_route(torch.bfloat16, 2, 2048, 2048, H, KV, d,
                          dv, False) == "simt"


def test_config_widths_are_the_instances_checked_on_the_card():
    assert {_widths(get_config(a)) for a in ARCHS} == {
        (32, 32), (64, 64), (128, 128), (256, 256), (192, 128)}


@pytest.mark.parametrize("dims", [
    (1, 200, 200, 1, 1, 36, 36),     # head stride 72 bytes
    (2, 64, 64, 4, 2, 36, 36),       # H·d·2 = 288 bytes, but d·2 = 72
    (1, 64, 64, 2, 1, 64, 100),      # dv·2 = 200 bytes
    (1, 64, 64, 2, 1, 12, 64),       # d·2 = 24 bytes
    (1, 64, 0, 2, 1, 64, 64),        # no keys: TMA takes no empty dimension
], ids=["d36", "d36_heads", "dv100", "d12", "no_keys"])
def test_bf16_strides_tma_refuses_take_the_simt_route(dims):
    assert FA.flash_route(torch.bfloat16, *dims, True) == "simt"


def test_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(5)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in [(1, 16, 2, 8), (1, 16, 1, 8),
                                     (1, 16, 1, 8)]]
    FA.launches_by_route["wgmma"] = 3
    FA.reset_launches()
    assert FA.launches_by_route == {"wgmma": 0, "simt": 0}
    tops.flash_attention(q, k, v)
    assert FA.launches == 0
    assert FA.launches_by_route == {"wgmma": 0, "simt": 0}


def _oracle(q, k, v, *, causal, window):
    """The JAX oracle in f32 in the ops layout: KV heads repeated, heads
    folded into the batch."""
    B, Sq, H, _ = q.shape
    dv, rep = v.shape[3], H // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)

    def fold(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(B * H, -1,
                                                           t.shape[3]))

    out = jref.flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                                   window=window)
    return np.asarray(out).reshape(B, H, Sq, dv).transpose(0, 2, 1, 3)


def _tensor_core_route(q, k, v, *, causal, window, tile=64):
    """The wgmma route's arithmetic: scores in f32 scaled into the log2
    domain, an online softmax over key tiles, each probability rounded to
    bf16 before P·V, l summed in f32, rows with no valid key averaging every
    value, the output divided by max(l, 1e-30) and cast to bf16 once."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) * (math.log2(math.e) / math.sqrt(d))
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    s = s.masked_fill(~ok, -math.inf)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, vf.shape[-1])
    for k0 in range(0, Sk, tile):
        st = s[..., k0:k0 + tile]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp2(m - mn)
        p = torch.exp2(st - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vf[..., k0:k0 + tile, :]
        m = mn
    keyless = l == 0
    acc = torch.where(keyless, vf.mean(-2, keepdim=True), acc)
    l = torch.where(keyless, torch.ones_like(l), l)
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("dims,causal,window", [
    ((1, 256, 256, 14, 2, 64, 64), True, 0),      # qwen2-0.5b's GQA heads
    ((1, 300, 260, 6, 3, 72, 72), False, 0),      # d = 72, padded to 80
    ((1, 200, 150, 4, 2, 72, 72), True, 40),      # window, keyless rows
], ids=["qwen2_gqa", "d72_noncausal", "d72_window_keyless"])
def test_bf16_probabilities_stay_inside_the_card_limit(dims, causal, window):
    B, Sq, Sk, H, KV, d, dv = dims
    rng = np.random.default_rng(11)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in [(B, Sq, H, d), (B, Sk, KV, d),
                                     (B, Sk, KV, dv)]]
    qn, kn, vn = (t.float().numpy() for t in (q, k, v))
    ref = _oracle(qn, kn, vn, causal=causal, window=window)
    p_abs = _oracle(qn, kn, np.abs(vn), causal=causal, window=window)
    got = _tensor_core_route(q, k, v, causal=causal,
                             window=window).float().numpy()
    err = np.abs(got - ref)
    assert (err <= ATOL + BF16_RTOL * np.abs(ref) + P_BF16_RTOL * p_abs).all()
    # the port's plain version (the CPU route) keeps the old limit
    plain = tops.flash_attention(q, k, v, causal=causal,
                                 window=window).float().numpy()
    assert (np.abs(plain - ref) <= ATOL + BF16_RTOL * np.abs(ref)).all()


def _offset_view(t, offset):
    """t's values in a contiguous view ``offset`` elements into a buffer."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def test_alignment_predicate_sees_a_view_at_an_odd_element_offset():
    q = torch.ones(1, 64, 2, 64, dtype=torch.bfloat16)
    assert kbuild.aligned16(q)
    view = _offset_view(q, 1)
    assert view.is_contiguous() and torch.equal(view, q)
    assert not kbuild.aligned16(view)
    assert not kbuild.aligned16(q, q, view)


def _simt_route(q, k, v, *, causal, window, tile=32):
    """The simt route's arithmetic: f32 scores scaled by 1/sqrt(d), an
    online softmax (exp, no rounding of P) over 32-key tiles, rows with no
    valid key averaging every value, the output divided by max(l, 1e-30)
    and cast to q's dtype once."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) * (1.0 / math.sqrt(d))
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    s = s.masked_fill(~ok, -math.inf)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, vf.shape[-1])
    for k0 in range(0, Sk, tile):
        st = s[..., k0:k0 + tile]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - mn)
        p = torch.exp(st - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vf[..., k0:k0 + tile, :]
        m = mn
    keyless = l == 0
    acc = torch.where(keyless, vf.mean(-2, keepdim=True), acc)
    l = torch.where(keyless, torch.ones_like(l), l)
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def test_unaligned_bf16_views_take_simt_and_match_pallas():
    """bf16 q, k, v at element offset 1 (GQA, causal): the wrapper's
    predicate is False, the route is simt, and that route's arithmetic and
    the CPU entry agree with the reference's Pallas kernel within
    ``1e-4 + 2^-7·|plain|``."""
    B, Sq, Sk, H, KV, d, dv = 1, 128, 128, 4, 2, 64, 64
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in [(B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, dv)]]
    views = [_offset_view(torch.from_numpy(a).bfloat16(), 1) for a in arrs]
    assert not kbuild.aligned16(*views)
    assert FA.flash_route(torch.bfloat16, B, Sq, Sk, H, KV, d, dv,
                          kbuild.aligned16(*views)) == "simt"
    pallas = np.asarray(jops.flash_attention(
        *[jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs], causal=True,
        bq=64, bk=64, interpret=True), np.float32)
    lim = ATOL + BF16_RTOL * np.abs(pallas)
    got = _simt_route(*views, causal=True, window=0)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - pallas) <= lim).all()
    cpu = tops.flash_attention(*views, causal=True)
    assert (np.abs(cpu.float().numpy() - pallas) <= lim).all()
