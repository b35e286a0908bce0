"""The flash wrapper's route (``repro_torch.kernels.flash.flash_route``) and
the error model of its tensor-core route, on the CPU.

The ``wgmma`` route rounds each probability to bf16 before P·V while the
row sum l stays f32, so an output may move, beside the one rounding of the
result (2^-7 of its magnitude), by up to 2^-9 Σ_j p_j |v_j| / l.  The card
holds the route to ``1e-4 + 2^-7·|plain| + 2^-8·plain(q, k, |v|)``; here
that bound is held by the route's arithmetic written out in PyTorch
(online softmax over 64-key tiles in the log2 domain, P rounded to bf16)
against the JAX package's f32 oracle on the same bf16 inputs.

f32 q, k, v, and bf16 whose strides or bases TMA refuses (head widths that
are not multiples of 8, contiguous views at an odd element offset), take
the ``"tf32x3"`` route: every f32 operand split into ``big = tf32(v)`` and
``small = v - big`` (the helpers of ``tests/test_torch_lora_route.py``),
Q·Kᵀ and P·V each as three TF32 products with f32 sums started from zero
every key tile, the probabilities split and not rounded.  That arithmetic,
written out at the kernel's key tile, is held against the JAX package's
Pallas kernel in interpret mode and its f32 oracle within half the card's
f32 limit (5e-5 on the result before its cast, for f32 and bf16 inputs
alike), and its bf16 output, rounded once, within the card's bf16
limit."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from test_torch_lora_route import _split, _tf32  # noqa: E402

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
                          dv, True) == "tf32x3"
    # a base TMA refuses (a view at an odd element offset)
    assert FA.flash_route(torch.bfloat16, 2, 2048, 2048, H, KV, d,
                          dv, False) == "tf32x3"


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
    assert FA.flash_route(torch.bfloat16, *dims, True) == "tf32x3"


def test_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(5)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in [(1, 16, 2, 8), (1, 16, 1, 8),
                                     (1, 16, 1, 8)]]
    FA.launches_by_route["wgmma"] = 3
    FA.reset_launches()
    assert FA.launches_by_route == {"wgmma": 0, "tf32x3": 0}
    tops.flash_attention(q, k, v)
    assert FA.launches == 0
    assert FA.launches_by_route == {"wgmma": 0, "tf32x3": 0}


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


def _tf32x3_route(q, k, v, *, causal, window):
    """The tf32x3 route's arithmetic, returned in f32 before the one cast:
    q, k, v split into TF32 big and small parts; per key tile of the
    kernel's width (64 keys at dv <= 64, else 32) the scores as three
    products (small·big + big·small + big·big), summed from zero over at
    most 128 of the depth at a time and added in f32, scaled into the log2
    domain, masked to -inf; an online softmax (exp2, l in f32); P split as
    well and P·V as three products from zero, added as O·corr + P·V; rows
    with no valid key take the sum of every value over Sk; the output is
    O / max(l, 1e-30)."""
    B, Sq, H, d = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    tile = 64 if dv <= 64 else 32
    rep = H // KV
    qb, qs = _split(q.float().transpose(1, 2).contiguous())
    kb, ks = _split(k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
                    .contiguous())
    vb, vs = _split(v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
                    .contiguous())
    scale = math.log2(math.e) / math.sqrt(d)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, dv)
    for k0 in range(0, Sk, tile):
        kt = slice(k0, k0 + tile)
        s = torch.zeros(B, H, Sq, min(tile, Sk - k0))
        for c0 in range(0, d, 128):
            c = slice(c0, c0 + 128)
            s = s + (qs[..., c] @ kb[..., kt, c].transpose(-1, -2)
                     + qb[..., c] @ ks[..., kt, c].transpose(-1, -2)
                     + qb[..., c] @ kb[..., kt, c].transpose(-1, -2))
        s = s.masked_fill(~ok[:, kt], -math.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        corr = torch.exp2(m - mn)
        p = torch.exp2(s * scale - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        pb, ps = _split(p)
        acc = acc * corr + (ps @ vb[..., kt, :] + pb @ vs[..., kt, :]
                            + pb @ vb[..., kt, :])
        m = mn
    keyless = l == 0
    acc = torch.where(keyless, (vb + vs).sum(-2, keepdim=True), acc)
    l = torch.where(keyless, torch.full_like(l, float(Sk)), l)
    return (acc * (1.0 / l.clamp_min(1e-30))).transpose(1, 2)


# (B, Sq, Sk, H, KV, d, dv), causal, window; Sk a multiple of the Pallas
# wrapper's 32-key tile, which leaves padded keys unmasked otherwise
TF32X3_CASES = [
    ((1, 128, 128, 14, 2, 64, 64), True, 0),      # qwen2-0.5b's GQA heads
    ((1, 96, 96, 4, 2, 128, 128), True, 40),      # a window at d 128
    ((1, 160, 64, 4, 2, 64, 64), True, 32),       # rows >= 95 see no key
    ((1, 96, 96, 2, 1, 36, 36), True, 0),         # d 36, padded to 40
    ((1, 64, 96, 2, 2, 192, 128), False, 24),     # MLA's widths, a window
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dims,causal,window", TF32X3_CASES,
                         ids=["gqa_d64", "window_d128", "keyless_rows",
                              "d36", "d192_dv128_noncausal_window"])
def test_tf32x3_route_arithmetic_stays_inside_half_the_card_limit(
        dims, causal, window, dtype):
    B, Sq, Sk, H, KV, d, dv = dims
    rng = np.random.default_rng(B * Sq + Sk + H + d + dv + window)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in [(B, Sq, H, d), (B, Sk, KV, d),
                                    (B, Sk, KV, dv)]]
    assert FA.flash_route(dtype, *dims, True) == (
        "tf32x3" if dtype == torch.float32 or d % 8 else "wgmma")
    qn, kn, vn = (t.float().numpy() for t in (q, k, v))
    ref = _oracle(qn, kn, vn, causal=causal, window=window)
    pallas = np.asarray(jops.flash_attention(
        *[jnp.asarray(a) for a in (qn, kn, vn)], causal=causal,
        window=window, bq=32, bk=32, interpret=True))
    got = _tf32x3_route(q, k, v, causal=causal, window=window).numpy()
    assert np.abs(got - ref).max() <= 0.5 * ATOL
    assert np.abs(got - pallas).max() <= 0.5 * ATOL
    if window:
        keyless = np.arange(Sq) >= Sk + window - 1
        if causal and keyless.any():
            mean = np.repeat(vn.mean(axis=1), H // KV, axis=1)
            assert np.abs(got[:, keyless] - mean[:, None]).max() <= 0.5 * ATOL
    # the output is cast once: within the card's limit of its dtype
    out = torch.from_numpy(got).to(dtype).float().numpy()
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    assert (np.abs(out - ref) <= ATOL + rtol * np.abs(ref)).all()


def test_bf16_values_have_no_small_part():
    """A bf16 value is a TF32 value: its split gives it whole as the big
    part and exactly 0 as the small part, so the kernel issues no small
    product for a bf16 operand."""
    rng = np.random.default_rng(13)
    vals = np.concatenate([rng.standard_normal(4096) * 10.0 ** e
                           for e in range(-6, 7)]).astype(np.float32)
    t = torch.from_numpy(vals).bfloat16().float()
    t = torch.cat([t, torch.tensor([0.0, -0.0, 1.0, -1.0, 3.3895e38,
                                    -3.3895e38, 2.0 ** -126])
                   .bfloat16().float()])
    big, small = _split(t)
    assert torch.equal(big, t) and torch.equal(_tf32(t), t)
    assert (small == 0).all()
    # an f32 value in general has one: 1 + 2^-20 keeps its low bits there
    big, small = _split(torch.tensor([1.0 + 2.0 ** -20]))
    assert big.item() == 1.0 and small.item() == 2.0 ** -20


def test_unaligned_bf16_views_take_simt_and_match_pallas():
    """bf16 q, k, v at element offset 1 (GQA, causal): the wrapper's
    predicate is False, the route is tf32x3, and that route's arithmetic
    (the output cast to bf16 once) and the CPU entry agree with the
    reference's Pallas kernel within ``1e-4 + 2^-7·|plain|``."""
    B, Sq, Sk, H, KV, d, dv = 1, 128, 128, 4, 2, 64, 64
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in [(B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, dv)]]
    views = [_offset_view(torch.from_numpy(a).bfloat16(), 1) for a in arrs]
    assert not kbuild.aligned16(*views)
    assert FA.flash_route(torch.bfloat16, B, Sq, Sk, H, KV, d, dv,
                          kbuild.aligned16(*views)) == "tf32x3"
    pallas = np.asarray(jops.flash_attention(
        *[jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs], causal=True,
        bq=64, bk=64, interpret=True), np.float32)
    lim = ATOL + BF16_RTOL * np.abs(pallas)
    got = _tf32x3_route(*views, causal=True, window=0).bfloat16()
    assert (np.abs(got.float().numpy() - pallas) <= lim).all()
    cpu = tops.flash_attention(*views, causal=True)
    assert (np.abs(cpu.float().numpy() - pallas) <= lim).all()
