"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``)
against the JAX package's Pallas kernel (interpret mode, through its ops
wrapper) and its oracle, on the CPU where the wrapper computes the plain
version.  Inputs come from numpy seeds.  Tolerances are the reference's
(``tests/test_flash_kernel.py``): 2e-5 in f32 (sums in another order),
3e-2 in bf16 (the output rounded to bf16 once).

On a shape whose Sk is not a multiple of the reference wrapper's key tile,
the reference leaves the padded keys unmasked for non-causal queries; the
port masks them, so there it is held against the oracle only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JLY  # noqa: E402
from repro_torch.kernels import flash as FA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TLY  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, B, Sq, Sk, H, KV, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, dv or d)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _oracle(q, k, v, *, causal, window=0):
    """The JAX oracle in the ops layout: KV heads repeated, heads folded."""
    B, Sq, H, d = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    rep = H // KV
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)

    def fold(t):
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(B * H, -1,
                                                           t.shape[3]))

    out = jref.flash_attention_ref(fold(q), fold(k), fold(v), causal=causal,
                                   window=window)
    return np.asarray(out).reshape(B, H, Sq, dv).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("shape", [
    (2, 128, 128, 64),    # BH, Sq, Sk, d: the reference test's shapes
    (1, 256, 256, 32),
    (3, 64, 192, 64),     # Sq != Sk
], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_matches_pallas_and_oracle(shape, causal, window):
    BH, Sq, Sk, d = shape
    q, k, v = _qkv(BH * Sq + Sk + d + window, 1, Sq, Sk, BH, BH, d)
    got = tops.flash_attention(*_t(q, k, v), causal=causal, window=window)
    pallas = jops.flash_attention(*_j(q, k, v), causal=causal, window=window,
                                  bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _oracle(q, k, v, causal=causal, window=window),
                               **TOL)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, 0), (48, 80, False, 0), (80, 48, True, 0),
    (96, 32, True, 16),   # rows with no valid key: every value averaged
])
def test_plain_oracle_matches_reference_oracle(Sq, Sk, causal, window):
    """``ref.flash_attention_ref`` computes what the JAX oracle computes,
    in the folded [BH, S, d] layout, including its -1e30 masking."""
    rng = np.random.default_rng(Sq * Sk + window)
    q = rng.standard_normal((3, Sq, 16)).astype(np.float32)
    k = rng.standard_normal((3, Sk, 16)).astype(np.float32)
    v = rng.standard_normal((3, Sk, 8)).astype(np.float32)
    got = tref.flash_attention_ref(*_t(q, k, v), causal=causal, window=window)
    want = jref.flash_attention_ref(*_j(q, k, v), causal=causal,
                                    window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_bf16():
    q, k, v = _qkv(0, 1, 128, 128, 2, 2, 64)
    got = tops.flash_attention(*[t.bfloat16() for t in _t(q, k, v)])
    assert got.dtype == torch.bfloat16
    pallas = jops.flash_attention(*[jnp.asarray(t, jnp.bfloat16)
                                    for t in (q, k, v)],
                                  causal=True, bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("B,S,H,KV,d,dv,window", [
    (1, 96, 14, 2, 64, 64, 0),     # qwen2-0.5b's ratio H/KV = 7
    (2, 64, 4, 1, 192, 128, 0),    # dv != d, MLA's widths
    (1, 128, 4, 2, 72, 72, 32),    # d = 72, with a window
])
def test_gqa_and_head_widths_match_pallas(B, S, H, KV, d, dv, window):
    """Query head h reads KV head h // (H / KV), as the reference's
    ``jnp.repeat`` over heads gives it (with H / KV = 7, ``h % KV`` would
    read another head)."""
    q, k, v = _qkv(H * d + dv, B, S, S, H, KV, d, dv)
    got = tops.flash_attention(*_t(q, k, v), causal=True, window=window)
    assert tuple(got.shape) == (B, S, H, dv)
    pallas = jops.flash_attention(*_j(q, k, v), causal=True, window=window,
                                  bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # the mapping matters on this input: a head read from h % KV differs
    kwrong = np.take(k, np.arange(H) % KV, axis=2)
    vwrong = np.take(v, np.arange(H) % KV, axis=2)
    if H // KV > 1 and KV > 1:
        wrong = tops.flash_attention(*_t(q, kwrong, vwrong), causal=True,
                                     window=window)
        assert np.abs(wrong.numpy() - got.numpy()).max() > 1e-2


def test_non_causal_ragged_keys_are_masked():
    """Sk = 100 is not a multiple of the reference wrapper's 64-key tile:
    the port masks keys past Sk and equals the oracle; the reference
    wrapper lets its 28 padded keys in."""
    q, k, v = _qkv(7, 1, 100, 100, 2, 2, 32)
    got = tops.flash_attention(*_t(q, k, v), causal=False)
    want = _oracle(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    padded = np.asarray(jops.flash_attention(*_j(q, k, v), causal=False,
                                             bq=64, bk=64, interpret=True))
    assert np.abs(padded - want).max() > 1e-3


def test_rows_without_a_valid_key_average_every_value():
    """With Sq > Sk + window - 1, the last query rows see no key: the
    oracle's softmax over scores that are all -1e30 is uniform there, and
    the Pallas kernel (Sk a multiple of its tile) gives the same mean; so
    does the port, in the ops layout with grouped heads."""
    q, k, v = _qkv(11, 1, 96, 32, 4, 2, 16)
    got = tops.flash_attention(*_t(q, k, v), causal=True, window=16)
    want = _oracle(q, k, v, causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    mean = np.repeat(v.mean(axis=1), 2, axis=1)        # [B, H, dv]
    np.testing.assert_allclose(got.numpy()[:, 47:], np.broadcast_to(
        mean[:, None], (1, 49, 4, 16)), **TOL)
    pallas = jops.flash_attention(*_j(q, k, v), causal=True, window=16,
                                  bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("B,S,H,KV,d,window", [
    (2, 128, 8, 2, 32, 0),        # the reference test's GQA shape
    (1, 192, 4, 4, 32, 32),       # its local-attention shape
])
def test_matches_model_attention(B, S, H, KV, d, window):
    """``ops.flash_attention`` against the port's (and the reference's)
    ``multihead_attention`` without chunking."""
    q, k, v = _qkv(B * S + H + window, B, S, S, H, KV, d)
    got = tops.flash_attention(*_t(q, k, v), causal=True, window=window)
    model = TLY.multihead_attention(*_t(q, k, v), causal=True, window=window,
                                    chunked=False)
    np.testing.assert_allclose(got.numpy(), model.numpy(), **TOL)
    jmodel = JLY.multihead_attention(*_j(q, k, v), causal=True,
                                     window=window, chunked=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel), **TOL)


def test_cpu_calls_never_count_launches():
    q, k, v = _t(*_qkv(3, 1, 16, 16, 2, 1, 8))
    FA.reset_launches()
    tops.flash_attention(q, k, v)
    tops.flash_attention(q, k, v, causal=False, window=4)
    assert FA.launches == 0


@pytest.mark.parametrize("bad", ["dtype_q", "dtype_v", "rank3", "batch",
                                 "width_k", "heads", "seq_v", "wide",
                                 "window", "noncontig", "cpu"])
def test_kernel_wrapper_rejects_bad_operands(bad):
    """The CUDA entry checks types, shapes, head widths, window, contiguity
    and device before anything launches; a CPU tensor never reaches the
    kernel."""
    q, k, v = _t(*_qkv(9, 2, 8, 8, 4, 2, 16))
    exc, window = ValueError, 0
    if bad == "dtype_q":
        q, exc = q.double(), TypeError
    elif bad == "dtype_v":
        v, exc = v.bfloat16(), TypeError
    elif bad == "rank3":
        q = q[0]
    elif bad == "batch":
        k = k[:1]
    elif bad == "width_k":
        k = k[..., :-1]
    elif bad == "heads":
        k, v = torch.zeros(2, 8, 3, 16), torch.zeros(2, 8, 3, 16)
    elif bad == "seq_v":
        v = v[:, :-1]
    elif bad == "wide":
        q = torch.zeros(2, 8, 4, FA.MAX_HEAD_DIM + 1)
        k = torch.zeros(2, 8, 2, FA.MAX_HEAD_DIM + 1)
    elif bad == "window":
        window = -1
    elif bad == "noncontig":
        q = torch.zeros(2, 4, 8, 16).transpose(1, 2)
    FA.reset_launches()
    with pytest.raises(exc):
        FA.flash_attention_cuda(q, k, v, window=window)
    assert FA.launches == 0


def test_wrapper_has_no_fallback_for_other_devices():
    q, k, v = [t.to("meta") for t in _t(*_qkv(4, 1, 8, 8, 2, 2, 8))]
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v)
