"""The port's fused LoRA projection (``repro_torch.kernels.ops.
fused_lora_matmul``) against the JAX package's Pallas kernel (interpret
mode) and its jnp oracle, on the CPU where the wrapper computes the plain
version.  Inputs come from numpy seeds and are scaled as the reference's
``tests/test_kernels.py`` scales them; tolerances are the reference's: 2e-5
in f32 (the two sum in different orders), 5e-2 in bf16 (outputs rounded to
bf16 once, from sums taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import lora_matmul as LM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import lora_matmul_ref  # noqa: E402

SHAPES = [
    (64, 128, 128, 4), (128, 256, 192, 8), (256, 512, 384, 16),
    (300, 512, 640, 16),   # non-tiling M: the reference pads, the port masks
    (128, 384, 256, 32),
]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _operands(seed, M, K, N, r, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*(lead or (M,)), K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((r, K)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((N, r)) * 0.1).astype(np.float32)
    return x, w, a, b


def _both(arrs, dtype):
    """The same values in both packages: f32 numpy → each package's bf16
    rounds to nearest even, so the bf16 inputs agree bit for bit."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, dtype=jdt) for a in arrs])


def _f32(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_pallas_and_oracle(shape, dtype):
    M, K, N, r = shape
    (x, w, a, b), (jx, jw, ja, jb) = _both(_operands(M + K + N + r, *shape),
                                            dtype)
    got = tops.fused_lora_matmul(x, w, a, b, scale=0.7)
    assert got.dtype == x.dtype and tuple(got.shape) == (M, N)
    pallas = jops.fused_lora_matmul(jx, jw, ja, jb, scale=0.7, bm=64, bn=64,
                                    bk=128, interpret=True)
    oracle = jref.lora_matmul_ref(jx, jw, ja, jb, scale=0.7)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("lead", [(2, 7), (3, 1, 5)])
def test_leading_batch_dims(lead):
    x, w, a, b = _operands(11, None, 128, 256, 8, lead=lead)
    got = tops.fused_lora_matmul(*[torch.from_numpy(t) for t in (x, w, a, b)])
    assert tuple(got.shape) == (*lead, 256)
    want = jops.fused_lora_matmul(*[jnp.asarray(t) for t in (x, w, a, b)],
                                  bm=64, bn=64, bk=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    flat = lora_matmul_ref(*[torch.from_numpy(t) for t in
                             (x.reshape(-1, 128), w, a, b)])
    np.testing.assert_array_equal(got.reshape(-1, 256).numpy(), flat.numpy())


def test_zero_padded_rank_equivalence():
    """Rank rows padded with zeros contribute nothing: one kernel serves
    every client rank."""
    x, w, a, b = _operands(1, 64, 128, 128, 16)
    mask = (np.arange(16) < 5).astype(np.float32)
    am, bm = a * mask[:, None], b * mask[None, :]
    got = tops.fused_lora_matmul(*[torch.from_numpy(t) for t in
                                   (x, w, am, bm)])
    want = jref.lora_matmul_ref(*[jnp.asarray(t) for t in
                                  (x, w, am[:5], bm[:, :5])])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_plain_version_accumulates_in_f32_and_casts_once():
    x, w, a, b = [torch.from_numpy(t) for t in _operands(5, 24, 96, 40, 8)]
    xb, wb, ab, bb = (t.bfloat16() for t in (x, w, a, b))
    got = lora_matmul_ref(xb, wb, ab, bb, scale=0.5)
    want = lora_matmul_ref(xb.float(), wb.float(), ab.float(), bb.float(),
                           scale=0.5).bfloat16()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def test_ops_exports_match_the_reference():
    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in ("dimension_wise_aggregate", "fedilora_aggregate_tree",
                 "flash_attention", "fused_lora_matmul"):
        assert getattr(tkernels, name) is getattr(tops, name)
    assert tops.ref.lora_matmul_ref is lora_matmul_ref


def test_cpu_calls_never_count_launches():
    x, w, a, b = [torch.from_numpy(t) for t in _operands(3, 6, 32, 16, 4)]
    LM.reset_launches()
    tops.fused_lora_matmul(x, w, a, b)
    tops.fused_lora_matmul(x[None], w, a, b, scale=2.0)
    assert LM.launches == 0


@pytest.mark.parametrize("bad", ["dtype_x", "dtype_w", "dtype_b", "x_1d",
                                 "shape_w", "shape_a", "shape_b", "rank",
                                 "noncontig", "cpu"])
def test_kernel_wrapper_rejects_bad_operands(bad):
    """The CUDA entry checks types, shapes, rank, contiguity and device
    before anything launches; a CPU tensor never reaches the kernel."""
    x, w, a, b = [torch.from_numpy(t) for t in _operands(9, 4, 32, 16, 4)]
    exc = ValueError
    if bad == "dtype_x":
        x, exc = x.double(), TypeError
    elif bad == "dtype_w":
        w, exc = w.bfloat16(), TypeError
    elif bad == "dtype_b":
        b, exc = b.bfloat16(), TypeError
    elif bad == "x_1d":
        x = x[0]
    elif bad == "shape_w":
        w = w[:-1]
    elif bad == "shape_a":
        a = a[:, :-1]
    elif bad == "shape_b":
        b = b[:, :-1]
    elif bad == "rank":
        a = torch.zeros(LM.MAX_RANK + 1, 32)
        b = torch.zeros(16, LM.MAX_RANK + 1)
    elif bad == "noncontig":
        w = torch.zeros(16, 32).T
    LM.reset_launches()
    with pytest.raises(exc):
        LM.lora_matmul_cuda(x, w, a, b)
    assert LM.launches == 0


def test_wrapper_has_no_fallback_for_other_devices():
    x, w, a, b = [torch.from_numpy(t).to("meta")
                  for t in _operands(4, 2, 16, 8, 4)]
    with pytest.raises(ValueError):
        tops.fused_lora_matmul(x, w, a, b)
