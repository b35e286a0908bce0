"""The port's BGMV (``repro_torch.kernels.grouped_lora_matmul``) against the
JAX package's Pallas kernel (interpret mode) and its jnp oracle, on the CPU
where the wrapper computes the plain version.  Inputs come from numpy
seeds; tolerance atol = rtol = 1e-5 in f32 (the two sum in different
orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import lora as JL  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import lora as TL  # noqa: E402
from repro_torch.kernels import grouped_lora_matmul as glm  # noqa: E402
from repro_torch.kernels.ref import grouped_lora_matmul_ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _operands(seed, M, K, N, G, r, ranks=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    a = (rng.standard_normal((G, r, K)) / np.sqrt(K)).astype(np.float32)
    b = (rng.standard_normal((G, N, r)) / np.sqrt(r)).astype(np.float32)
    if ranks is not None:                 # heterogeneous ranks, zero-padded
        for g, rk in enumerate(ranks):
            a[g, rk:] = 0.0
            b[g, :, rk:] = 0.0
    idx = rng.integers(0, G, size=M).astype(np.int32)
    return x, w, a, b, idx


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("M,K,N,G,r,ranks", [
    (8, 128, 64, 4, 8, None),
    (5, 96, 40, 3, 16, None),             # ragged K and N
    (7, 64, 48, 4, 16, (4, 8, 16, 2)),    # zero-padded heterogeneous ranks
    (16, 32, 24, 2, 4, None),             # many repeated indices
])
def test_plain_matches_pallas_and_oracle(M, K, N, G, r, ranks):
    x, w, a, b, idx = _operands(M * K + N, M, K, N, G, r, ranks)
    got = glm.grouped_lora_matmul(*_t(x, w, a, b, idx), scale=0.5).numpy()
    pallas = np.asarray(jops.grouped_lora_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(idx), scale=0.5, bn=16, bk=32, interpret=True))
    oracle = np.asarray(jref.grouped_lora_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(idx), scale=0.5))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    if ranks is not None:                 # padding is inert: ragged compute
        for m in range(M):
            g, rk = idx[m], ranks[idx[m]]
            row = x[m] @ w + 0.5 * (x[m] @ a[g, :rk].T) @ b[g, :, :rk].T
            np.testing.assert_allclose(got[m], row, **TOL)


def test_chunk_shape_broadcasts_batch_index():
    """x [B, chunk, K] with a [B] index: every chunk row of batch row b uses
    adapter idx[b], as ``ops.grouped_lora_matmul`` broadcasts it."""
    B, C, K, N, G, r = 3, 4, 48, 40, 4, 8
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, C, K)).astype(np.float32)
    _, w, a, b, _ = _operands(8, 1, K, N, G, r)
    idx = np.array([2, 0, 2], np.int32)
    got = glm.grouped_lora_matmul(*_t(x, w, a, b, idx), scale=2.0).numpy()
    pallas = np.asarray(jops.grouped_lora_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(idx), scale=2.0, bn=16, bk=16, interpret=True))
    assert got.shape == (B, C, N)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_core_grouped_lora_matches_reference(kernel):
    """``core.lora.grouped_lora_matmul`` (gather path and kernel route) vs
    the JAX package's, on the decode and the chunked-prefill shapes."""
    rng = np.random.default_rng(11)
    B, K, N, G, r = 4, 64, 32, 3, 8
    _, w, a, b, _ = _operands(12, 1, K, N, G, r)
    idx = rng.integers(0, G, size=B).astype(np.int32)
    for C in (1, 5):
        x = rng.standard_normal((B, C, K)).astype(np.float32)
        got = TL.grouped_lora_matmul(
            torch.from_numpy(x), torch.from_numpy(w),
            {"A": torch.from_numpy(a), "B": torch.from_numpy(b)},
            torch.from_numpy(idx).long(), 0.7, kernel=kernel).numpy()
        want = np.asarray(JL.grouped_lora_matmul(
            jnp.asarray(x), jnp.asarray(w),
            {"A": jnp.asarray(a), "B": jnp.asarray(b)}, jnp.asarray(idx), 0.7,
            kernel=False))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("r_k", [0, 3, 8])
def test_rank_mask_and_lora_matmul_match_reference(r_k):
    """The single-adapter projection (the ``lora_idx=None`` branch of
    ``_qkv``) and the rank mask, against ``repro.core.lora``."""
    np.testing.assert_array_equal(TL.rank_mask(r_k, 8).numpy(),
                                  np.asarray(JL.rank_mask(r_k, 8)))
    assert TL.LoRAConfig(rank=8).scale == JL.LoRAConfig(rank=8).scale
    x, w, a, b, _ = _operands(r_k, 6, 32, 24, 1, 8)
    m = np.asarray(JL.rank_mask(r_k, 8))
    lora = {"A": a[0] * m[:, None], "B": b[0] * m[None]}
    got = TL.lora_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         {k: torch.from_numpy(v) for k, v in lora.items()},
                         0.5).numpy()
    want = np.asarray(JL.lora_matmul(jnp.asarray(x), jnp.asarray(w),
                                     {k: jnp.asarray(v)
                                      for k, v in lora.items()}, 0.5))
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_calls_never_count_launches():
    x, w, a, b, idx = _operands(3, 6, 32, 16, 2, 4)
    glm.reset_launches()
    glm.grouped_lora_matmul(*_t(x, w, a, b, idx))
    TL.grouped_lora_matmul(torch.from_numpy(x)[:, None], torch.from_numpy(w),
                           {"A": torch.from_numpy(a),
                            "B": torch.from_numpy(b)},
                           torch.from_numpy(idx), 1.0, kernel=True)
    assert glm.launches == 0


def test_plain_version_accumulates_in_f32_for_bf16():
    x, w, a, b, idx = _operands(5, 6, 64, 24, 3, 8)
    xt, wt, at, bt, it = _t(x, w, a, b, idx)
    got = grouped_lora_matmul_ref(xt.bfloat16(), wt.bfloat16(), at.bfloat16(),
                                  bt.bfloat16(), it, scale=0.5)
    want = grouped_lora_matmul_ref(xt.bfloat16().float(), wt.bfloat16().float(),
                                   at.bfloat16().float(), bt.bfloat16().float(),
                                   it, scale=0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("bad", ["dtype_x", "dtype_w", "dtype_bank", "idx64",
                                 "shape_w", "shape_b", "shape_idx", "rank",
                                 "wide_k", "noncontig", "cpu"])
def test_kernel_wrapper_rejects_bad_operands(bad):
    """The CUDA entry checks types, shapes, rank, contiguity and device
    before anything launches; a CPU tensor never reaches the kernel."""
    x, w, a, b, idx = _t(*_operands(9, 4, 32, 16, 2, 4))
    exc = ValueError
    if bad == "dtype_x":
        x, exc = x.double(), TypeError
    elif bad == "dtype_w":
        w, exc = w.bfloat16(), TypeError
    elif bad == "dtype_bank":
        a, exc = a.bfloat16(), TypeError
    elif bad == "idx64":
        idx, exc = idx.long(), TypeError
    elif bad == "shape_w":
        w = w[:-1]
    elif bad == "shape_b":
        b = b[:, :-1]
    elif bad == "shape_idx":
        idx = idx[:-1]
    elif bad == "rank":
        a = torch.zeros(2, glm.MAX_RANK + 1, 32)
        b = torch.zeros(2, 16, glm.MAX_RANK + 1)
    elif bad == "wide_k":   # x rows beyond the shrink kernel's shared memory
        K = glm.MAX_SMEM_BYTES // 4
        x, w = torch.zeros(9, K), torch.zeros(K, 16)
        a = torch.zeros(2, 4, K)
    elif bad == "noncontig":
        w = torch.zeros(16, 32).T
    with pytest.raises(exc):
        glm.grouped_lora_matmul_cuda(x, w, a, b, idx)
    assert glm.launches == 0


def test_wrapper_has_no_fallback_for_other_devices():
    x, w, a, b, idx = _t(*_operands(4, 2, 16, 8, 2, 4))
    with pytest.raises(ValueError):
        glm.grouped_lora_matmul(x.to("meta"), w.to("meta"), a.to("meta"),
                                b.to("meta"), idx.to("meta"))
