"""The LoRA wrapper's route (``repro_torch.kernels.lora_matmul.lora_route``),
the arithmetic of both routes, and the build's cache key, on the CPU.

Each route's arithmetic is written out in PyTorch and held against the JAX
package's f32 oracle ``repro.kernels.ref.lora_matmul_ref`` on the same
numpy-seeded inputs, at qwen2-0.5b's ``wq`` site, scaled as ``chip_smoke.py``
scales them:

* ``wgmma``: bf16 inputs, every sum in f32, ``xa = scale·(x·Aᵀ)`` split
  into bf16 ``hi + lo`` before the product with Bᵀ, y rounded to bf16 once;
* ``tf32x3``: every f32 operand v split into ``big = tf32(v)``
  (``cvt.rna``: ``(bits + 0x1000) & ~0x1fff``) and ``small = v - big``, of
  which the tensor core reads the TF32 part (``bits & ~0x1fff``), three
  products summed in f32; a product of two TF32 values is exact in f32.

The card holds both routes to ``1e-4`` (f32) and ``1e-4 + 2^-7·|plain|``
(bf16); here each route's arithmetic lands within half of that limit,
while the one-rounding shortcuts (xa rounded to bf16 once, plain TF32) do
not land within the whole limit.

A bf16 operand whose base is not 16-byte aligned (a contiguous view at an
odd element offset) is refused by TMA, so ``lora_route`` sends it to
``"tf32x3"``; that route's arithmetic on such a view is held against the
JAX package's ``ops.fused_lora_matmul`` in Pallas interpret mode."""

import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import lora_matmul as LM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.transformer import lora_specs  # noqa: E402

F32_ATOL, BF16_RTOL = 1e-4, 2.0 ** -7
BF16, F32 = torch.bfloat16, torch.float32
# qwen2-0.5b's wq site: 2048 tokens, d_model 896, 14 heads x 64, rank 64
WQ = (2048, 896, 896, 64)
SCALE = 0.7


@pytest.mark.parametrize("dtypes,dims,route", [
    ((BF16, BF16), WQ, "wgmma"),
    ((BF16, BF16), (130, 200, 152, 24), "wgmma"),   # ragged M, r = 24
    ((BF16, BF16), (1, 8, 8, 8), "wgmma"),
    ((BF16, BF16), (130, 200, 150, 8), "tf32x3"),   # N·2 = 300 bytes
    ((BF16, BF16), (64, 100, 128, 8), "tf32x3"),    # K·2 = 200 bytes
    ((BF16, BF16), (64, 128, 128, 12), "tf32x3"),   # r·2 = 24 bytes
    ((BF16, BF16), (64, 0, 128, 8), "tf32x3"),      # K = 0: no tensor map
    ((BF16, F32), WQ, "tf32x3"),
    ((F32, BF16), WQ, "tf32x3"),
    ((F32, F32), WQ, "tf32x3"),
], ids=["wq", "ragged_m_r24", "smallest", "n150", "k100", "r12", "k0",
        "bf16_x_f32_ab", "f32_x_bf16_ab", "f32"])
def test_route(dtypes, dims, route):
    assert LM.lora_route(*dtypes, *dims, True) == route


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_lora_site_takes_the_tensor_core_route_in_bf16(arch):
    """Attention, MLA and Mamba projections at full width."""
    specs = lora_specs(get_config(arch))
    assert specs
    for s in specs:
        for r in (8, 16, 32, 64):
            assert LM.lora_route(BF16, BF16, 2048, s.in_dim, s.out_dim,
                                 r, True) == "wgmma", (s.name, r)
            assert LM.lora_route(F32, F32, 2048, s.in_dim, s.out_dim,
                                 r, True) == "tf32x3", (s.name, r)


def test_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(6)
    x, w, a, b = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .bfloat16() for s in [(16, 32), (32, 24), (8, 32), (24, 8)]]
    LM.launches_by_route["wgmma"] = 3
    LM.reset_launches()
    assert LM.launches_by_route == {"wgmma": 0, "tf32x3": 0}
    tops.fused_lora_matmul(x, w, a, b)
    tops.fused_lora_matmul(x.float(), w.float(), a, b)
    assert LM.launches == 0
    assert LM.launches_by_route == {"wgmma": 0, "tf32x3": 0}


def _wq_operands():
    """x, W, A, B at the wq site, scaled as chip_smoke.py scales them."""
    rng = np.random.default_rng(15)
    M, K, N, r = WQ
    return [(rng.standard_normal(s) * mul).astype(np.float32)
            for s, mul in [((M, K), 1.0), ((K, N), 0.05), ((r, K), 0.1),
                           ((N, r), 0.1)]]


def _oracle(x, w, a, b):
    return np.asarray(jref.lora_matmul_ref(
        *[jnp.asarray(t) for t in (x, w, a, b)], scale=SCALE))


def _tf32(t):
    """cvt.rna.tf32.f32: round the low 13 mantissa bits, ties away from 0."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(t):
    """The TF32 part the tensor core reads of an f32 register."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(t):
    big = _tf32(t)
    return big, _tf32_trunc(t - big)


def _mm3(a, b):
    """a @ b in 3xTF32: small products first, f32 sums."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _wgmma_route(x, w, a, b, *, split_xa=True):
    xf, wf, af, bf = (t.float() for t in (x, w, a, b))
    acc = xf @ wf
    v = SCALE * (xf @ af.T)
    hi = v.bfloat16().float()
    delta = hi @ bf.T
    if split_xa:
        delta = delta + (v - hi).bfloat16().float() @ bf.T
    return (acc + delta).bfloat16()


def _tf32x3_route(x, w, a, b):
    acc = _mm3(x, w)
    v = SCALE * _mm3(x, a.T)
    return acc + _mm3(v, b.T)


def test_wgmma_route_arithmetic_stays_inside_half_the_card_limit():
    x, w, a, b = [torch.from_numpy(t).bfloat16() for t in _wq_operands()]
    ref = _oracle(*(t.float().numpy() for t in (x, w, a, b)))
    lim = F32_ATOL + BF16_RTOL * np.abs(ref)
    got = _wgmma_route(x, w, a, b).float().numpy()
    assert (np.abs(got - ref) <= 0.5 * lim).all()
    # xa rounded to bf16 once leaves ~2^-9 |xa| on each term: outside
    once = _wgmma_route(x, w, a, b, split_xa=False).float().numpy()
    assert not (np.abs(once - ref) <= lim).all()


def test_tf32x3_route_arithmetic_stays_inside_half_the_card_limit():
    x, w, a, b = [torch.from_numpy(t) for t in _wq_operands()]
    ref = _oracle(x.numpy(), w.numpy(), a.numpy(), b.numpy())
    got = _tf32x3_route(x, w, a, b).numpy()
    assert (np.abs(got - ref) <= 0.5 * F32_ATOL).all()
    # plain TF32 (10 mantissa bits) is outside the f32 limit
    one = (_tf32(x) @ _tf32(w)
           + (SCALE * (_tf32(x) @ _tf32(a).T)) @ _tf32(b).T).numpy()
    assert not (np.abs(one - ref) <= F32_ATOL).all()


def test_tf32_rounding_emulation():
    t = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12])
    assert _tf32(t).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0,
                                 -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10]
    big, small = _split(t)
    assert torch.equal(big + small, t)   # small is a TF32 value here
    assert _tf32_trunc(torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -12])).item() \
        == 1.0


def test_cache_key_sees_every_shared_header(tmp_path):
    """An edit to a csrc/*.cuh header rebuilds every library; an edit to
    another library's source does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC, csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert {"lora_matmul", "lora_matmul_wgmma",
            "flash_attention_wgmma"} <= set(names)
    before = {n: kbuild.source_digest(n, csrc) for n in names}
    assert before == {n: kbuild.source_digest(n) for n in names}
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text()
                                     + "\n// edited\n")
    after = {n: kbuild.source_digest(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "dim_agg.cu").write_text((csrc / "dim_agg.cu").read_text()
                                     + "\n// edited\n")
    again = {n: kbuild.source_digest(n, csrc) for n in names}
    assert again["dim_agg"] != after["dim_agg"]
    assert all(again[n] == after[n] for n in names if n != "dim_agg")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert kbuild.source_digest("lora_matmul_wgmma", csrc) != \
        again["lora_matmul_wgmma"]


def test_every_local_include_is_a_hashed_header():
    """Both tensor-core sources include hopper.cuh, and every quoted
    include of a source is a csrc/*.cuh file that the key hashes."""
    headers = {p.name for p in kbuild.CSRC.glob("*.cuh")}
    for src in kbuild.CSRC.glob("*.cu"):
        local = set(re.findall(r'#include\s+"([^"]+)"', src.read_text()))
        assert local <= headers, (src.name, local)
        if src.stem.endswith("_wgmma"):
            assert "hopper.cuh" in local


@pytest.mark.parametrize("dtypes,dims", [
    ((BF16, BF16), WQ), ((BF16, BF16), (1, 8, 8, 8)), ((F32, F32), WQ),
    ((BF16, F32), WQ)], ids=["wq", "smallest", "f32", "bf16_x_f32_ab"])
def test_unaligned_operands_take_the_tf32x3_route(dtypes, dims):
    assert LM.lora_route(*dtypes, *dims, False) == "tf32x3"


def _offset_view(t, offset):
    """t's values in a contiguous view ``offset`` elements into a buffer."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_alignment_predicate_sees_a_view_at_an_odd_element_offset(dtype):
    t = torch.ones(64, 32, dtype=dtype)
    assert kbuild.aligned16(t)
    view = _offset_view(t, 1)
    assert view.is_contiguous() and torch.equal(view, t)
    assert not kbuild.aligned16(view)
    assert not kbuild.aligned16(t, view)
    assert kbuild.aligned16(_offset_view(t, 16 // t.element_size()))


def test_unaligned_bf16_view_route_arithmetic_matches_pallas():
    """bf16 operands at element offset 1: the wrapper's predicate is False,
    the route is tf32x3, and that route's arithmetic (y rounded to bf16
    once) and the CPU entry agree with the reference's Pallas kernel within
    the bf16 limit."""
    rng = np.random.default_rng(16)
    M, K, N, r = 192, 256, 320, 32
    arrs = [(rng.standard_normal(sh) * mul).astype(np.float32)
            for sh, mul in [((M, K), 1.0), ((K, N), 0.05), ((r, K), 0.1),
                            ((N, r), 0.1)]]
    views = [_offset_view(torch.from_numpy(a).bfloat16(), 1) for a in arrs]
    assert not kbuild.aligned16(*views)
    assert LM.lora_route(BF16, BF16, M, K, N, r,
                         kbuild.aligned16(*views)) == "tf32x3"
    pallas = np.asarray(jops.fused_lora_matmul(
        *[jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs], scale=SCALE,
        bm=64, bn=64, bk=128, interpret=True), np.float32)
    lim = F32_ATOL + BF16_RTOL * np.abs(pallas)
    got = _tf32x3_route(*(v.float() for v in views)).bfloat16()
    assert (np.abs(got.float().numpy() - pallas) <= lim).all()
    cpu = tops.fused_lora_matmul(*views, scale=SCALE)
    assert cpu.dtype == BF16
    assert (np.abs(cpu.float().numpy() - pallas) <= lim).all()
