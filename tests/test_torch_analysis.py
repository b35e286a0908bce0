"""The port's analysis tooling against the JAX package's: the analytic
roofline model bit for bit, the roofline arithmetic at the H100's
constants, the collective schema, ``supports_shape``, the abstract batch
specs and the bytes of the abstract parameter, adapter and cache trees."""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.launch import analytic as RA
from repro.launch import specs as RS
from repro_torch.configs import get_config
from repro_torch.launch import analytic as PA
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as PS

ARCHS = list_archs(include_bench=True)
OPTS = [None, {"causal_skip": True}, {"seq_parallel": True},
        {"expert_parallel": True},
        {"seq_parallel": True, "expert_parallel": True}]


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_the_reference_bit_for_bit(arch):
    rc, pc = ref_config(arch), get_config(arch)
    n = 0
    for name in RS.INPUT_SHAPES:
        for multi in (False, True):
            for opts in OPTS:
                r = RA.analytic_terms(rc, RS.INPUT_SHAPES[name],
                                      RA.mesh_info(multi), opts=opts)
                p = PA.analytic_terms(pc, PS.INPUT_SHAPES[name],
                                      PA.mesh_info(multi), opts=opts)
                assert p.flops_dev == r.flops_dev, (name, multi, opts)
                assert p.hbm_bytes_dev == r.hbm_bytes_dev, (name, multi, opts)
                assert p.coll_bytes_dev == r.coll_bytes_dev, (name, multi,
                                                              opts)
                assert p.detail == r.detail, (name, multi, opts)
                # only the seconds differ: the constants are the H100's
                pr = p.roofline()
                assert pr["compute_s"] == p.flops_dev / RL.PEAK_FLOPS
                assert pr["memory_s"] == p.hbm_bytes_dev / RL.HBM_BW
                assert pr["collective_s"] == p.coll_bytes_dev / RL.LINK_BW
                n += 1
    assert n == len(RS.INPUT_SHAPES) * 2 * len(OPTS)
    assert dataclasses.asdict(PA.mesh_info(True)) == dataclasses.asdict(
        RA.mesh_info(True))


def test_h100_constants_and_roofline_math():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.HBM_BYTES) == (989e12, 3.35e12,
                                                        80e9)
    assert (RL.NVLINK_BW, RL.LINK_BW) == (450e9, 50e9)
    terms = RL.roofline({"flops": RL.PEAK_FLOPS, "bytes accessed": RL.HBM_BW},
                        {"total_bytes": RL.LINK_BW * 2})
    assert terms.compute_s == pytest.approx(1.0)
    assert terms.memory_s == pytest.approx(1.0)
    assert terms.collective_s == pytest.approx(2.0)
    assert terms.dominant == "collective"
    d = terms.as_dict()
    assert set(d) == {"compute_s", "memory_s", "collective_s", "dominant",
                      "flops_per_device", "hbm_bytes_per_device",
                      "collective_bytes_per_device"}
    t = RL.roofline({"flops": 3 * RL.PEAK_FLOPS}, {"total_bytes": 0})
    assert t.dominant == "compute" and t.memory_s == 0.0
    # one table of peaks: the kernel bounds read the same H100 figures
    assert RL.peaks_for("NVIDIA H100 80GB HBM3") == (RL.HBM_BW,
                                                     RL.PEAK_FLOPS,
                                                     495e12 / 3)
    assert RL.peaks_for("NVIDIA H100 PCIe")[0] == 2.0e12
    with pytest.raises(RuntimeError):
        RL.peaks_for("NVIDIA A100")


def test_analytic_train_flops_scale_with_model():
    mi = PA.mesh_info(False)
    small = PA.analytic_terms(get_config("qwen2-0.5b"),
                              PS.INPUT_SHAPES["train_4k"], mi)
    big = PA.analytic_terms(get_config("qwen2-72b"),
                            PS.INPUT_SHAPES["train_4k"], mi)
    assert big.flops_dev > 50 * small.flops_dev


def test_analytic_decode_window_bounds_attention():
    mi = PA.mesh_info(False)
    cfg = get_config("gemma3-12b")
    t = PA.analytic_terms(cfg, PS.INPUT_SHAPES["long_500k"], mi)
    t_full = PA.analytic_terms(dataclasses.replace(cfg, pattern=("attn",) * 6),
                               PS.INPUT_SHAPES["long_500k"], mi)
    assert t.flops_dev < t_full.flops_dev


def test_analytic_seq_parallel_reduces_collective():
    mi = PA.mesh_info(False)
    cfg = get_config("qwen2-72b")
    base = PA.analytic_terms(cfg, PS.INPUT_SHAPES["train_4k"], mi)
    sp = PA.analytic_terms(cfg, PS.INPUT_SHAPES["train_4k"], mi,
                           opts={"seq_parallel": True})
    assert sp.coll_bytes_dev < base.coll_bytes_dev


def test_analytic_expert_parallel_removes_expert_gather():
    mi = PA.mesh_info(False)
    cfg = get_config("deepseek-v2-236b")
    base = PA.analytic_terms(cfg, PS.INPUT_SHAPES["decode_32k"], mi)
    ep = PA.analytic_terms(cfg, PS.INPUT_SHAPES["decode_32k"], mi,
                           opts={"expert_parallel": True})
    assert ep.coll_bytes_dev < base.coll_bytes_dev / 5


class _Counted:
    """A mesh's counters and shape, as ``collective_bytes`` reads them."""

    def __init__(self, shape, counts, nbytes):
        self.shape = shape
        self.collectives = collections.Counter(counts)
        self.collective_bytes = collections.Counter(nbytes)


def test_collective_bytes_schema():
    from repro.launch.hlo_analysis import COLLECTIVE_OPS
    mesh = _Counted({"pod": 2, "data": 4, "model": 8},
                    {("all_reduce", "model"): 3, ("all_gather", "model"): 2,
                     ("all_reduce", ("pod", "data")): 1,
                     ("all_gather", ("pod", "data")): 1},
                    {("all_reduce", "model"): 300,
                     ("all_gather", "model"): 20,
                     ("all_reduce", ("pod", "data")): 64,
                     ("all_gather", ("pod", "data")): 5})
    out = RL.collective_bytes(mesh)
    assert tuple(out["per_op"]) == COLLECTIVE_OPS == RL.COLLECTIVE_OPS
    assert tuple(out["counts"]) == COLLECTIVE_OPS
    # result bytes: an all-gather's operand times its axis' size
    assert out["per_op"]["all-reduce"] == 300 + 64
    assert out["per_op"]["all-gather"] == 20 * 8 + 5 * 8
    assert out["counts"] == {"all-gather": 3, "all-reduce": 4,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}
    assert out["total_bytes"] == sum(out["per_op"].values())
    scaled = RL.collective_bytes(mesh, collections.Counter(
        {("all_reduce", "model"): 6}), collections.Counter(
        {("all_reduce", "model"): 600}))
    assert scaled["per_op"]["all-reduce"] == 600
    assert scaled["counts"]["all-reduce"] == 6
    assert scaled["per_op"]["all-gather"] == 0


def test_supports_shape_equals_the_reference():
    for arch in ARCHS:
        for name in RS.INPUT_SHAPES:
            assert PS.supports_shape(get_config(arch),
                                     PS.INPUT_SHAPES[name]) == \
                RS.supports_shape(ref_config(arch), RS.INPUT_SHAPES[name])
    assert dataclasses.asdict(PS.INPUT_SHAPES["long_500k"]) == \
        dataclasses.asdict(RS.INPUT_SHAPES["long_500k"])
    assert PS._audio_len(32_768) == RS._audio_len(32_768)
    assert PS._audio_len(4) == RS._audio_len(4) == 8


@pytest.mark.parametrize("with_labels", [True, False])
def test_batch_specs_equal_the_reference(with_labels):
    for arch in ARCHS:
        r = RS.batch_specs(ref_config(arch), 4, 96, with_labels=with_labels)
        p = PS.batch_specs(get_config(arch), 4, 96, with_labels=with_labels)
        assert sorted(p) == sorted(r), arch
        for k, v in r.items():
            assert tuple(p[k].shape) == tuple(v.shape), (arch, k)
            assert str(p[k].dtype).removeprefix("torch.") == str(v.dtype), \
                (arch, k)
            assert p[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_tree_bytes_equal_the_reference(arch):
    """Parameters, a rank-32 adapter and the decode cache of every
    supported decode shape: the same bytes as the reference's
    ``eval_shape`` trees, with nothing allocated."""
    rc, pc = ref_config(arch), get_config(arch)
    rp, pp = RS.abstract_params(rc), PS.abstract_params(pc)
    assert PS.tree_bytes(pp) == _jax_bytes(rp)
    assert {t.device.type for t in jax.tree_util.tree_leaves(
        {k: v for k, v in pp.items()})} == {"meta"}
    assert PS.tree_bytes(PS.abstract_lora(pc, 32)) == _jax_bytes(
        RS.abstract_lora(rc, 32))
    for name in ("decode_32k", "long_500k"):
        shape = RS.INPUT_SHAPES[name]
        if not RS.supports_shape(rc, shape)[0]:
            continue
        rb = _jax_bytes(RS.abstract_cache(rc, rp, shape.global_batch,
                                          shape.seq_len))
        pb = PS.tree_bytes(PS.abstract_cache(pc, pp, shape.global_batch,
                                             shape.seq_len))
        assert pb == rb, (arch, name)


def test_meta_trees_allocate_nothing():
    cfg = get_config("qwen2-72b")
    p = PS.abstract_params(cfg)
    assert p["embed"].device.type == "meta"
    assert PS.tree_bytes(p) > 140e9          # 72 B bf16 parameters
    assert isinstance(p["embed"], torch.Tensor)
