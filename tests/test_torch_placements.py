"""The production steps' placements on the CPU, on spawned gloo ranks of
``("data", "model")`` meshes 2×2, (4, 1) and (1, 4), against the JAX
package's steps on the whole batch and the port's unmeshed steps, through
the harness of ``tests/test_torch_batch_mesh.py`` (reduced configs; its
limits):

* FSDP over ``"data"``: every rank's piece of every weight has the shape
  the reference's ``param_spec`` gives it on dense archs (the port cuts
  the attention biases by heads, where the reference replicates them);
* K/V heads fewer than the ``"model"`` axis: 8 query heads and 2 K/V
  heads on a 4-wide axis, each K/V head held by two ranks;
* ``ep``: the experts over ``"data"`` with the all-to-all dispatch, the
  routing equal on every rank and to the unmeshed step's; a batch of one
  that ``"data"`` does not split, every rank's logits the whole batch's;
* ``sp`` and ``ep_sp``: sequence-parallel training, loss and gradients;
* ``seq`` and the long-context fallback: the decode caches' sequence over
  ``"model"`` (every K/V head, a sliding window's ring too) or, for a
  batch of one, over ``"data"``: decode logits against the reference's
  ``decode_step``;
* ``scoreshard``: MLA decode scores split over ``"model"``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_batch_mesh import (B, CASES, MOE_OVER, assert_logits,  # noqa: E402
                                   assert_routes, assert_train, run_all)

KV = {"num_heads": 8, "num_kv_heads": 2, "head_dim": 32}
PLACE_CASES = {
    "dense": ("qwen2-0.5b", {}, 6, B),
    "gemma": ("gemma3-12b", {"sliding_window": 4}, 7, B),
    "minicpm": ("minicpm-2b", {}, 8, B),
    "kv": ("qwen2-72b", KV, 9, B),
    # 6 heads on a 4-wide axis: attention stays whole, as minicpm-2b's 36
    # on 16
    "whole": ("qwen2-0.5b", {"num_heads": 6, "num_kv_heads": 2,
                             "head_dim": 32}, 13, B),
    "llama4": CASES["llama4"],
    "jamba": CASES["jamba"],
    # d_ff_expert 510 does not divide a 4-wide axis: the MoE stays whole
    "moe_whole": ("llama4-scout-17b-a16e",
                  {"moe": dict(MOE_OVER, d_ff_expert=510)}, 14, B),
    "deepseek": ("deepseek-v2-236b", {"moe": MOE_OVER}, 10, B),
    "gemma_b1": ("gemma3-12b", {"sliding_window": 4}, 11, 1),
    "jamba_b1": ("jamba-v0.1-52b", {"moe": MOE_OVER}, 12, 1),
}
T3 = ("train", "prefill", "serve")


def _job(name, case, mesh, steps, **kw):
    return dict(name=name, case=case, mesh=mesh, steps=steps, **kw)


JOBS = [
    _job("fsdp/dense", "dense", (2, 2), T3, shapes=True),
    _job("fsdp/gemma", "gemma", (2, 2), (), shapes=True),
    _job("fsdp/minicpm", "minicpm", (2, 2), (), shapes=True),
    _job("kv/1x4", "kv", (1, 4), T3, shapes=True),
    _job("ep/4x1", "llama4", (4, 1), T3, ep=True, shapes=True),
    _job("ep/2x2", "llama4", (2, 2), T3, ep=True),
    _job("ep/jamba", "jamba", (2, 2), ("train",), ep=True),
    _job("sp/kv", "kv", (1, 4), ("train",), sp=True, shapes=True),
    _job("sp/jamba", "jamba", (1, 4), ("train",), sp=True),
    _job("sp/whole", "whole", (1, 4), ("train",), sp=True),
    _job("sp/moe_whole", "moe_whole", (1, 4), ("train",), sp=True),
    _job("sp/deepseek", "deepseek", (2, 2), ("train",), sp=True),
    _job("ep_sp/llama4", "llama4", (2, 2), ("train",), ep=True, sp=True),
    _job("seq/gemma", "gemma", (1, 4), ("serve",), cache_axis="model"),
    _job("seq/deepseek", "deepseek", (1, 4), ("serve",), cache_axis="model"),
    _job("seq/whole", "whole", (1, 4), ("serve",), cache_axis="model"),
    _job("seq/llama4", "llama4", (2, 2), ("serve",), cache_axis="model",
         ep=True),
    _job("fallback/gemma", "gemma_b1", (4, 1), ("serve",),
         cache_axis="data"),
    _job("fallback/jamba", "jamba_b1", (4, 1), ("serve",),
         cache_axis="data"),
    _job("fallback/jamba_ep", "jamba_b1", (4, 1), ("serve",),
         cache_axis="data", ep=True),
    _job("scoreshard/1x4", "deepseek", (1, 4), ("serve",),
         score_axis="model"),
    _job("scoreshard/2x2", "deepseek", (2, 2), ("serve",),
         score_axis="model"),
    _job("seq_scoreshard/1x4", "deepseek", (1, 4), ("serve",),
         cache_axis="model", score_axis="model"),
]
BY_NAME = {j["name"]: j for j in JOBS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory, PLACE_CASES, {4: ((2, 2), JOBS)})


def _check(runs, name):
    refs, plain, meshed = runs
    job, got = BY_NAME[name], meshed[name]
    want, base = refs[job["case"]], plain[job["case"]]
    if "train" in job["steps"]:
        assert got["ranks_agree"]
        assert_train(got, want)
    for step in ("prefill", "serve"):
        if step in job["steps"]:
            assert_logits(got[step], want[step])
            assert_logits(got[step], base[step])
            if f"{step}_ranks_gap" in got:
                assert got[f"{step}_ranks_gap"] == 0.0, step
    assert got["routes_agree"]
    if base["routes"]:
        assert_routes(got["routes"], base["routes"])
    return got


@pytest.mark.parametrize("name", ["fsdp/dense", "fsdp/gemma",
                                  "fsdp/minicpm"])
def test_fsdp_pieces_are_the_reference_param_specs(runs, name):
    """Every weight's piece on rank 0 (coordinates (0, 0)) has the
    reference's ``param_spec`` shard shape on a 2×2 mesh."""
    from repro import sharding as JS
    from test_torch_sharding import FakeMesh
    refs, _, meshed = runs
    job, got = BY_NAME[name], meshed[name]
    mesh = FakeMesh((("data", 2), ("model", 2)))
    case = PLACE_CASES[job["case"]]
    from test_torch_batch_mesh import make_case
    tree = make_case(*case)["params"]
    split_data = 0

    def walk(t, path=()):
        nonlocal split_data
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            spec = JS.param_spec(path + (k,), v.shape, mesh)
            want = list(v.shape)
            for i, ax in enumerate(tuple(spec)):
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    if a is not None:
                        want[i] //= mesh.shape[a]
                        split_data += a == "data"
            piece = got["shapes"][path + (k,)]
            if k in ("bq", "bk", "bv"):      # cut by heads in the port
                assert piece[-1] * 2 == v.shape[-1], (path, k)
            else:
                assert piece == tuple(want), (path, k, piece, want)
    walk(tree)
    assert split_data > 0
    if "train" in job["steps"]:
        _check(runs, name)
        assert got["collectives"]["all_gather|data"] > 0


def test_kv_heads_fewer_than_the_axis(runs):
    got = _check(runs, "kv/1x4")
    assert got["placement"]["attn"] and got["placement"]["kv_groups"] == 2
    hd = KV["head_dim"]
    wk = got["shapes"][("blocks", "s0", "attn", "wk")]
    wq = got["shapes"][("blocks", "s0", "attn", "wq")]
    assert wk[-1] == hd and wq[-1] == 2 * hd


@pytest.mark.parametrize("name", ["ep/4x1", "ep/2x2", "ep/jamba",
                                  "fallback/jamba_ep"])
def test_expert_parallel(runs, name):
    got = _check(runs, name)
    assert got["collectives"]["all_to_all|data"] > 0
    if "shapes" in got:
        assert got["placement"]["ep"]
        assert got["shapes"][("blocks", "s0", "moe", "w1")][1] == 1


@pytest.mark.parametrize("name", ["sp/kv", "sp/jamba", "sp/whole",
                                  "sp/moe_whole", "sp/deepseek",
                                  "ep_sp/llama4"])
def test_sequence_parallel_training(runs, name):
    got = _check(runs, name)
    assert got["collectives"]["reduce_scatter|model"] > 0
    if name.startswith("ep_sp"):
        assert got["collectives"]["all_to_all|data"] > 0


@pytest.mark.parametrize("name", ["seq/gemma", "seq/deepseek", "seq/whole",
                                  "seq/llama4", "fallback/gemma",
                                  "fallback/jamba"])
def test_sequence_split_decode_caches(runs, name):
    _check(runs, name)


@pytest.mark.parametrize("name", ["scoreshard/1x4", "scoreshard/2x2",
                                  "seq_scoreshard/1x4"])
def test_scoreshard_mla_decode(runs, name):
    got = _check(runs, name)
    assert got["collectives"]["all_gather|model"] > 0


def test_sequence_parallel_needs_a_dividing_sequence():
    """The step refuses a sequence the axis does not divide, naming both."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.tensor_parallel import TensorParallel
    fake_process_group(4)
    try:
        cfg = get_reduced_config("qwen2-0.5b")
        tp = TensorParallel(cfg, Mesh((1, 4), ("data", "model")), sp=True)
        x = torch.zeros((1, 6, cfg.d_model), device="meta")
        with pytest.raises(ValueError, match="6 positions.*"):
            T._run_blocks(cfg, {}, None, x, lora_scale=1.0,
                          positions=None, tp=tp)
    finally:
        dist.destroy_process_group()
