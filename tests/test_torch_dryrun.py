"""The port's dry run (``repro_torch.launch.dryrun``) on a fake process
group of 8 ranks: ``make_debug_mesh(4, 2)`` and a 2×2×2 ``("pod", "data",
"model")`` mesh, reduced configs at small shapes.

The process group lives in a subprocess (this file run as a script),
which prints every result as one JSON object; the tests read it.  Held:
a record for train, prefill and decode on every family with collective
bytes > 0; the fed round on fedbench-tiny on both meshes; the scaling of a
two-block (and two-microbatch) trace to the whole stack against a trace of
the whole stack, every microbatch, equal in FLOPs, bytes accessed,
collectives and peak bytes (under ``ep`` and ``sp`` too); the tracer's
FLOPs against ``FlopCounterMode``'s; the long_500k skip; a record of
every sharding mode with the collective kinds its placement issues; the
CLI, and the meshes' shapes and flattened axes."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma3-12b", "minicpm-2b", "llama4-scout-17b-a16e",
         "llama-3.2-vision-11b", "mamba2-130m", "jamba-v0.1-52b",
         "seamless-m4t-medium", "qwen2-72b", "deepseek-v2-236b",
         "qwen2-0.5b"]
SCALED = ["qwen2-0.5b", "gemma3-12b", "jamba-v0.1-52b", "deepseek-v2-236b",
          "llama-3.2-vision-11b", "seamless-m4t-medium"]
# small shapes of the three kinds, registered beside the production ones
SMALL = {"t_small": (256, 16, "train"), "p_small": (512, 8, "prefill"),
         "d_small": (512, 8, "decode")}
# every sharding mode: (arch, shape) -> the collective kinds it must issue
MODE_CASES = {
    "baseline": [("qwen2-0.5b", "t_small", ("all-gather", "all-reduce"))],
    "ep": [("llama4-scout-17b-a16e", "t_small", ("all-to-all",)),
           ("deepseek-v2-236b", "d_small", ("all-to-all",))],
    "sp": [("qwen2-0.5b", "t_small", ("reduce-scatter", "all-gather")),
           ("jamba-v0.1-52b", "t_small", ("reduce-scatter",))],
    "ep_sp": [("llama4-scout-17b-a16e", "t_small",
               ("all-to-all", "reduce-scatter"))],
    "seq": [("gemma3-12b", "d_small", ("all-gather", "all-reduce")),
            ("gemma3-12b", "long_500k", ("all-reduce",))],
    "scoreshard": [("deepseek-v2-236b", "d_small", ("all-gather",))],
    "seq_scoreshard": [("deepseek-v2-236b", "d_small", ("all-gather",))],
}
# (arch, mode) whose scaled trace is held against the whole stack
SCALED_MODES = [("llama4-scout-17b-a16e", "ep"), ("jamba-v0.1-52b", "sp"),
                ("llama4-scout-17b-a16e", "ep_sp")]


def _worker() -> dict:
    """Everything that needs the fake process group, in this process."""
    import collections

    torch.set_num_threads(1)
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.launch.specs import INPUT_SHAPES, InputShape
    from repro_torch.models.tensor_parallel import TensorParallel
    for name, (seq, batch, kind) in SMALL.items():
        INPUT_SHAPES[name] = InputShape(name, seq, batch, kind)
    D.fake_process_group(8)
    flat = Mesh((2, 2, 2), ("pod", "data", "model"))
    debug = make_debug_mesh(4, 2)
    out: dict = {"records": {}, "scaled": {}, "fedround": {}}
    out["meshes"] = {
        "debug": dict(debug.shape), "flat": dict(flat.shape),
        "flat_batch": flat.shape[("pod", "data")],
        "flat_coord": flat.coord(("pod", "data")),
        "flat_group": torch.distributed.get_world_size(
            flat.group(("pod", "data")))}
    for arch in ARCHS:
        cfg = get_reduced_config(arch)
        for shape in SMALL:
            rec = D.dryrun_one(arch, shape, multi_pod=False, mesh=debug,
                               cfg=cfg, rank=8,
                               num_micro_override=2 if shape == "t_small"
                               else None)
            out["records"][f"{arch}/{shape}"] = rec
        out["records"][f"{arch}/long_500k"] = D.dryrun_one(
            arch, "long_500k", multi_pod=False, mesh=debug, cfg=cfg)
    out["records"]["flat/t_small"] = D.dryrun_one(
        "qwen2-0.5b", "t_small", multi_pod=True, mesh=flat,
        cfg=get_reduced_config("qwen2-0.5b"), rank=8, num_micro_override=2)
    out["flat_counts"] = {f"{op}|{ax}": n for (op, ax), n in
                          flat.collectives.items()}
    for mesh, tag in ((debug, "debug"), (flat, "flat")):
        out["fedround"][tag] = D.dryrun_fedround(
            "fedbench-tiny", multi_pod=tag == "flat", mesh=mesh,
            cfg=get_reduced_config("fedbench-tiny"), rank=8, local_steps=2,
            client_batch=4, seq=32)
    pick = lambda t: {
        "flops": t.flops, "bytes": t.bytes_accessed, "peak": t.peak,
        "counts": sorted((f"{k}", v) for k, v in t.counts.items()),
        "coll_bytes": sorted((f"{k}", v) for k, v in t.coll_bytes.items())}
    # scaling against the whole stack, every microbatch
    for arch in SCALED:
        base = get_reduced_config(arch)
        cfg = dataclasses.replace(base, num_layers=4 * base.period)
        tp = TensorParallel(cfg, debug)
        for shape in SMALL:
            kind = SMALL[shape][2]
            ab, nm, make_call = D.step_calls(
                cfg, INPUT_SHAPES[shape], mesh=debug, tp=tp, rank=8,
                num_micro_override=4 if kind == "train" else None)
            est, how = D.scaled_trace(make_call, cfg.num_blocks, nm, debug,
                                      first=1 if kind == "prefill" else 2)
            fn, args = make_call(cfg.num_blocks, nm or 1)
            whole = D.trace(fn, *args, mesh=debug)
            out["scaled"][f"{arch}/{shape}"] = {
                "est": pick(est), "whole": pick(whole),
                "traced_blocks": how["traced_blocks"]}
    # the tracer's FLOPs are FlopCounterMode's
    cfg = get_reduced_config("jamba-v0.1-52b")
    tp = TensorParallel(cfg, debug)
    _, _, make_call = D.step_calls(cfg, INPUT_SHAPES["t_small"], mesh=debug,
                                   tp=tp, rank=8, num_micro_override=2)
    fn, args = make_call(cfg.num_blocks, 2)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    out["flop_counter"] = [fc.get_total_flops(),
                           D.trace(fn, *args, mesh=debug).flops]
    # every sharding mode
    out["modes"] = {}
    for mode, cases in MODE_CASES.items():
        for arch, shape, _ in cases:
            out["modes"][f"{mode}/{arch}/{shape}"] = D.dryrun_one(
                arch, shape, multi_pod=False, mesh=debug,
                cfg=get_reduced_config(arch), rank=8, sharding_mode=mode,
                num_micro_override=2 if shape == "t_small" else None)
    # scaling under the placements that change execution
    for arch, mode in SCALED_MODES:
        base = get_reduced_config(arch)
        cfg = dataclasses.replace(base, num_layers=4 * base.period)
        tp = D.make_tp(cfg, debug, "train", mode)
        ab, nm, make_call = D.step_calls(
            cfg, INPUT_SHAPES["t_small"], mesh=debug, tp=tp, rank=8,
            num_micro_override=4, mode=mode)
        est, how = D.scaled_trace(make_call, cfg.num_blocks, nm, debug,
                                  first=2)
        fn, args = make_call(cfg.num_blocks, nm)
        whole = D.trace(fn, *args, mesh=debug)
        out["scaled"][f"{arch}/{mode}"] = {
            "est": pick(est), "whole": pick(whole),
            "traced_blocks": how["traced_blocks"]}
    out["counter_keys"] = sorted(
        f"{op}|{ax}" for (op, ax) in collections.Counter(
            debug.collectives))
    return out


@pytest.fixture(scope="module")
def res():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    done = subprocess.run([sys.executable, __file__], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_one_every_family(res, arch):
    for shape, (seq, batch, kind) in SMALL.items():
        rec = res["records"][f"{arch}/{shape}"]
        assert "skipped" not in rec and rec["kind"] == kind, rec
        assert rec["mesh"] == "4x2"
        assert rec["cost_analysis"]["flops"] > 0
        assert rec["cost_analysis"]["bytes accessed"] > 0
        mem = rec["memory_analysis"]
        assert mem["argument_size_bytes"] > 0 and mem["temp_size_bytes"] > 0
        assert mem["peak_bytes"] == (mem["argument_size_bytes"]
                                     + mem["temp_size_bytes"])
        assert mem["fits"] is True
        coll = rec["collectives"]
        assert coll["total_bytes"] > 0 and coll["counts"]["all-reduce"] > 0
        assert rec["roofline_traced"]["dominant"] in (
            "compute", "memory", "collective")
        assert rec["roofline"]["flops_per_device"] > 0
        assert rec["useful_flops_ratio"] > 0
        assert rec["traced_to_analytic_flops"] > 0
        assert rec["traced_blocks"]
        if kind == "train":
            assert rec["num_microbatches"] == 2
            assert rec["traced_microbatches"] == 2


def test_long_500k_skips_as_the_reference(res):
    for arch in ARCHS:
        rec = res["records"][f"{arch}/long_500k"]
        long_ok = arch in ("gemma3-12b", "mamba2-130m", "jamba-v0.1-52b")
        assert ("skipped" in rec) != long_ok, (arch, rec.get("skipped"))
        if long_ok:
            assert rec["memory_analysis"]["argument_size_bytes"] > 0


def test_three_axis_mesh_means_gradients_over_pod_and_data(res):
    rec = res["records"]["flat/t_small"]
    assert rec["mesh"] == "2x2x2"
    # all-reduces over the flattened batch axes, per step: each of the two
    # microbatches' mask counts, then the gradients and metrics
    assert res["flat_counts"]["all_reduce|('pod', 'data')"] == 3
    assert res["flat_counts"]["all_reduce|model"] > 0
    assert res["meshes"]["flat_batch"] == 4
    assert res["meshes"]["flat_group"] == 4
    assert res["meshes"]["flat_coord"] == 0


@pytest.mark.parametrize("tag", ["debug", "flat"])
def test_dryrun_fedround(res, tag):
    rec = res["fedround"][tag]
    assert rec["kind"] == "fedround" and rec["shape"] == "fedround_K4"
    assert rec["collectives"]["counts"]["all-gather"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["memory_analysis"]["fits"] is True
    # the same program on either mesh: K = 4 clients, one a rank group
    assert rec["cost_analysis"] == res["fedround"]["debug"]["cost_analysis"]


@pytest.mark.parametrize("arch", SCALED + [f"{a}/{m}"
                                           for a, m in SCALED_MODES])
def test_scaled_trace_equals_the_whole_stack(res, arch):
    shapes = SMALL if "/" not in arch else [arch.split("/")[1]]
    for shape in shapes:
        got = res["scaled"][arch if "/" in arch else f"{arch}/{shape}"]
        assert got["est"] == got["whole"], (shape, got)
        assert len(got["traced_blocks"]) == 2


def test_tracer_flops_are_flop_counter_modes(res):
    mode, mine = res["flop_counter"]
    assert mode == mine > 0


@pytest.mark.parametrize("mode", list(MODE_CASES))
def test_every_sharding_mode(res, mode):
    """A record for every mode, tagged with it, whose collectives include
    the kinds its placement issues and whose placement says what ran."""
    for arch, shape, kinds in MODE_CASES[mode]:
        rec = res["modes"][f"{mode}/{arch}/{shape}"]
        assert "error" not in rec and "skipped" not in rec, rec
        assert rec["sharding_mode"] == mode
        counts = rec["collectives"]["counts"]
        for kind in kinds:
            assert counts[kind] > 0, (mode, arch, shape, kind, counts)
        pl = rec["placement"]
        assert pl["fsdp"]
        assert pl["expert_parallel"] == ("ep" in mode.split("_"))
        assert pl["seq_parallel"] == ("sp" in mode.split("_"))
        if shape == "long_500k":
            assert pl["cache_axis"] == ("model" if "seq" in mode else "data")
        elif SMALL[shape][2] == "decode":
            assert pl["cache_axis"] == ("model" if "seq" in mode.split("_")
                                        else None)
            assert pl["score_axis"] == ("model" if "scoreshard" in mode
                                        else None)
        if "ep" not in mode.split("_") and "sp" not in mode.split("_"):
            assert counts["all-to-all"] == counts["reduce-scatter"] == 0


def test_debug_mesh_shapes_and_counter_keys(res):
    assert res["meshes"]["debug"] == {"data": 4, "model": 2}
    assert res["meshes"]["flat"] == {"pod": 2, "data": 2, "model": 2}
    assert "all_reduce|data" in res["counter_keys"]


def test_cli_writes_records_and_refuses_modes(tmp_path):
    """The CLI's record of a skipped combination (nothing traced) and its
    refusal of a non-baseline mode; traced records are the worker's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a,
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=240)
    done = run("--arch", "qwen2-0.5b", "--shape", "long_500k", "--mesh",
               "both")
    assert done.returncode == 0, done.stderr[-3000:]
    for mesh in ("16x16", "2x16x16"):
        rec = json.loads((tmp_path / f"qwen2-0.5b__long_500k__{mesh}.json"
                          ).read_text())
        assert rec["mesh"] == mesh and rec["kind"] == "decode"
        assert "skipped" in rec
    assert "2 records, 0 failed" in done.stdout
    done = run("--arch", "qwen2-0.5b", "--shape", "long_500k",
               "--sharding-mode", "seq_scoreshard")
    assert done.returncode == 0, done.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen2-0.5b__long_500k__16x16__"
                      "seq_scoreshard.json").read_text())
    assert rec["sharding_mode"] == "seq_scoreshard" and "skipped" in rec
    done = run("--arch", "qwen2-0.5b", "--shape", "train_4k",
               "--sharding-mode", "ep_bogus")
    assert done.returncode != 0
    assert "unknown sharding mode" in done.stderr
    assert not (tmp_path / "qwen2-0.5b__train_4k__16x16__ep_bogus.json"
                ).exists()


def test_importing_the_dry_run_starts_nothing():
    code = ("import os, json, torch.distributed as dist\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "print(json.dumps([dict(os.environ) == before,\n"
            "                  dist.is_initialized()]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=120,
                          check=True)
    assert json.loads(done.stdout.strip().splitlines()[-1]) == [True, False]


if __name__ == "__main__":
    print(json.dumps(_worker(), default=str))
