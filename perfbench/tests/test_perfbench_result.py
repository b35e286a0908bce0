"""Whole runs of the toy cells on the CPU through ``run.main`` (the look for
a chip skipped): the result line's keys, the check passing a sound run,
the control and every planted fault failing it."""

from __future__ import annotations

import pytest

from perfbench.tests.checkout import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "build_s",
        "checks"]
E2E = {"train.tiny-vlm.paper": {"setup_s", "train_tokens_per_s"},
       "serve.tiny-hybrid.steady": {"setup_s", "ttft_p95_ms", "tpot_p95_ms"},
       "serve.tiny-hybrid.batch": {"setup_s", "serve_tokens_per_s"}}


@pytest.mark.parametrize("cell", sorted(E2E))
def test_a_sound_run_prints_the_contract_line(toy_root, cell):
    rc, res, err = run_cell(toy_root, cell, control=1)
    assert rc == 0, err[-2000:]
    assert list(res) == KEYS
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == E2E[cell]
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    assert res["attempted"] > 0 and res["failed"] == 0
    lines = err.strip().splitlines()
    assert all(line.startswith("check ") for line in
               lines[-len(res["checks"]):])
    control = next(line for line in lines if line.startswith("control: "))
    assert '"correct": false' in control


@pytest.mark.parametrize("cell,fault", [
    ("train.tiny-vlm.paper", "frozen"),
    ("train.tiny-vlm.paper", "half_batch"),
    ("serve.tiny-hybrid.batch", "token"),
    ("serve.tiny-hybrid.batch", "stale_state")])
def test_a_broken_timed_path_is_not_correct(toy_root, cell, fault):
    rc, res, err = run_cell(toy_root, cell, fault=fault)
    assert rc == 0, err[-2000:]
    assert res["correct"] is False, res["checks"]


def test_a_checkout_without_the_port_fails_without_a_result(tmp_path):
    import shutil

    from perfbench.tests.checkout import BENCH
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    rc, res, _ = run_cell(tmp_path, "train.minicpm-v-2.paper")
    assert rc != 0 and res is None


def test_a_wrong_token_is_counted_apart_from_the_mean(toy_root):
    _, sound, _ = run_cell(toy_root, "serve.tiny-hybrid.batch")
    _, broken, _ = run_cell(toy_root, "serve.tiny-hybrid.batch",
                            fault="token")
    assert sound["checks"]["wrong_tokens"]["value"] == 0
    wrong = broken["checks"]["wrong_tokens"]
    assert wrong["value"] > wrong["limit"]
