"""The benchmark is found by name and driven by data: every cell,
configuration, driver and metric of ``BENCHMARK.json`` resolves to its
file, the file keeps to the contract's shape, and a new cell,
configuration or metric is picked up from new files alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from perfbench.tests.checkout import ROOT, make_root
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_keep_the_contract_shape(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e and kind != "end_to_end" and kind != "per_layer":
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert 1 <= len(e["layer"]) <= 200


def test_every_cell_reports_setup_another_metric_and_a_layer():
    reg = harness.Registry(ROOT)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        mine = {m["name"] for m in reg.end_to_end_for(w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = reg.metrics_for(w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e and m["moves"] in mine, m["name"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_names_resolve_to_files():
    reg = harness.Registry(ROOT)
    for w in SPEC["workloads"]:
        cell = reg.workload(w["name"])
        assert reg.config(cell["config"])["name"] == cell["config"]
        drv = reg.driver(cell["driver"])
        assert callable(drv.run) and drv.FAULTS
    for m in SPEC["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
    for c in SPEC["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in (root / "perfbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    base = root / "perfbench"
    shutil.copy(base / "configs" / "tiny-vlm.json",
                base / "configs" / "tiny-vlm-b.json")
    cfg = json.loads((base / "configs" / "tiny-vlm-b.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "tiny-vlm-b"
    (base / "configs" / "tiny-vlm-b.json").write_text(json.dumps(cfg))
    cell = json.loads((base / "workloads" / "train.tiny-vlm.paper.json")
                      .read_text())
    cell["config"] = "tiny-vlm-b"
    (base / "workloads" / "train.tiny-vlm-b.paper.json").write_text(
        json.dumps(cell))
    (base / "metrics" / "rounds.train.py").write_text(
        "def read(rec):\n    return float(rec['rounds'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-vlm-b", "source": "test",
                            "file": "perfbench/configs/tiny-vlm-b.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "train.tiny-vlm-b.paper",
                              "config": "tiny-vlm-b", "traffic": "paper",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "train.tiny-vlm.paper" in m.get("workloads", ()):
            m["workloads"].append("train.tiny-vlm-b.paper")
    spec["per_layer"].append({"name": "rounds.train", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "trainer (federated/runtime.py)",
                              "moves": "train_tokens_per_s",
                              "workloads": ["train.tiny-vlm-b.paper"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    reg = harness.Registry(root)
    w = reg.workload("train.tiny-vlm-b.paper")
    assert reg.config(w["config"])["name"] == "tiny-vlm-b"
    assert [m["name"] for m in reg.metrics_for("train.tiny-vlm-b.paper")] \
        == ["rounds.train"]
    assert reg.metric("rounds.train").read({"rounds": 3}) == 3.0
