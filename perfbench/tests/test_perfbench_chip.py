"""The check's control on the card, at each cell's own size: the reference
computed one precision below the configuration's (float8 e4m3 products
for a bf16 model), put in the program's place, must come out not correct
on three seeds, while the program's own run of the same seed is correct.
Each run is the benchmark's command in a process of its own, with a short
window at the cell's own load.  Skipped where there is no NVIDIA GPU; run
on the chip with

    python -m pytest -q perfbench/tests/test_perfbench_chip.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests.checkout import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202,
                                  2 ** 31 + 303])
def test_the_control_fails_where_the_program_passes(chip, cell, seed):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "5", "--control", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    control = next(line for line in out.stderr.splitlines()
                   if line.startswith("control: "))
    print(cell, seed, "program", json.dumps(res["checks"]), control)
    assert json.loads(control[len("control: "):])["correct"] is False
