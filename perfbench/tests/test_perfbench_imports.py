"""The rule on imports, checked in fresh processes: a run loads no module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro``
(compared whole: ``repro_torch`` is the port), and the reference loads
nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

from perfbench.tests.checkout import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _run(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "src",
                              "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import io, json, sys, contextlib
from pathlib import Path
from perfbench.tests.checkout import make_root
import torch
from perfbench import run
root = make_root(Path({str(tmp_path)!r}))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = run.main(["--workload", "train.tiny-vlm.paper", "--seed", "7",
                   "--seconds", "0.2"], root=root, device=torch.device("cpu"))
assert rc == 0, rc
print(json.dumps(sorted(sys.modules)))
"""
    mods = _run(code)
    assert "repro_torch" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys
import perfbench.reference.prefix_vlm, perfbench.reference.hybrid
print(json.dumps(sorted(sys.modules)))
"""
    mods = _run(code)
    assert not [m for m in mods
                if m.split(".")[0] in FORBIDDEN + ("repro_torch",)]
