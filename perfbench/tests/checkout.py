"""Helpers of the benchmark's CPU tests: a checkout of the benchmark with
the toy cells of ``data/`` beside the real ones, and one run of a cell
through ``run.main`` on the CPU (the look for a chip skipped)."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the toy cell standing in for each real one
TOY = {"train.minicpm-v-2.paper": "train.tiny-vlm.paper",
       "serve.granite-h-small-10.steady": "serve.tiny-hybrid.steady"}
#: toy cells of paths that no real cell drives yet (an offline backlog),
#: each with the end-to-end metric it reports
EXTRA = {"serve.tiny-hybrid.batch": {
    "name": "serve_tokens_per_s", "unit": "tokens/s", "better": "higher",
    "bound": 0.25, "source": "host_clock"}}


def make_root(dest: Path) -> Path:
    """A checkout at ``dest``: ``perfbench/`` copied (its code, the real
    cells and the toy ones), ``src`` linked, and a ``BENCHMARK.json`` in
    which every real cell has a toy twin that reports what it reports,
    beside the toy cells of ``EXTRA``."""
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    for kind in ("configs", "workloads"):
        for f in (DATA / kind).glob("*.json"):
            shutil.copy(f, dest / "perfbench" / kind / f.name)
    (dest / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in ("tiny-vlm", "tiny-hybrid"):
        spec["configs"].append({"name": c, "source": "test",
                                "file": f"perfbench/configs/{c}.json",
                                "reduced": [], "why": "test"})
    for w in list(spec["workloads"]):
        toy = json.loads((DATA / "workloads" / f"{TOY[w['name']]}.json")
                         .read_text())
        spec["workloads"].append(dict(w, name=TOY[w["name"]],
                                      config=toy["config"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [TOY[w] for w in m["workloads"]]
    for name, metric in EXTRA.items():
        toy = json.loads((DATA / "workloads" / f"{name}.json").read_text())
        spec["workloads"].append({"name": name, "config": toy["config"],
                                  "traffic": name.split(".")[-1],
                                  "chips": 1, "why": "test"})
        spec["end_to_end"].append(dict(metric, workloads=[name]))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


#: a backlog's window ends at its ``--seconds`` with requests in flight, so
#: on a busy CPU one second may finish few or none, and the check then sees
#: other requests than on an idle one: its toy cell gets longer (it ends
#: early once every request is served)
SECONDS = {"serve.tiny-hybrid.batch": 8.0}


def run_cell(root: Path, cell: str, *, seed: int = 2 ** 31 + 11,
             seconds: float | None = None, trace: int = 0, control: int = 0,
             fault: str | None = None):
    """(exit code, the result line as a dict or None, standard error) of
    one CPU run of ``cell`` (``seconds``: by default 1, or ``SECONDS``)."""
    import torch

    from perfbench import run as bench_run
    if seconds is None:
        seconds = SECONDS.get(cell, 1.0)
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--control", str(control)]
    if fault:
        argv += ["--fault", fault]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(argv, root=root, device=torch.device("cpu"),
                            check_imports=False)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
