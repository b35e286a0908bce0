"""What every run shares: where things are, loading a cell's files by name,
the port's ``ModelConfig`` from a configuration file, the device record,
the rule on imports, and the result line.

A cell names its configuration, its driver and its traffic in
``workloads/<cell>.json``; the configuration is ``configs/<config>.json``,
the driver ``drivers/<driver>.py`` and each per-layer metric
``metrics/<metric>.py``.  Nothing here knows a cell, configuration or
metric by name, so a later cell, configuration or metric is new files and
new ``BENCHMARK.json`` entries only.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: top-level module names that may not be loaded in a run: JAX and the JAX
#: package (compared whole: ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Registry:
    """The benchmark of a checkout ``root``: its ``BENCHMARK.json`` and the
    files under ``perfbench/``, found by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        entries = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())
        if cell["config"] != entries[0]["config"]:
            raise ValueError(f"{name}: its file names config "
                             f"{cell['config']!r}, BENCHMARK.json "
                             f"{entries[0]['config']!r}")
        cell["name"] = name
        cell["chips"] = entries[0]["chips"]
        return cell

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def driver(self, name: str):
        return load_module(self.dir / "drivers" / f"{name}.py",
                           f"perfbench_driver_{name}_{id(self)}")

    def metrics_for(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those with no ``workloads`` key in every cell that reports the
        end-to-end metric they move."""
        e2e = {m["name"] for m in self.end_to_end_for(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in e2e)]

    def end_to_end_for(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def metric(self, name: str):
        return load_module(self.dir / "metrics" / f"{name}.py",
                           f"perfbench_metric_{name}_{id(self)}")


def load_module(path: Path, name: str):
    """Import one file of the benchmark by its path (metric files carry
    dots in their names, so they are not importable by module name)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file's ``model``
    block (``moe`` / ``ssm`` / ``mla`` nested, ``pattern`` a list)."""
    from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                           SSMConfig)
    m = dict(cfg["model"])
    for key, cls in (("moe", MoEConfig), ("ssm", SSMConfig),
                     ("mla", MLAConfig)):
        if m.get(key) is not None:
            m[key] = cls(**m[key])
    m["pattern"] = tuple(m.get("pattern", ("attn",)))
    return ModelConfig(**m)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def p95(values) -> float:
    """The 95th percentile by nearest rank (an infinite value, a request
    that failed, stays infinite)."""
    v = sorted(values)
    if not v:
        return math.inf
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, compared: list,
                breakdown: dict | None = None,
                build_s: dict | None = None) -> str:
    """The contract's last line of standard output.  ``build_s``: seconds
    each kernel library took to build in this run (0 = loaded from the
    cache), the part of a compiling run's ``setup_s`` that a warm run does
    not pay.  ``compared``: (name, value, limit) of every number the check
    compared, which rides last, under ``checks``."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if build_s is not None:
        out["build_s"] = build_s
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return json.dumps(_finite(out), allow_nan=False)


def _finite(x):
    """JSON has no infinity: a non-finite number is written as the string
    ``"inf"`` / ``"nan"`` (a failed request's latency, a check that could
    not be computed)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return "nan" if math.isnan(x) else ("inf" if x > 0 else "-inf")
    return x
