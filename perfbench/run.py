"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell's file
(``perfbench/workloads/<cell>.json``) names its configuration and its
driver (``perfbench/drivers/<driver>.py``), which does the set-up, the
warm-up, the measured window and the check against the plain reference.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` runs the
window under ``torch.profiler`` and prints its per-layer metrics (one file
each under ``perfbench/metrics/``) with a breakdown of the device's time.
The last line of standard output is the result as one JSON object; the
numbers the check compared, each beside its limit, close standard error.

The port's kernel libraries are built into ``perfbench/.cache/`` (a fixed
directory in the checkout), so only a checkout's first run compiles.
``setup_s`` is process start to the window's start, a compiling run's
build included; the result's ``build_s`` gives each library's seconds to
build in this run (0 = from the cache), so a compiling run's set-up is
told apart from a warm one's.

``--control 1`` also runs the check's control (the reference computed one
precision below the configuration's, put in the program's place) and
prints its numbers; ``--fault <name>`` plants one of the driver's faults
under the timed path.  The benchmark's own runs use neither.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _cache_env() -> None:
    cache = BENCH / ".cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


class Context:
    """What a driver gets: the cell, its configuration, the seed, the
    window's length, the device, and the run's clocks."""

    def __init__(self, *, cell, config, seed, seconds, trace, device,
                 control=False, fault=None):
        self.cell, self.config = cell, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control, self.fault = device, control, fault
        self.setup_s = None

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_start(self) -> float:
        """Sync, stamp the set-up time, and return the window's start."""
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - T_START
        return now

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_memory_peak(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    return ap.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device=None,
         check_imports: bool = True) -> int:
    """Run one cell and print its result.  ``device`` (the tests): run on
    that device and skip the look for a chip.  ``check_imports=False``
    (tests in a process that has loaded JAX for other tests) skips the
    rule on imports, which a test checks in a fresh process."""
    args = parse(argv)
    if not (root / "src" / "repro_torch").is_dir():
        print(f"no port to measure: {root / 'src' / 'repro_torch'} is "
              "missing", file=sys.stderr)
        return 2
    for p in (str(ROOT), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    _cache_env()
    import torch

    from perfbench import harness, peaks

    reg = harness.Registry(root)
    cell = reg.workload(args.workload)
    config = reg.config(cell["config"])
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = reg.driver(cell["driver"])
    if args.fault is not None and args.fault not in driver.FAULTS:
        print(f"unknown fault {args.fault!r}; {cell['driver']} plants "
              f"{driver.FAULTS}", file=sys.stderr)
        return 2
    ctx = Context(cell=cell, config=config, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=device, control=bool(args.control),
                  fault=args.fault)
    out = driver.run(ctx)

    bad = harness.forbidden_modules() if check_imports else []
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 4
    rec = out["record"]
    if args.trace:
        metrics = {}
        for m in reg.metrics_for(args.workload):
            v = reg.metric(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": (ctx.setup_s if m["name"] == "setup_s"
                                         else out["metrics"][m["name"]]),
                               "unit": m["unit"]}
                   for m in reg.end_to_end_for(args.workload)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit_w": peaks.power_limit_w()
           if device.type == "cuda" else None}
    brk = None
    if args.trace:
        from perfbench.tracing import breakdown
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        brk = breakdown(rec["trace"])
    compared = out["compared"]
    correct = all(v <= lim for _, v, lim in compared)
    if "control" in out:
        ctl_ok = all(v <= lim for _, v, lim in out["control"])
        print("control: " + json.dumps(
            {"correct": ctl_ok,
             "checks": {n: [v, lim] for n, v, lim in out["control"]}}),
            file=sys.stderr)
    from repro_torch.kernels.build import BUILD_INFO
    built = {k: v["seconds"] for k, v in BUILD_INFO.items()}
    print(f"kernel libraries (seconds to build; 0 = from "
          f"{os.environ['REPRO_TORCH_BUILD_DIR']}): {built}", file=sys.stderr)
    for line in out.get("notes", ()):
        print(line, file=sys.stderr)
    for name, v, lim in compared:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct=correct, attempted=out["attempted"],
                              failed=out["failed"], metrics=metrics,
                              device=dev, compared=compared,
                              breakdown=brk, build_s=built), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
