"""Driver of the federated-training cells: ``FederatedTrainer.run_round()``
of the port, in a loop for the window.

Set-up draws the base weights on the device, makes the captioning corpus
and its missing modalities, builds one trainer, gives it the benchmark's
global adapter, and runs the first round through ``run_round()`` — the
warm-up, and the round the check follows.  The window then runs rounds
until ``--seconds`` have passed (the last one runs to its end; each round
ends in its metrics fetch, which syncs).  After the window the trainer is
freed and the plain reference (``reference/prefix_vlm.py``) runs the
first round again from the same inputs: the cohort, each client's loss,
each client's adapter change and the global's change are compared.

Cell file keys: ``federation`` (clients, sampling, ranks, local steps,
batch, aggregator, editing, LoRA alpha, missing ratio, each client's
number of examples), ``optimizer`` (AdamW), ``task`` (the captioning
task's lengths), ``micro_batch`` (the reference's rows a pass) and
``limits`` (one per compared number).
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

import torch

from perfbench import harness, inputs
from perfbench.reference import prefix_vlm as ref
from perfbench.reference.common import Precision
from perfbench.tracing import Trace, host_spans
from perfbench.work import dim_agg, train_step

#: faults a check can plant under the timed path (``run.py --fault``)
FAULTS = ("frozen", "half_batch")


@contextlib.contextmanager
def plant(fault: str | None):
    """Break the port's local training underneath the round for the run:
    ``frozen`` returns each client's starting adapter unchanged,
    ``half_batch`` trains on the first half of each minibatch (the mean
    over the rest)."""
    if fault is None:
        yield
        return
    from repro_torch.launch import fedround
    orig = fedround._make_local_train

    def make(*a, **kw):
        train = orig(*a, **kw)

        def local_train(base, lora0, rank, batches):
            if fault == "half_batch":
                half = batches["tokens"].shape[1] // 2
                return train(base, lora0, rank,
                             {k: v[:, :half] for k, v in batches.items()})
            _, losses = train(base, lora0, rank, batches)
            return lora0, losses
        return local_train
    fedround._make_local_train = make
    try:
        yield
    finally:
        fedround._make_local_train = orig


def _clone(tree: dict) -> dict:
    return {n: {k: t.detach().clone() for k, t in e.items()}
            for n, e in tree.items()}


def _minus(a: dict, b: dict) -> dict:
    return {(n, k): (a[n][k].float() - b[n][k].float())
            for n in a for k in ("A", "B")}


def _masked(tree: dict, r: int) -> dict:
    out = _clone(tree)
    for e in out.values():
        e["A"][:, r:] = 0
        e["B"][:, :, r:] = 0
    return out


def compare(side: dict, refout: dict, g0: dict, fed: dict, limits: dict
            ) -> list:
    """(name, value, limit) of each compared number.  ``side``: the
    program's first round (or the control's): ``sampled``, ``loss`` (the
    cohort's mean last local loss), ``clients`` (adapters after editing,
    in cohort order) and ``global``.  Adapter changes are compared leaf by
    leaf as the gap of their norms over the larger of the reference's norm
    of that leaf and of the median leaf; leaves whose reference gradient
    stays under a thousandth of the median leaf's are left out."""
    cohort = refout["cohort"]
    out = [("cohort_mismatch", float(side["sampled"] != cohort),
            limits["cohort_mismatch"])]
    ref_loss = statistics.fmean(l[-1] for l in refout["losses"])
    out.append(("loss", abs(side["loss"] - ref_loss) / abs(ref_loss),
                limits["loss"]))
    grads = [g for gm in refout["gmax"] for g in gm.values()]
    g_med = statistics.median(grads)
    keep = [{leaf for leaf, g in gm.items() if g >= 1e-3 * g_med}
            for gm in refout["gmax"]]
    if side["sampled"] != cohort:
        out += [("client_update", math.inf, limits["client_update"]),
                ("global_update", math.inf, limits["global_update"])]
        return out
    gaps = []
    for i, k in enumerate(cohort):
        start = _masked(g0, fed["ranks"][k])
        ds, dr = _minus(side["clients"][i], start), \
            _minus(refout["clients"][i], start)
        gaps.append(_leaf_gap(ds, dr, keep[i]))
    out.append(("client_update", max(gaps), limits["client_update"]))
    kept_any = set().union(*keep)
    out.append(("global_update",
                _leaf_gap(_minus(side["global"], g0),
                          _minus(refout["global"], g0), kept_any),
                limits["global_update"]))
    return out


def _leaf_gap(ds: dict, dr: dict, keep: set) -> float:
    ns = {k: float(ds[k].norm()) for k in keep}
    nr = {k: float(dr[k].norm()) for k in keep}
    med = statistics.median(nr.values())
    return max(abs(ns[k] - nr[k]) / max(nr[k], med, 1e-30) for k in keep)


def run(ctx) -> dict:
    with plant(ctx.fault):
        return _run(ctx)


def _run(ctx) -> dict:
    from repro_torch.core.editing import EditConfig
    from repro_torch.federated.config import FederatedConfig
    from repro_torch.federated.runtime import FederatedTrainer
    from repro_torch.optim import OptimizerConfig
    from repro_torch.telemetry import Telemetry

    cell, m = ctx.cell, ctx.config["model"]
    fed, opt = cell["federation"], cell["optimizer"]
    dev = ctx.device
    dtype = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
    W = inputs.draw_params(ref.param_specs(m), ctx.seed, dev, dtype)
    task = dict(cell["task"], vocab_size=m["vocab_size"],
                num_patches=m["num_vision_tokens"], image_dim=m["vision_dim"])
    shards = inputs.captioning_corpus(task, fed["sizes"], ctx.seed,
                                      fed["missing_ratio"], dev)
    sites = ref.lora_sites(m)
    r_g = max(fed["ranks"])
    g0 = inputs.lora_init(sites, r_g, ctx.seed + 1, dev)
    tel = Telemetry(enabled=ctx.trace)
    fcfg = FederatedConfig(
        num_clients=fed["num_clients"], sample_rate=fed["sample_rate"],
        ranks=tuple(fed["ranks"]), local_steps=fed["local_steps"],
        batch_size=fed["batch_size"], aggregator=fed["aggregator"],
        edit=EditConfig(**fed["edit"]), lora_alpha=fed["lora_alpha"],
        missing_ratio=fed["missing_ratio"])
    ocfg = OptimizerConfig(name="adamw", peak_lr=opt["lr"], b1=opt["b1"],
                           b2=opt["b2"], eps=opt["eps"],
                           weight_decay=opt["weight_decay"],
                           grad_clip=opt["grad_clip"])
    trainer = FederatedTrainer(
        harness.model_config(ctx.config), fcfg, ocfg, shards, shards,
        shards[0], base_params=inputs.nest(W), seed=ctx.seed,
        telemetry=tel, device=dev)
    trainer.server.global_lora = _clone(g0)
    trainer.server.prev_global = _clone(g0)

    first = trainer.run_round()       # the warm-up, which the check follows
    prog = {"sampled": first["sampled"], "loss": first["train_loss"],
            "edited": first["edited_layers"],
            "clients": [{n: {k: t[c].clone() for k, t in e.items()}
                         for n, e in trainer.stacked_lora.items()}
                        for c in first["sampled"]],
            "global": _clone(trainer.server.global_lora)}
    ctx.sync()
    peak_setup = ctx.memory_peak()
    ctx.reset_memory_peak()

    trace = Trace(ctx.trace)
    trace.start()
    t0 = ctx.window_start()
    rounds = 0
    while time.perf_counter() - t0 < ctx.seconds:
        trainer.run_round()
        rounds += 1
    ctx.sync()
    window = time.perf_counter() - t0
    trace.stop()
    peak_window = ctx.memory_peak()

    text = task["seq_len"]
    positions = (max(int(round(fed["sample_rate"] * fed["num_clients"])), 1)
                 * fed["local_steps"] * fed["batch_size"]
                 * (m["num_vision_tokens"] + text))
    n_s = max(int(round(fed["sample_rate"] * fed["num_clients"])), 1)
    record = {
        "window_s": window, "rounds": rounds,
        "round_walls": [t1 - t0_ for n, _, t0_, t1, _, a in tel.tracer.events()
                        if n == "round" and a.get("round", 0) >= 1],
        "flops_per_round": train_step.round_flops(m, fed, text),
        "dim_agg_work_per_round": dim_agg.tree_work(sites, n_s, r_g),
        "peak_window_bytes": peak_window,
        "trace": trace.summary(host_spans(tel), t0, t0 + window)
        if ctx.trace else None}
    out = {"metrics": {"train_tokens_per_s": positions * rounds / window},
           "attempted": rounds + 1, "failed": 0, "record": record,
           "memory_peak_bytes": max(peak_setup, peak_window)}
    del trainer, trace
    gc.collect()
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    def reference(mode):
        return ref.federated_round(m, W, g0, shards, ctx.seed, _ref_fed(fed),
                                   opt, Precision(mode, dtype),
                                   cell["micro_batch"], dev)

    refout = reference("config")
    out["compared"] = compare(prog, refout, g0, fed, cell["limits"])
    same = sum(int(a == b) for a, b in zip(prog["edited"], refout["edited"]))
    out["notes"] = [
        f"first round: program loss {prog['loss']!r}, reference "
        f"{statistics.fmean(l[-1] for l in refout['losses'])!r}; "
        f"reference losses by step {refout['losses']!r}",
        f"edited modules equal to the reference's: {same} of "
        f"{len(prog['edited'])}"]
    if ctx.control:
        ctl = reference("fp8")
        side = {"sampled": ctl["cohort"],
                "loss": statistics.fmean(l[-1] for l in ctl["losses"]),
                "clients": ctl["clients"], "global": ctl["global"]}
        out["control"] = compare(side, refout, g0, fed, cell["limits"])
    return out


def _ref_fed(fed: dict) -> dict:
    return dict(fed, lora_scale=fed["lora_alpha"] / max(fed["ranks"]))
