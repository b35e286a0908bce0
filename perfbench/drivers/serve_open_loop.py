"""Driver of the serving cells: the port's ``ServingEngine`` under an open
loop of requests from ``traffic.py``.

Set-up draws the base weights on the device and the tenants' adapters,
registers the adapters in an ``AdapterStore``, builds the engine, and
warms it up by filling every slot once with short requests (then
``reset()``; the store's residency stays).  The window submits each
request when it is due and calls ``step()``; a CUDA event recorded after
each step, anchored to the host clock by a sync at the window's start and
read after the window, times the step's end on the device without a sync
inside the window.

* ``arrivals: "backlog"`` (offline batches): everything is due at 0; the
  window ends after ``--seconds``; ``serve_tokens_per_s`` counts the
  tokens generated by the window's steps (requests still in flight count
  the tokens they have), over the window.
* Poisson or bursty arrivals: every request due in the window is served
  to its end (the drain counts); ``ttft_p95_ms`` is the 95th percentile
  of due → the device's end of the step that produced the first token,
  ``tpot_p95_ms`` of (completion − first token) / (tokens − 1), the
  completion being the host clock when that step returns (its retire
  fetch syncs).  A request that fails or never finishes counts as
  infinitely late.

The check: a sample drawn from the seed of the finished requests, the one
with the most positions in it, goes through the plain reference
(``reference/hybrid.py``, f32) once over prompt + served tokens.  At each
served position the gap by which the served token's logit lies below the
reference's best is taken.  Two numbers are compared: the gaps' mean,
and the count of served tokens whose gap exceeds ``check["gap_over"]``
(a wrong token: one the reference ranks far below its best).  A bf16
step parts from the f32 reference at near ties, a router's among them,
and the part carries on through the Mamba state, so the widest gap
alone cannot tell the program from the control; the mean can, and the
count sees a single wrong token, which moves the mean by little.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time

import numpy as np
import torch

from perfbench import harness, inputs, traffic
from perfbench.reference import hybrid as ref
from perfbench.reference.common import Precision
from perfbench.tracing import Trace, host_spans
from perfbench.work import bgmv, serve_step

#: faults a check can plant under the timed path (``run.py --fault``)
FAULTS = ("token", "stale_state")


@contextlib.contextmanager
def plant(fault: str | None):
    """Break the port underneath the window for the run: ``token`` alters
    each finished request's first served token where the engine hands it
    out; ``stale_state`` makes every Mamba decode leave its recurrent
    state as it found it."""
    if fault is None:
        yield
        return
    from repro_torch.models import layers
    from repro_torch.serving.engine import ServingEngine
    orig, orig_decode = ServingEngine._retire_finished, layers.mamba_decode
    if fault == "token":
        def retire(self):
            out = orig(self)
            for rec in out:
                if len(rec["tokens"]):
                    rec["tokens"][0] = (rec["tokens"][0] + 1) \
                        % self.cfg.vocab_size
            return out
        ServingEngine._retire_finished = retire
    else:
        def decode(params, x, cache, cfg, **kw):
            h = cache["h"].clone()
            out = orig_decode(params, x, cache, cfg, **kw)
            cache["h"].copy_(h)
            return out
        layers.mamba_decode = decode
    try:
        yield
    finally:
        ServingEngine._retire_finished = orig
        layers.mamba_decode = orig_decode


def _requests(mix, seconds, seed, vocab, tenant_ids):
    from repro_torch.serving import Request
    t = traffic.requests(mix, seconds, seed)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 5]))
    reqs = [Request(adapter_id=tenant_ids[int(t["tenant"][i])],
                    prompt_tokens=rng.integers(4, vocab,
                                               size=int(t["prompt"][i])),
                    gen_len=int(t["gen"][i]))
            for i in range(t["due"].shape[0])]
    return reqs, t["due"]


def run(ctx) -> dict:
    with plant(ctx.fault):
        return _run(ctx)


def _run(ctx) -> dict:
    from repro_torch.serving import AdapterStore, Request, ServingEngine
    from repro_torch.telemetry import Telemetry

    cell, m = ctx.cell, ctx.config["model"]
    mix, ecfg = cell["traffic"], cell["engine"]
    dev = ctx.device
    dtype = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
    W = inputs.draw_params(ref.param_specs(m), ctx.seed, dev, dtype)
    sites = ref.lora_sites(m)
    cycle = cell["tenant_ranks"]
    ranks = [cycle[t % len(cycle)] for t in range(mix["tenants"])]
    adapters = inputs.tenant_adapters(sites, ranks, ctx.seed + 2, dev, dtype,
                                      cell["adapter_b_std"])
    store = AdapterStore(slots=ecfg["bank_slots"], rank=max(cycle),
                         device=dev)
    ids = [f"tenant{t}" for t in range(mix["tenants"])]
    for t, lo in enumerate(adapters):
        store.register(ids[t], lo, ranks[t])
    tel = Telemetry(enabled=ctx.trace)
    slots = ecfg["slots"]
    eng = ServingEngine(harness.model_config(ctx.config), inputs.nest(W),
                        store, lora_scale=cell["lora_scale"],
                        max_slots=slots, max_prompt=mix["prompt"]["max"],
                        max_gen=mix["gen"]["max"],
                        lora_backend=ecfg["lora_backend"], telemetry=tel,
                        device=dev)
    reqs, due = _requests(mix, ctx.seconds, ctx.seed, m["vocab_size"], ids)
    # warm-up: every slot filled once, by the most popular tenants
    wrng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 9]))
    short = min(8, mix["prompt"]["max"], mix["gen"]["max"])
    eng.run([Request(adapter_id=ids[s % min(ecfg["bank_slots"], len(ids))],
                     prompt_tokens=wrng.integers(4, m["vocab_size"], short),
                     gen_len=short) for s in range(slots)])
    eng.reset()
    ctx.sync()
    peak_setup = ctx.memory_peak()
    ctx.reset_memory_peak()
    pager0 = dict(store.paging_stats)

    backlog = mix["arrivals"] == "backlog"
    by_uid = {r.uid: i for i, r in enumerate(reqs)}
    adm = np.full(len(reqs), -1)          # step that admitted (1-based)
    first = np.full(len(reqs), -1)        # step that produced token 1
    done = np.full(len(reqs), -1)
    done_t = np.full(len(reqs), np.nan)   # host clock at that step's return
    status = [None] * len(reqs)
    served = {}
    pending = collections.deque()
    active, no_first = set(), set()
    step_rows, step_adapters = [], []
    events = []
    start = torch.cuda.Event(enable_timing=True) if dev.type == "cuda" \
        else None
    trace = Trace(ctx.trace)
    trace.start()
    t0 = ctx.window_start()
    if start is not None:
        start.record()
    nxt = 0
    steps = 0
    limit = ctx.seconds + cell.get("drain_s", 120.0)
    while True:
        now = time.perf_counter() - t0
        while nxt < len(reqs) and due[nxt] <= now:
            eng.submit(reqs[nxt])
            pending.append(nxt)
            nxt += 1
        if backlog and now >= ctx.seconds:
            break
        if nxt == len(reqs) and not pending and not active:
            break                         # every request served
        if not backlog and now >= limit:
            break
        if not pending and not active:
            time.sleep(max(min(due[nxt] - now, 0.01), 0))
            continue
        out = eng.step()
        steps += 1
        if start is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        while pending and reqs[pending[0]].admitted_at is not None:
            i = pending.popleft()
            adm[i] = steps
            active.add(i)
            no_first.add(i)
        step_rows.append(len(active))
        step_adapters.append(len({reqs[i].adapter_id for i in active}))
        for i in [i for i in no_first if reqs[i].first_token_at is not None]:
            first[i] = steps
            no_first.discard(i)
        t_ret = time.perf_counter() - t0
        for rec in out:
            i = by_uid[rec["uid"]]
            done[i], done_t[i], status[i] = steps, t_ret, rec["status"]
            served[i] = rec["tokens"]
            active.discard(i)
            no_first.discard(i)
    ctx.sync()
    window = time.perf_counter() - t0
    trace.stop()
    peak_window = ctx.memory_peak()
    dev_t = np.array([start.elapsed_time(e) / 1e3 for e in events]) \
        if start is not None else np.cumsum(np.full(steps, window / steps))

    def dev_at(k):                       # device end of step k (1-based)
        return dev_t[k - 1]

    admitted = np.flatnonzero(adm > 0)
    positions = {}
    for i in admitted:
        end = done[i] if done[i] > 0 else steps
        positions[i] = int(end - adm[i] + 1)
    gen_tok = {i: (reqs[i].gen_len if done[i] > 0 else
                   max(0, min(positions[i] - len(reqs[i].prompt_tokens) + 1,
                              reqs[i].gen_len)))
               for i in admitted}
    rank_of = dict(zip(ids, ranks))
    flops = sum(serve_step.request_flops(m, rank_of[reqs[i].adapter_id],
                                         positions[i]) for i in admitted)
    bw = [bgmv.step_work(sites, rows, max(cycle), a)
          for rows, a in zip(step_rows, step_adapters)]
    record = {"window_s": window, "steps": steps,
              "flops": flops,
              "bgmv_work": (sum(f for f, _ in bw), sum(b for _, b in bw)),
              "pager": {k: store.paging_stats[k] - pager0[k]
                        for k in ("hits", "misses")},
              "peak_window_bytes": peak_window,
              "trace": trace.summary(host_spans(tel), t0, t0 + window)
              if ctx.trace else None}
    metrics = {}
    if backlog:
        metrics["serve_tokens_per_s"] = sum(gen_tok.values()) / window
        attempted = len(admitted)
        failed = sum(1 for i in admitted if done[i] > 0
                     and status[i] != "ok")
    else:
        ttft, tpot, wait = [], [], []
        for i in range(len(reqs)):
            ok = done[i] > 0 and status[i] == "ok" and first[i] > 0
            ttft.append(dev_at(first[i]) - due[i] if ok else np.inf)
            g = reqs[i].gen_len
            tpot.append((done_t[i] - dev_at(first[i])) / (g - 1)
                        if ok and g > 1 else (0.0 if ok else np.inf))
            wait.append(reqs[i].admitted_at - t0 - due[i]
                        if adm[i] > 0 else np.inf)
        metrics["ttft_p95_ms"] = harness.p95(ttft) * 1e3
        metrics["tpot_p95_ms"] = harness.p95(tpot) * 1e3
        record["queue_wait_p95_ms"] = harness.p95(wait) * 1e3
        attempted = len(reqs)
        failed = sum(1 for i in range(len(reqs))
                     if not (done[i] > 0 and status[i] == "ok"))
    out = {"metrics": metrics, "attempted": attempted, "failed": failed,
           "record": record,
           "memory_peak_bytes": max(peak_setup, peak_window)}

    # ---- the check, once the program's state is freed -------------------
    finished = [i for i in served if status[i] == "ok"]
    del eng, store, trace
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = _sample(finished, reqs, ctx.seed, cell["check"])
    seqs, spans = [], []
    for i in sample:
        p = np.asarray(reqs[i].prompt_tokens)
        s = np.asarray(served[i], np.int64)
        seqs.append(np.concatenate([p, s[:-1]]))
        spans.append((len(p) - 1, s))
    chk = cell["check"]
    if not sample:
        out["compared"] = [("logit_gap_mean", np.inf, chk["limit"]),
                           ("wrong_tokens", np.inf, chk["over_limit"])]
        out["notes"] = ["no request finished"]
        return out
    lo_rows = [adapters[ids.index(reqs[i].adapter_id)] for i in sample]
    lg = _logits(m, W, seqs, lo_rows, cell["lora_scale"],
                 Precision("f32", dtype), dev)
    gaps = _gaps(lg, spans)
    out["compared"] = _compared(gaps, chk)
    out["notes"] = [f"served gaps: {_describe(gaps)}"]
    if ctx.control:
        lq = _logits(m, W, seqs, lo_rows, cell["lora_scale"],
                     Precision("fp8", dtype), dev)
        picks = [(a, lq[r, a:a + len(s)].argmax(-1).cpu().numpy())
                 for r, (a, s) in enumerate(spans)]
        cg = _gaps(lg, picks)
        out["control"] = _compared(cg, chk)
        out["notes"].append(f"control gaps: {_describe(cg)}")
    return out


def _compared(g: np.ndarray, chk: dict) -> list:
    return [("logit_gap_mean", float(g.mean()), chk["limit"]),
            ("wrong_tokens", int((g > chk["gap_over"]).sum()),
             chk["over_limit"])]


def _describe(g: np.ndarray) -> str:
    q = np.quantile(g, [0.5, 0.9, 0.99])
    return (f"n {g.size} max {g.max():.4f} p99 {q[2]:.4f} p90 {q[1]:.4f} "
            f"median {q[0]:.4f} mean {g.mean():.4f} "
            f"share>0 {np.mean(g > 0):.4f} share>0.1 {np.mean(g > 0.1):.4f}")


def _sample(finished, reqs, seed, chk) -> list:
    """The finished request with the most positions, then others drawn
    from the seed until ``chk["tokens"]`` served tokens or ``chk["rows"]``
    requests."""
    if not finished:
        return []
    size = lambda i: len(reqs[i].prompt_tokens) + reqs[i].gen_len
    first = max(finished, key=size)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    rest = [finished[j] for j in rng.permutation(len(finished))
            if finished[j] != first]
    out, tok = [first], reqs[first].gen_len
    for i in rest:
        if tok >= chk["tokens"] or len(out) >= chk["rows"]:
            break
        out.append(i)
        tok += reqs[i].gen_len
    return out


@torch.no_grad()
def _logits(m, W, seqs, adapters, scale, prec, dev) -> torch.Tensor:
    S = max(len(s) for s in seqs)
    toks = torch.zeros((len(seqs), S), dtype=torch.long, device=dev)
    for r, s in enumerate(seqs):
        toks[r, :len(s)] = torch.from_numpy(s)
    return ref.logits(m, W, toks, adapters, scale, prec)


def _gaps(lg: torch.Tensor, spans) -> np.ndarray:
    """At every served position, the gap between the reference's best
    logit and the logit of the token served there."""
    out = []
    for r, (a, toks) in enumerate(spans):
        rows = lg[r, a:a + len(toks)]
        t = torch.as_tensor(np.asarray(toks), device=lg.device)
        out.append((rows.max(-1).values - rows.gather(-1, t[:, None])[:, 0])
                   .cpu().numpy())
    return np.concatenate(out)
