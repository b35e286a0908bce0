#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``);
2. build — the serving path's CUDA kernel, from the sources in this
   checkout;
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving path's shapes, with the stated tolerances, and timed with
   CUDA events (kernel, plain version, library yardstick) beside the
   card's bound for the same work;
4. serve — qwen2-0.5b at full width in bf16 (random weights from a seed),
   12 tenants of ranks 8/16/32/64 through an 8-slot adapter bank, 48
   requests with chunked prefill and ``lora_backend="grouped"``; every
   request must complete with its tokens, cold tenants must page in, and
   the kernel's launch count must equal 2 LoRA sites × 24 layers × the
   serve/prefill calls;
5. agreement — the same model in f32 serves 16 requests through the
   ``grouped`` and the ``gather`` backends: greedy tokens must be equal.

It prints a JSON line describing every kernel, the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it fails and prints no
result.  A full record (every kernel case, the compiler's register and
shared-memory report, the serve counters) goes to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# data-sheet peaks (NVIDIA): bytes/s of device memory, dense bf16 tensor
# core and f32 (non-tensor-core) operations/s
PEAKS = [("H200", 4.8e12, 989e12, 67e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H100", 3.35e12, 989e12, 67e12)]

KERNEL_SHAPES = [(16, 896, 896), (16, 896, 128), (512, 896, 896),
                 (512, 896, 128)]
N_TENANTS, RANKS, BANK_SLOTS = 12, (8, 16, 32, 64), 8


def peaks_for(name: str):
    for key, bw, bf16, f32 in PEAKS:
        if key in name:
            return bw, bf16, f32
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def cuda_time_ms(fn, arg_sets, iters: int = 60, warmup: int = 5) -> float:
    """Mean device ms per call over ``iters`` calls cycling through
    ``arg_sets`` (enough distinct weights that each call finds them outside
    L2, as a decode step over 24 layers does).  A sleep kernel holds the
    stream while the host enqueues every call, so the events time the
    device and not the host's launch rate."""
    import torch
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)         # ~50 ms at the H100's clocks
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_kernels(dev_name: str) -> dict:
    """grouped_lora_matmul vs its plain version at the serving shapes."""
    import torch

    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.kernels.ref import grouped_lora_matmul_ref

    bw, peak_bf16, peak_f32 = peaks_for(dev_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    G, r, scale = 8, 64, 0.25
    cases = []
    # x/W dtype, bank dtype: f32; bf16; and the serve path's bf16 model
    # over an f32 bank
    for xdt, adt in [(torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32)]:
        for M, K, N in KERNEL_SHAPES:
            sx = torch.finfo(xdt).bits // 8
            sa = torch.finfo(adt).bits // 8
            n_sets = max(2, int(120e6 // (K * N * sx + G * r * (K + N) * sa)))
            sets = []
            for _ in range(n_sets):
                w = (torch.randn(K, N, generator=gen, device="cuda")
                     * K ** -0.5).to(xdt)
                a = (torch.randn(G, r, K, generator=gen, device="cuda")
                     * K ** -0.5).to(adt)
                b = (torch.randn(G, N, r, generator=gen, device="cuda")
                     * r ** -0.5).to(adt)
                sets.append((w, a, b))
            x = torch.randn(M, K, generator=gen, device="cuda").to(xdt)
            # idx with repeats: rows cycle over 6 of the 8 bank slots
            idx = (torch.arange(M, device="cuda", dtype=torch.int32) * 5) % 6
            w, a, b = sets[0]
            y = glm.grouped_lora_matmul_cuda(x, w, a, b, idx, scale=scale)
            torch.cuda.synchronize()
            ref = grouped_lora_matmul_ref(x.float(), w.float(), a.float(),
                                          b.float(), idx, scale=scale)
            err = (y.float() - ref).abs()
            tol = 1e-4 if xdt == adt == torch.float32 else 2e-2
            if not bool((err <= tol + tol * ref.abs()).all()):
                raise AssertionError(
                    f"grouped_lora_matmul {M}x{K}x{N} {xdt}/{adt}: max err "
                    f"{err.max().item():.3e} beyond atol=rtol={tol}")
            kernel_ms = cuda_time_ms(
                lambda w, a, b: glm.grouped_lora_matmul_cuda(
                    x, w, a, b, idx, scale=scale), sets)
            plain_ms = cuda_time_ms(
                lambda w, a, b: grouped_lora_matmul_ref(x, w, a, b, idx,
                                                        scale=scale), sets)
            library_ms = cuda_time_ms(lambda w, a, b: torch.matmul(x, w), sets)
            n_adapters = len(set(idx.tolist()))
            nbytes = (K * N * sx + M * K * sx + M * N * sx
                      + n_adapters * r * (K + N) * sa + M * 4)
            flops = 2 * M * K * N + 2 * M * r * (K + N)
            peak = peak_bf16 if xdt == torch.bfloat16 else peak_f32
            t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
            cases.append({
                "M": M, "K": K, "N": N, "G": G, "r": r,
                "x_dtype": str(xdt).split(".")[-1],
                "bank_dtype": str(adt).split(".")[-1],
                "max_abs_err": err.max().item(), "tol": tol,
                "ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"kernel grouped_lora_matmul M={M} K={K} N={N} "
                  f"{cases[-1]['x_dtype']}/{cases[-1]['bank_dtype']}: "
                  f"err {cases[-1]['max_abs_err']:.3e} kernel {kernel_ms:.4f} "
                  f"ms plain {plain_ms:.4f} ms matmul {library_ms:.4f} ms "
                  f"bound {cases[-1]['bound_ms']:.4f} ms "
                  f"({cases[-1]['bound_by']})", flush=True)
    return {"cases": cases}


def make_adapters(cfg, rng, n: int):
    import numpy as np

    from repro_torch.models.transformer import lora_specs
    specs = lora_specs(cfg)
    out = {}
    for t in range(n):
        rank = RANKS[t % len(RANKS)]
        out[f"tenant{t}"] = ({s.name: {
            "A": (rng.standard_normal((s.num_layers, rank, s.in_dim))
                  * s.in_dim ** -0.5).astype(np.float32),
            "B": (rng.standard_normal((s.num_layers, s.out_dim, rank))
                  * rank ** -0.5).astype(np.float32)} for s in specs}, rank)
    return out


def make_requests(cfg, rng, n: int, *, gen_len=None):
    from repro_torch.serving import Request
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(16, 129))
        reqs.append(Request(
            adapter_id=f"tenant{int(rng.integers(0, N_TENANTS))}",
            prompt_tokens=rng.integers(0, cfg.vocab_size, size=plen),
            gen_len=gen_len or int(rng.integers(16, 65))))
    return reqs


def serve(cfg, params, adapters, requests, *, backend: str):
    import torch

    from repro_torch.serving import AdapterStore, ServingEngine
    store = AdapterStore(slots=BANK_SLOTS, rank=max(RANKS))
    for tid, (lora, rank) in adapters.items():
        store.register(tid, lora, rank)
    eng = ServingEngine(cfg, params, store, lora_scale=16.0 / max(RANKS),
                        max_slots=16, max_prompt=128, max_gen=64,
                        prefill_chunk=32, lora_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(requests)
    torch.cuda.synchronize()
    return eng, store, done, time.perf_counter() - t0


def phase_serve() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_lora_matmul as glm
    from repro_torch.models.transformer import init_params

    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(0)
    params = init_params(cfg, seed=0)                  # bf16 on the card
    adapters = make_adapters(cfg, rng, N_TENANTS)
    reqs = make_requests(cfg, rng, 48)
    glm.reset_launches()
    eng, store, done, wall = serve(cfg, params, adapters, reqs,
                                   backend="grouped")
    launches = glm.launches
    dc = eng.dispatch_count
    calls = dc["serve_step"] + dc["serve_prefill"]
    by_uid = {d["uid"]: d for d in done}
    for q in reqs:
        d = by_uid[q.uid]
        if d["status"] != "ok" or len(d["tokens"]) != q.gen_len:
            raise AssertionError(f"request {q.uid}: status {d['status']}, "
                                 f"{len(d['tokens'])} of {q.gen_len} tokens")
        if not ((d["tokens"] >= 0) & (d["tokens"] < cfg.vocab_size)).all():
            raise AssertionError(f"request {q.uid}: token out of vocabulary")
    if store.loads <= BANK_SLOTS:
        raise AssertionError(f"only {store.loads} page-ins for {N_TENANTS} "
                             f"tenants over {BANK_SLOTS} slots")
    want = 2 * cfg.num_blocks * calls
    if launches != want:
        raise AssertionError(f"grouped_lora_matmul launched {launches} times, "
                             f"expected 2*{cfg.num_blocks}*{calls} = {want}")
    tokens = sum(q.gen_len for q in reqs)
    out = {"requests": len(reqs), "steps": eng.steps,
           "dispatch_count": dict(dc), "adapter_loads": store.loads,
           "evictions": store.evictions, "wall_s": wall,
           "generated_tokens": tokens, "tokens_per_s": tokens / wall,
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"serve (smoke run, not a benchmark): qwen2-0.5b bf16, "
          f"{len(reqs)} requests, {eng.steps} steps, {calls} serve/prefill "
          f"calls, {store.loads} page-ins, {wall:.2f} s wall, "
          f"{tokens / wall:.1f} generated tokens/s, {launches} kernel "
          f"launches", flush=True)
    return out


def phase_agreement() -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("qwen2-0.5b")
    rng = np.random.default_rng(1)
    params = init_params(cfg, seed=0, dtype="float32")
    adapters = make_adapters(cfg, rng, N_TENANTS)
    reqs = make_requests(cfg, rng, 16, gen_len=32)
    toks = {}
    for backend in ("grouped", "gather"):
        _, _, done, _ = serve(cfg, params, adapters, reqs, backend=backend)
        toks[backend] = {d["uid"]: d["tokens"].tolist() for d in done}
    bad = [u for u in toks["gather"] if toks["gather"][u] != toks["grouped"][u]]
    if bad or len(toks["gather"]) != len(reqs):
        raise AssertionError(f"f32 grouped vs gather greedy tokens differ for "
                             f"requests {bad}")
    print(f"agreement: f32 grouped == gather greedy tokens for {len(reqs)} "
          f"requests x 32 tokens", flush=True)
    return {"requests": len(reqs), "identical": True}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev_name = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)

    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.build("grouped_lora_matmul")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s "
          f"({', '.join(sorted(kbuild.BUILD_INFO))})", flush=True)

    kern = phase_kernels(dev_name)
    served = phase_serve()
    agree = phase_agreement()

    cases = kern["cases"]
    # headline: the decode step's shape and dtypes on the serve path
    head = next(c for c in cases if (c["M"], c["N"]) == (16, 896)
                and c["x_dtype"] == "bfloat16" and c["bank_dtype"] == "float32")
    record = {
        "name": "grouped_lora_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_gather_matmul.py:71",
        "launches": served["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_err_f32": max(c["max_abs_err"] for c in cases
                           if c["x_dtype"] == "float32"),
        "max_err_bf16": max(c["max_abs_err"] for c in cases
                            if c["x_dtype"] == "bfloat16"),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
        "library_call": "torch.matmul(x, W): the base product only",
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "shape": {k: head[k] for k in ("M", "K", "N", "G", "r", "x_dtype",
                                       "bank_dtype")}}
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_s": build_s,
                   "build_logs": {k: v["log"]
                                  for k, v in kbuild.BUILD_INFO.items()},
                   "kernels": [record],
                   "kernel_cases": cases, "serve": served,
                   "agreement": agree}, f, indent=1)
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
