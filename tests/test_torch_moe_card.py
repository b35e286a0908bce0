"""The fused MoE's kernels (``repro_torch.kernels.moe``, ``csrc/moe.cu``) on
the card, against their plain version ``moe_fused_ref`` on the same logits
and against the plain dispatch (``layers.moe_forward`` with gradients on),
in bf16 at the Granite 4.0-H serve cell's shapes (T 128, E 72, top-10, d
4096, experts of 768, a shared expert of 1536), at a 2048-token prefill,
with drops, and at the published widths of the other MoE configurations
that serve through them (Jamba v0.1: E 16, top-2, experts of 14336;
DeepSeek-V2: d 5120, E 160, top-6, experts of 1536 and two shared;
Llama 4 Scout: d 5120, E 16, top-1, experts of 8192 and one shared), each
at decode (T 128) and at a 2048-token prefill chunk; an f32 layer keeps the
plain dispatch; then the launches a MoE layer makes inside one
``decode_chunk``, the times beside the plain dispatch and the bound, both
tilings of the grouped kernels timed over T, and the gate's choice against
the plain dispatch over T and the capacity factor.  Skipped without an
NVIDIA GPU; run on the card with

    python -m pytest -q -s tests/test_torch_moe_card.py

Limits: the router's integers equal ``moe_fused_ref``'s bit for bit (both
order the same logits); against ``layers.moe_route``, which orders the
probabilities, a token may differ only where two of its probabilities are
equal in f32 while their logits are not (reported).  ``y``: bf16 within
two bf16 steps (a step: 2^-7 of the largest output) of the plain version
(the two round h and each pick's output after sums taken in another
order, a step each); the plain dispatch, which rounds every product and
partial sum to bf16, within eight steps.  ``y`` the same bits on a second
call.
"""

import dataclasses
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import moe as MK  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

# name -> (T, d, E, K, ff, shared experts, shared width each, capacity
# factor, dtype); the published widths of ``repro_torch.configs``
_GRANITE = (4096, 72, 10, 768, 1, 1536, 7.2)
_JAMBA = (4096, 16, 2, 14336, 0, 0, 1.25)
_DEEPSEEK = (5120, 160, 6, 1536, 2, 1536, 1.25)
_LLAMA4 = (5120, 16, 1, 8192, 1, 8192, 1.25)
CASES = {
    "granite.decode": (128, *_GRANITE, "bfloat16"),
    "granite.prefill": (2048, *_GRANITE, "bfloat16"),
    "granite.drops": (128, *_GRANITE[:-1], 0.5, "bfloat16"),
    "jamba.decode": (128, *_JAMBA, "bfloat16"),
    "jamba.prefill": (2048, *_JAMBA, "bfloat16"),
    "deepseek.decode": (128, *_DEEPSEEK, "bfloat16"),
    "deepseek.prefill": (2048, *_DEEPSEEK, "bfloat16"),
    "llama4.decode": (128, *_LLAMA4, "bfloat16"),
    "llama4.prefill": (2048, *_LLAMA4, "bfloat16"),
    "small.f32": (40, 256, 16, 2, 128, 2, 64, 1.0, "float32"),
}
BF16 = [n for n in CASES if CASES[n][-1] == "bfloat16"]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "moe_card.jsonl")


@pytest.fixture
def chip():
    """Skip the test unless a CUDA device is there (decided here, in a
    fixture, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
    return torch.device("cuda", 0)


def _record(rec):
    print(json.dumps(rec))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _world(name, dev, seed=0, tokens=None):
    T, d, E, K, ff, ns, ffs, cf, dt = CASES[name]
    T = tokens or T
    dtype = getattr(torch, dt)
    g = torch.Generator(device=dev).manual_seed(seed)

    def nrm(*shape, fan, dtype=dtype):
        return (torch.randn(shape, generator=g, device=dev) * fan ** -0.5
                ).to(dtype)

    p = {"router": nrm(d, E, fan=d, dtype=torch.float32),
         "w1": nrm(E, d, ff, fan=d), "w3": nrm(E, d, ff, fan=d),
         "w2": nrm(E, ff, d, fan=ff)}
    if ns:
        w = ns * ffs
        p["shared"] = {"w1": nrm(d, w, fan=d), "w3": nrm(d, w, fan=d),
                       "w2": nrm(w, d, fan=w)}
    x = torch.randn((T, d), generator=g, device=dev).to(dtype)
    cfg = dataclasses.replace(
        get_reduced_config("deepseek-v2-236b"), d_model=d, dtype=dt,
        moe=MoEConfig(num_experts=E, experts_per_token=K, d_ff_expert=ff,
                      num_shared_experts=ns, d_ff_shared=ffs or None,
                      capacity_factor=cf))
    return cfg, p, x


def _tie_flips(logits, ids_a, ids_b):
    """Tokens whose picks differ, each with the probabilities that
    decided it: a flip is allowed only between equal f32 probabilities."""
    probs = torch.softmax(logits, -1)
    out = []
    for t in torch.nonzero((ids_a != ids_b).any(-1)).flatten().tolist():
        pa = probs[t, ids_a[t].long()].tolist()
        pb = probs[t, ids_b[t].long()].tolist()
        out.append({"token": t, "ours": ids_a[t].tolist(),
                    "plain": ids_b[t].tolist(), "p_ours": pa, "p_plain": pb,
                    "equal": sorted(pa) == sorted(pb)})
    return out


@pytest.mark.parametrize("name", BF16)
def test_kernels_match_the_plain_version(chip, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _world(name, chip)
    T, K = x.shape[0], cfg.moe.experts_per_token
    C = TL.moe_capacity(cfg, T)
    logits = x.float() @ p["router"]
    kw = dict(top_k=K, capacity=C, aux_coef=cfg.moe.aux_loss_coef, route=True)
    MK.reset_launches()
    with torch.no_grad():
        y, aux, route = MK.moe_fused_cuda(x, logits, p, **kw)
        y2, aux2, _ = MK.moe_fused_cuda(x, logits, p, **kw)
        ry, raux, rroute = MK.moe_fused_ref(x, logits, p, **kw)
        # the plain dispatch's decisions (gradients on keep its dispatch)
        _, gates, ids, pos, kept = TL.moe_route(p["router"], x, cfg)
    torch.cuda.synchronize()
    with torch.enable_grad():
        py, paux = TL.moe_forward(p, x[None], cfg)
    flips = _tie_flips(logits, route["ids"], ids)
    scale = ry.float().abs().max().item()
    err = (y.float() - ry.float()).abs().max().item()
    perr = (y.float() - py[0].float()).abs().max().item()
    tol, ptol = 2 * 2 ** -7 * scale, 8 * 2 ** -7 * scale
    _record({"case": name, "tile_rows": MK.tile_rows(T, K, cfg.moe.num_experts),
             "err_vs_ref": err, "tol": tol,
             "err_vs_plain_dispatch": perr, "plain_tol": ptol,
             "scale": scale, "aux": aux.item(), "aux_ref": raux.item(),
             "aux_plain": paux.item(),
             "kept": int(route["kept"].sum()), "picks": T * K,
             "tie_flips": flips})
    assert MK.launches == 2
    for k in ("ids", "pos", "kept"):
        assert torch.equal(route[k].long(), rroute[k].long()), k
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    if name.endswith("drops"):
        assert not bool(route["kept"].all())
    assert err <= tol, (err, tol)
    assert abs(aux.item() - raux.item()) <= 1e-6 * max(1.0, abs(raux.item()))
    assert all(f["equal"] for f in flips), flips
    if not flips:
        assert torch.equal(route["pos"].long(), pos)
        assert torch.equal(route["kept"], kept)
        assert perr <= ptol, (perr, ptol)
        assert abs(aux.item() - paux.item()) <= 1e-6


def test_f32_keeps_the_plain_dispatch(chip):
    """An f32 layer on the card, gradients off: the plain dispatch
    (``plain`` counts it, no fused launch)."""
    cfg, p, x = _world("small.f32", chip)
    MK.reset_launches()
    with torch.no_grad():
        y, _ = TL.moe_forward(p, x[None], cfg)
    torch.cuda.synchronize()
    assert MK.launches == 0 and MK.plain == 1
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


def test_no_host_sync_in_the_fused_route(chip):
    cfg, p, x = _world("granite.decode", chip)
    with torch.no_grad():
        TL.moe_forward(p, x[None], cfg)         # build and warm up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = TL.moe_forward(p, x[None], cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(aux)


def test_launches_per_moe_layer_in_decode_chunk(chip, monkeypatch):
    """One ``decode_chunk`` (16 slots, one token each) of a reduced hybrid
    Jamba with 4 MoE layers of 16 experts, top-4 and a shared expert, in
    bf16: every MoE layer takes the fused route (``launches``, ``plain``)
    and launches at most 6 kernels (runtime launch calls inside the layer's
    host range of the profiler: the router's cast and product, then the
    route, up and down kernels)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    base = get_reduced_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(
        base, num_layers=8, dtype="bfloat16",
        moe=dataclasses.replace(base.moe, num_experts=16, experts_per_token=4,
                                num_shared_experts=1, d_ff_shared=256))
    n_moe = sum(1 for i in range(cfg.num_layers)
                if i % cfg.moe.layer_period == cfg.moe.layer_offset)
    params = TT.init_params(cfg, seed=0, device=chip)
    B = 16
    cache = TT.init_cache(cfg, params, B, 8)
    emb = torch.randn((B, 1, cfg.d_model), device=chip).to(torch.bfloat16)
    pos = torch.zeros((B,), dtype=torch.long, device=chip)
    orig = TL.moe_forward

    def ranged(*a, **k):
        with record_function("moe_layer"):
            return orig(*a, **k)

    monkeypatch.setattr(TL, "moe_forward", ranged)
    with torch.no_grad():
        TT.decode_chunk(cfg, params, cache, emb, pos)      # warm up
        torch.cuda.synchronize()
        MK.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            TT.decode_chunk(cfg, params, cache, emb, pos)
            torch.cuda.synchronize()
    assert MK.launches == n_moe and MK.plain == 0
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [e.time_range for e in cpu if e.name == "moe_layer"]
    calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")
    inside = [[e for e in cpu if r.start <= e.time_range.start
               and e.time_range.end <= r.end] for r in ranges]
    per = [sum(e.name in calls for e in evs) for evs in inside]
    _record({"case": "launches", "moe_layers": n_moe, "per_layer": per,
             "ops": [e.name for e in inside[0]]})
    assert len(per) == n_moe and 0 < max(per) <= 6, per


def _time(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _fused(monkeypatch, on: bool) -> None:
    """Send ``layers.moe_forward`` through the kernels (``on``) whatever
    its gate says, or restore the gate."""
    if on:
        monkeypatch.setattr(TL, "moe_takes_fused", lambda x, tp, cfg: True)
    else:
        monkeypatch.undo()


@pytest.mark.parametrize("name", [n for n in BF16 if not n.endswith("drops")])
def test_times_beside_the_bound(chip, name, monkeypatch):
    """The fused route (logits included), its plain version and the plain
    dispatch, timed with CUDA events at each case's shapes; the bound is
    the larger of the weights' bytes (each expert hit, and the shared
    expert) at 3.35 TB/s and the products' operations at 989 TFLOP/s.  The
    gate (``layers.moe_takes_fused``) picks a route at most a quarter
    slower than the other."""
    cfg, p, x = _world(name, chip)
    T, d = x.shape
    K, E = cfg.moe.experts_per_token, cfg.moe.num_experts
    C = TL.moe_capacity(cfg, T)
    kw = dict(top_k=K, capacity=C, aux_coef=cfg.moe.aux_loss_coef)
    gate = MK.fused_is_faster(T, K, E, C, d, p["w1"].shape[2])
    _fused(monkeypatch, True)
    with torch.no_grad():
        hit = int(torch.unique(TL.moe_route(p["router"], x, cfg)[2]).numel())
        fused = _time(lambda: TL.moe_forward(p, x[None], cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()     # the host's issue, the device behind
        for _ in range(10):
            TL.moe_forward(p, x[None], cfg)
        host_us = (time.perf_counter() - t0) / 10 * 1e6
        torch.cuda.synchronize()
        ref = _time(lambda: MK.moe_fused_ref(x, x.float() @ p["router"], p,
                                             **kw), n=3)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                TL.moe_forward(p, x[None], cfg)
            torch.cuda.synchronize()
    _fused(monkeypatch, False)
    kernels = {e.key[:60]: e.device_time_total / e.count / 1e3
               for e in prof.key_averages() if e.device_time_total > 0}
    with torch.enable_grad():
        plain = _time(lambda: TL.moe_forward(p, x[None], cfg), n=5)
    es = x.element_size()
    ff = p["w1"].shape[2]
    ffs = p["shared"]["w1"].shape[1] if "shared" in p else 0
    nbytes = (hit * 3 * d * ff + 3 * d * ffs) * es + d * E * 4
    ops = 2 * T * d * E + 6 * T * d * (K * ff + ffs)
    bound = max(nbytes / 3.35e12, ops / 989e12) * 1e3
    _record({"case": "times." + name, "fused_ms": fused, "plain_ms": ref,
             "host_issue_us": host_us,
             "plain_dispatch_ms": plain, "gate_fused": gate,
             "bound_ms": bound,
             "bound_by": "bytes" if nbytes / 3.35e12 >= ops / 989e12
             else "operations",
             "share_of_bound": bound / fused, "experts_hit": hit,
             "tile_rows": MK.tile_rows(T, K, E), "kernel_ms": kernels,
             "device": torch.cuda.get_device_name(0)})
    assert (fused if gate else plain) <= 1.25 * min(fused, plain)
    if name.endswith("decode"):
        assert gate


@pytest.mark.parametrize("config", ["granite", "jamba", "deepseek", "llama4"])
def test_gate_over_tokens_and_capacity(chip, config, monkeypatch):
    """The fused route and the plain dispatch (``layers.moe_forward``, the
    router's logits included) timed with CUDA events over T and the
    capacity factor (up to E/K, where nothing drops): the gate
    (``kernels.moe.fused_is_faster``) picks, at every point, a route at
    most a quarter slower than the other."""
    cfg0, p, x0 = _world(f"{config}.prefill", chip, tokens=2048)
    K, E = cfg0.moe.experts_per_token, cfg0.moe.num_experts
    points, worse = [], []
    for T in (128, 256, 512, 1024, 2048):
        x = x0[:T].contiguous()
        for cf in sorted({1.25, 2.0, 3.0, 4.0, E / K}):
            cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
                cfg0.moe, capacity_factor=cf))
            C = TL.moe_capacity(cfg, T)
            gate = MK.fused_is_faster(T, K, E, C, cfg.d_model,
                                      cfg.moe.d_ff_expert)
            _fused(monkeypatch, True)
            with torch.no_grad():
                fused = _time(lambda: TL.moe_forward(p, x[None], cfg))
            _fused(monkeypatch, False)
            with torch.enable_grad():
                plain = _time(lambda: TL.moe_forward(p, x[None], cfg), n=8)
            pt = {"T": T, "capacity_factor": cf, "rows_per_expert": T * K / E,
                  "pad": E * C / (T * K), "fused_ms": fused,
                  "plain_dispatch_ms": plain, "gate_fused": gate}
            points.append(pt)
            if (fused if gate else plain) > 1.25 * min(fused, plain):
                worse.append(pt)
    _record({"case": "gate." + config, "decode_rows": MK.DECODE_ROWS,
             "plain_pad": MK.PLAIN_PAD, "small_expert": MK.SMALL_EXPERT,
             "points": points,
             "device": torch.cuda.get_device_name(0)})
    assert not worse, worse


@pytest.mark.parametrize("config", ["granite", "jamba", "deepseek", "llama4"])
def test_tilings_over_tokens(chip, config, monkeypatch):
    """Both tilings of the grouped kernels (32 and 128 token rows a tile,
    forced through ``DECODE_ROWS``) timed with CUDA events over T, the
    router's logits given: the crossover that ``DECODE_ROWS`` stands for.
    Each tiling's output is held against the plain version first."""
    rows, decode_rows = {}, MK.DECODE_ROWS
    for T in (128, 256, 512, 1024, 2048):
        name = f"{config}.prefill"
        cfg, p, x = _world(name, chip, tokens=T)
        K, E = cfg.moe.experts_per_token, cfg.moe.num_experts
        logits = x.float() @ p["router"]
        kw = dict(top_k=K, capacity=TL.moe_capacity(cfg, T),
                  aux_coef=cfg.moe.aux_loss_coef)
        with torch.no_grad():
            ry, _ = MK.moe_fused_ref(x, logits, p, **kw)
            tol = 2 * 2 ** -7 * ry.float().abs().max().item()
            got = {}
            for bn, limit in ((32, 10 ** 9), (128, 0)):
                monkeypatch.setattr(MK, "DECODE_ROWS", limit)
                assert MK.tile_rows(T, K, E) == bn
                y, _ = MK.moe_fused_cuda(x, logits, p, **kw)
                err = (y.float() - ry.float()).abs().max().item()
                assert err <= tol, (T, bn, err, tol)
                got[bn] = _time(lambda: MK.moe_fused_cuda(x, logits, p, **kw))
        rows[T] = {"rows_per_expert": T * K / E, "ms_32": got[32],
                   "ms_128": got[128]}
        del p, x, ry
        torch.cuda.empty_cache()
    _record({"case": "tilings." + config, "decode_rows": decode_rows, "by_T": rows,
             "device": torch.cuda.get_device_name(0)})
