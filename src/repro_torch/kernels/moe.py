"""Fused mixture-of-experts feed-forward for bf16 inference on one card.

``moe_fused_cuda(xf, logits, params, top_k=, capacity=, aux_coef=)``
computes what ``models.layers.moe_forward`` computes without a mesh, from the
router's f32 logits ``[T, E]``: each token's top-K experts (stable: on
equal logits the lower expert first), the gates renormalised, the picks
past an expert's ``capacity`` dropped in token order, every expert's
SwiGLU over its kept rows only, the gated outputs summed in ascending
expert order, the shared expert added, and the Switch aux loss.  Returns
``(y [T, d] in x's type, aux)``; ``route=True`` adds ``{"ids", "pos",
"kept", "gates"}`` ([T, K] each, the integers equal to
``layers.moe_route``'s).

It launches the hand-written kernels of ``csrc/moe.cu`` (built by
``build.py`` at first use) on bf16 CUDA tensors: the route, the grouped
up-projection and the grouped down-projection, whose last block per column
tile does the combine; one ctypes call, three launches, no host
synchronisation; ``launches`` counts those calls.  ``moe_fused_ref`` is
the plain version on any device: the kernels' arithmetic in plain
PyTorch, the routed picks only, grouped by expert, sums in f32, the same
combine order.  ``models.layers.moe_forward`` takes the kernels for a bf16
CUDA input outside a mesh with gradients off, at the shapes where they
beat its plain dispatch (``fused_is_faster``), and counts every call that
keeps its plain dispatch in ``plain``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: fused calls since the last reset
launches = 0
#: calls of ``layers.moe_forward`` that took its plain dispatch
plain = 0
MAX_EXPERTS = 256
MAX_TOP_K = 16
#: d <= 64 x this (the down kernel's column tiles each keep a counter)
MAX_COLUMN_TILES = 1024
#: rows an expert gets (T·K/E) up to which the grouped kernels take their
#: decode tiling (32 token rows a tile, each weight slice streamed once for
#: all of them) and above which the 128-row one: the two cross between 16
#: and 32 rows an expert at the published widths of Granite 4.0-H, Jamba,
#: DeepSeek-V2 and Llama 4 Scout (PERF.md)
DECODE_ROWS = 24
#: above decode-sized batches, experts with at most this many elements in
#: a d x ff matrix take the kernels at any T: the plain dispatch's batched
#: products over such small matrices run far under the tensor cores' rate
#: and its ~93 launches set its pace (Granite 4.0-H 3.1 M, DeepSeek-V2
#: 7.9 M); wider experts (Llama 4 Scout 41.9 M, Jamba 58.7 M) keep the
#: plain dispatch, whose cuBLAS products outrun the kernels' mma.sync
#: tiles about threefold (PERF.md)
SMALL_EXPERT = 1 << 24
#: ... unless the plain dispatch's [E, C, d] buffers hold this many times
#: the routed rows or more (E·C rows for T·K picks)
PLAIN_PAD = 6.0
_FN = None
_LAYOUTS: dict = {}
_TICKETS: dict = {}


def reset_launches() -> None:
    global launches, plain
    launches = plain = 0


def _lib():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import build
        lib = build("moe")
        fn = lib.moe_fused_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.moe_fused_workspace
        ws.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
        ws.restype = ctypes.c_longlong
        _FN = fn, ws
    return _FN


def fused_is_faster(T: int, K: int, E: int, capacity: int, d: int,
                    ff: int) -> bool:
    """Whether the kernels beat the plain dispatch at these shapes (T
    tokens, top-K of E experts of d x ff, ``capacity`` rows an expert): a
    decode-sized batch (T·K <= ``DECODE_ROWS``·E), small experts (d·ff <=
    ``SMALL_EXPERT``), or a plain dispatch that would multiply
    ``PLAIN_PAD`` times the routed rows or more.  Measured over T and the
    capacity factor at four configurations' published widths."""
    return (T * K <= DECODE_ROWS * E or d * ff <= SMALL_EXPERT
            or E * capacity >= PLAIN_PAD * T * K)


def tile_rows(T: int, K: int, E: int) -> int:
    """The grouped kernels' token rows a tile: 32 at up to ``DECODE_ROWS``
    rows an expert (each weight slice streamed once for all of them), 128
    above."""
    return 32 if T * K <= DECODE_ROWS * E else 128


def _layout(key):
    out = _LAYOUTS.get(key)
    if out is None:
        offs = (ctypes.c_longlong * 4)()
        total = _lib()[1](*key, offs)
        out = _LAYOUTS[key] = (int(total), tuple(offs))
    return out


def _ticket(device: torch.device) -> torch.Tensor:
    """The kernels' counters on ``device``: the route's ticket and one per
    column tile of 64, each back at 0 when a call ends, so the calls on one
    device run one after another (one stream, as the serve path's)."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(1 + MAX_COLUMN_TILES,
                                           dtype=torch.int32, device=device)
    return t


def moe_fused_cuda(xf: torch.Tensor, logits: torch.Tensor, params: dict, *,
                   top_k: int, capacity: int, aux_coef: float,
                   route: bool = False):
    """Launch the kernels: xf [T, d] bf16, logits f32 [T, E],
    ``params`` the MoE's ``w1``/``w3`` [E, d, ff], ``w2`` [E, ff, d] and
    optionally ``shared`` {``w1``, ``w3`` [d, ffs], ``w2`` [ffs, d]}."""
    global launches
    T, d = xf.shape
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    E, ff = w1.shape[0], w1.shape[2]
    sh = params.get("shared")
    ffs = sh["w1"].shape[1] if sh is not None else 0
    K = top_k
    weights = [w1, w3, w2] + ([sh["w1"], sh["w3"], sh["w2"]] if sh else [])
    if any(t.dtype != torch.bfloat16 for t in [xf] + weights):
        raise TypeError("the fused MoE takes bf16 x and expert weights")
    if logits.dtype != torch.float32 or tuple(logits.shape) != (T, E):
        raise ValueError(f"logits {tuple(logits.shape)} {logits.dtype}: "
                         f"need f32 [{T}, {E}]")
    if (tuple(w3.shape) != (E, d, ff) or tuple(w1.shape) != (E, d, ff)
            or tuple(w2.shape) != (E, ff, d)
            or (sh and (tuple(sh["w1"].shape) != (d, ffs)
                        or tuple(sh["w3"].shape) != (d, ffs)
                        or tuple(sh["w2"].shape) != (ffs, d)))):
        raise ValueError("expert weight shapes do not agree with x "
                         f"[{T}, {d}]")
    if not (1 <= E <= MAX_EXPERTS and 1 <= K <= min(MAX_TOP_K, E)):
        raise ValueError(f"E {E}, top-k {K}: the kernels take E <= "
                         f"{MAX_EXPERTS} and K <= {MAX_TOP_K}")
    if d > 64 * MAX_COLUMN_TILES:
        raise ValueError(f"d {d} over {64 * MAX_COLUMN_TILES}")
    if d % 8 or ff % 8 or ffs % 8:
        raise ValueError(f"widths d {d}, ff {ff}, shared {ffs} must be "
                         "multiples of 8 elements")
    for t in [xf, logits] + weights:
        if not t.is_contiguous():
            raise ValueError("the fused MoE's operands must be contiguous")
        if t.device != xf.device or t.device.type != "cuda":
            raise ValueError(f"operand on {t.device}: the kernels need every "
                             "operand on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("the fused MoE's operands must be 16-byte "
                             "aligned")
    bn = tile_rows(T, K, E)
    key = (T, d, E, K, ff, ffs, bn)
    total, offs = _layout(key)
    fn = _lib()[0]
    ws = torch.empty(total, dtype=torch.uint8, device=xf.device)
    y = torch.empty((T, d), dtype=xf.dtype, device=xf.device)
    aux = torch.empty((), dtype=torch.float32, device=xf.device)
    err = fn(logits.data_ptr(), xf.data_ptr(), w1.data_ptr(), w3.data_ptr(),
             w2.data_ptr(),
             sh["w1"].data_ptr() if sh else None,
             sh["w3"].data_ptr() if sh else None,
             sh["w2"].data_ptr() if sh else None,
             y.data_ptr(), aux.data_ptr(), ws.data_ptr(),
             _ticket(xf.device).data_ptr(), T, d, E, K, ff, ffs,
             int(capacity), bn, float(aux_coef * E),
             torch.cuda.current_stream(xf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused MoE launch failed: cudaError {err}")
    launches += 1
    if not route:
        return y, aux
    TK = T * K
    picks = {"ids": ws[offs[0]:offs[0] + 4 * TK].view(torch.int32),
             "pos": ws[offs[1]:offs[1] + 4 * TK].view(torch.int32),
             "kept": ws[offs[2]:offs[2] + TK].view(torch.bool),
             "gates": ws[offs[3]:offs[3] + 4 * TK].view(torch.float32)}
    return y, aux, {k: v.reshape(T, K) for k, v in picks.items()}


def moe_fused_ref(xf: torch.Tensor, logits: torch.Tensor, params: dict, *,
                  top_k: int, capacity: int, aux_coef: float,
                  route: bool = False):
    """The plain version of the kernels, in plain PyTorch (any device).

    The same decisions: top-K by a stable descending sort of the logits
    (the probabilities' order; equal logits keep the lower expert first),
    gates from the softmax renormalised over the K picks with the clamp
    1e-9, ``pos`` a pick's place among its expert's picks in token order,
    kept below ``capacity``.  The same arithmetic: each expert's kept rows
    gathered in place order, ``h = silu(x·w1) · (x·w3)`` from f32 sums,
    stored in x's type, ``out = h·w2`` from f32 sums in x's type, the shared
    expert over every row the same way, and ``y`` summed in f32 over a
    token's kept picks in ascending expert order, plus the shared output,
    then cast."""
    T, d = xf.shape
    E, K = logits.shape[1], top_k
    dt = xf.dtype
    probs = torch.softmax(logits, dim=-1)
    ids = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :K]
    gates = probs.gather(1, ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = ids.reshape(-1)
    hot = F.one_hot(flat, E)                                       # [T*K, E]
    pos = (hot.cumsum(0) - hot).gather(1, flat[:, None]).reshape(T, K)
    kept = pos < capacity

    def swiglu(x, w1, w3, w2):
        h = F.silu(x.float() @ w1.float()) * (x.float() @ w3.float())
        return (h.to(dt).float() @ w2.float()).to(dt)

    out = torch.zeros((T, K, d), dtype=dt, device=xf.device)
    for e in range(E):
        t, k = torch.nonzero((ids == e) & kept, as_tuple=True)
        if t.numel():
            order = torch.argsort(pos[t, k])
            t, k = t[order], k[order]
            out[t, k] = swiglu(xf[t], params["w1"][e], params["w3"][e],
                               params["w2"][e])
    rank = ids.argsort(dim=-1)                       # ascending expert
    rows = torch.arange(T, device=xf.device)[:, None]
    g = (gates * kept)[rows, rank]
    o = out[rows, rank].float()
    y = torch.zeros((T, d), dtype=torch.float32, device=xf.device)
    for j in range(K):
        y = y + g[:, j, None] * o[:, j]
    sh = params.get("shared")
    if sh is not None:
        y = y + swiglu(xf, sh["w1"], sh["w3"], sh["w2"]).float()
    one_hot = F.one_hot(ids[:, 0], E).float()
    aux = aux_coef * E * (probs.mean(0) * one_hot.mean(0)).sum()
    if not route:
        return y.to(dt), aux
    return y.to(dt), aux, {"ids": ids, "pos": pos, "kept": kept,
                           "gates": gates}


__all__ = ["DECODE_ROWS", "MAX_EXPERTS", "MAX_TOP_K", "PLAIN_PAD",
           "SMALL_EXPERT", "fused_is_faster", "launches", "moe_fused_cuda", "moe_fused_ref",
           "plain", "reset_launches", "tile_rows"]
