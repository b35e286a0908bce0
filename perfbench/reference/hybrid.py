"""Plain reference of the serving cells: a hybrid decoder of Mamba-2
layers (the SSD layer, arXiv:2405.21060), grouped-query attention layers
and mixture-of-experts feed-forwards (the layout of Granite 4.0-H and of
Jamba), with per-request LoRA adapters, run once over each whole
sequence.

Per sublayer ``s{i}`` of the configuration's pattern: a pre-norm mixer
(Mamba-2 or attention) and, where the stack has one, a pre-norm
feed-forward (routed experts on the configuration's MoE layers, a SwiGLU
elsewhere), both residual.  Mamba-2 here is its recurrence, step by step
in f32: ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t ⊗ B_t``, ``y_t = C_t·h_t +
D·x_t``, after a causal depthwise convolution and SiLU, with the SiLU
gate and an RMS norm before the output projection.  The router takes a
softmax over the experts in f32 and each token the top ``k`` (ties to the
lower expert), its gates renormalised to sum to one; every pick is
served (no capacity limit, as the published model routes); a shared
expert, where the configuration has one, is a SwiGLU over every token
added to the routed sum.  LoRA sits on
the Mamba input and output projections and on the attention query and
value, each row with its own adapter at its own rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import (Precision, causal_attention,
                                        rms_norm, rope, swiglu)


def _a_log(shape, g, device):
    n, H = shape
    return torch.log(torch.arange(1, H + 1, device=device,
                                  dtype=torch.float32)).expand(n, H).clone()


def _dt_bias(dt_min, dt_max):
    def init(shape, g, device):
        u = torch.rand(shape, generator=g, device=device)
        lo, hi = math.log(dt_min), math.log(dt_max)
        return torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
    return init


def param_specs(m: dict) -> dict:
    """The base weights, ``name -> (shape, init, f32)`` (the port's tree
    paths as names): normals at std ``fan_in^-1/2``, the embedding 0.02;
    Mamba's ``A_log = log(1..H)``, ``D = 1`` and ``dt_bias`` the inverse
    softplus of a log-uniform ``dt`` in [dt_min, dt_max], in f32, as is
    the router."""
    d, V = m["d_model"], m["vocab_size"]
    n = m["num_layers"] // len(m["pattern"])
    s, mo = m["ssm"], m["moe"]
    specs = {"embed": ((V, d), 0.02, False),
             "final_ln": ((d,), "ones", False)}
    for i, kind in enumerate(m["pattern"]):
        p = f"blocks.s{i}."
        specs[p + "ln1"] = ((n, d), "ones", False)
        if kind == "mamba":
            d_in = s["expand"] * d
            H = d_in // s["head_dim"]
            ch = d_in + 2 * s["state_dim"]
            q = p + "mamba."
            specs.update({
                q + "in_proj": ((n, d, 2 * d_in + 2 * s["state_dim"] + H),
                                d ** -0.5, False),
                q + "conv_w": ((n, s["conv_width"], ch),
                               s["conv_width"] ** -0.5, False),
                q + "conv_b": ((n, ch), "zeros", False),
                q + "A_log": ((n, H), _a_log, True),
                q + "D": ((n, H), "ones", True),
                q + "dt_bias": ((n, H), _dt_bias(s["dt_min"], s["dt_max"]),
                                True),
                q + "gate_norm": ((n, d_in), "ones", False),
                q + "out_proj": ((n, d_in, d), d_in ** -0.5, False)})
        else:
            H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
            q = p + "attn."
            specs.update({
                q + "wq": ((n, d, H * hd), d ** -0.5, False),
                q + "wk": ((n, d, KV * hd), d ** -0.5, False),
                q + "wv": ((n, d, KV * hd), d ** -0.5, False),
                q + "wo": ((n, H * hd, d), (H * hd) ** -0.5, False)})
        if i % mo["layer_period"] == mo["layer_offset"]:
            E, ff = mo["num_experts"], mo["d_ff_expert"]
            specs[p + "ln2"] = ((n, d), "ones", False)
            specs.update({
                p + "moe.router": ((n, d, E), d ** -0.5, True),
                p + "moe.w1": ((n, E, d, ff), d ** -0.5, False),
                p + "moe.w3": ((n, E, d, ff), d ** -0.5, False),
                p + "moe.w2": ((n, E, ff, d), ff ** -0.5, False)})
            if mo.get("num_shared_experts", 0):
                fs = (mo.get("d_ff_shared") or ff) * mo["num_shared_experts"]
                specs.update({
                    p + "moe.shared.w1": ((n, d, fs), d ** -0.5, False),
                    p + "moe.shared.w3": ((n, d, fs), d ** -0.5, False),
                    p + "moe.shared.w2": ((n, fs, d), fs ** -0.5, False)})
        elif m["d_ff"] > 0:
            ff = m["d_ff"]
            specs[p + "ln2"] = ((n, d), "ones", False)
            specs.update({p + "ffn.w1": ((n, d, ff), d ** -0.5, False),
                          p + "ffn.w3": ((n, d, ff), d ** -0.5, False),
                          p + "ffn.w2": ((n, ff, d), ff ** -0.5, False)})
    if not m.get("tie_embeddings", True):
        specs["unembed"] = ((d, V), d ** -0.5, False)
    return specs


def lora_sites(m: dict) -> dict:
    """``name -> (in, out, layers)``: Mamba's in / out projections and the
    attention query and value."""
    d = m["d_model"]
    n = m["num_layers"] // len(m["pattern"])
    out = {}
    for i, kind in enumerate(m["pattern"]):
        if kind == "mamba":
            s = m["ssm"]
            d_in = s["expand"] * d
            H = d_in // s["head_dim"]
            out[f"s{i}.mamba.in_proj"] = (d, 2 * d_in + 2 * s["state_dim"]
                                          + H, n)
            out[f"s{i}.mamba.out_proj"] = (d_in, d, n)
        else:
            hd = m["head_dim"]
            out[f"s{i}.attn.wq"] = (d, m["num_heads"] * hd, n)
            out[f"s{i}.attn.wv"] = (d, m["num_kv_heads"] * hd, n)
    return out


def _lora_rows(prec: Precision, x, w, a, b, scale):
    """``x @ w`` plus each row's own adapter: ``a`` [n, r, in], ``b``
    [n, out, r] (zero-padded to a common rank)."""
    y = prec.mm(x, w)
    xa = torch.einsum("bsi,bri->bsr", x.float(), a.float())
    return y + (scale * torch.einsum("bsr,bor->bso", xa,
                                     b.float())).to(y.dtype)


def _mamba(m, w, x, lo, scale, prec):
    s = m["ssm"]
    n, S, d = x.shape
    d_in = s["expand"] * d
    H, P, N, W = d_in // s["head_dim"], s["head_dim"], s["state_dim"], \
        s["conv_width"]
    proj = _lora_rows(prec, x, w["in_proj"], *lo["in_proj"], scale)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * N, H], -1)
    xp = F.pad(xbc.float(), (0, 0, W - 1, 0))
    conv = sum(xp[:, k:k + S] * w["conv_w"][k].float() for k in range(W))
    xbc = F.silu(conv + w["conv_b"].float()).to(x.dtype)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], -1)
    xh = xs.float().reshape(n, S, H, P)
    Bm, Cm = Bm.float(), Cm.float()
    dt = torch.logaddexp(dt.float() + w["dt_bias"], torch.zeros((), device=x.device))
    A = -torch.exp(w["A_log"])
    h = torch.zeros((n, H, P, N), device=x.device)
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t] * A)[:, :, None, None] * h
             + (dt[:, t, :, None] * xh[:, t])[..., None]
             * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t])
                  + w["D"][None, :, None] * xh[:, t])
    y = torch.stack(ys, 1).reshape(n, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), w["gate_norm"], m["norm_eps"])
    return _lora_rows(prec, y, w["out_proj"], *lo["out_proj"], scale)


def _attention(m, w, x, lo, scale, prec):
    n, S, _ = x.shape
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    pos = torch.arange(S, device=x.device)
    q = _lora_rows(prec, x, w["wq"], *lo["wq"], scale).reshape(n, S, H, hd)
    k = prec.mm(x, w["wk"]).reshape(n, S, KV, hd)
    v = _lora_rows(prec, x, w["wv"], *lo["wv"], scale).reshape(n, S, KV, hd)
    o = causal_attention(rope(q, pos, m["rope_theta"]),
                         rope(k, pos, m["rope_theta"]), v)
    return prec.mm(o.reshape(n, S, H * hd), w["wo"])


def _moe(m, w, x, prec):
    mo = m["moe"]
    n, S, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ w["router"].float(), -1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = mo["experts_per_token"]
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros(xf.shape, device=x.device, dtype=torch.float32)
    for e in range(mo["num_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel():
            out = swiglu(prec, xf[rows], w["w1"][e], w["w3"][e], w["w2"][e])
            y.index_add_(0, rows, gates[rows, slot, None] * out.float())
    y = y.to(x.dtype)
    if "shared.w1" in w:
        y = y + swiglu(prec, xf, w["shared.w1"], w["shared.w3"],
                       w["shared.w2"])
    return y.reshape(n, S, d)


def logits(m: dict, W: dict, tokens: torch.Tensor, adapters: list,
           scale: float, prec: Precision) -> torch.Tensor:
    """Logits (f32) ``[n, S, V]`` of ``tokens`` [n, S], row ``b`` through
    ``adapters[b]`` (``{site: {"A": [L, r, in], "B": [L, out, r]}}``)."""
    n, S = tokens.shape
    blocks = m["num_layers"] // len(m["pattern"])
    mo = m["moe"]
    r = max(a[next(iter(a))]["A"].shape[1] for a in adapters)
    dev = tokens.device

    def rows(site, part, l):
        out = []
        for a in adapters:
            t = a[site][part][l].to(dev)
            pad = r - t.shape[0 if part == "A" else 1]
            out.append(F.pad(t, (0, 0, 0, pad)) if part == "A"
                       else F.pad(t, (0, pad)))
        return torch.stack(out)

    x = W["embed"][tokens].to(prec.act)
    for l in range(blocks):
        for i, kind in enumerate(m["pattern"]):
            p = f"blocks.s{i}."
            w = {k[len(p):]: t[l] for k, t in W.items() if k.startswith(p)}
            h = rms_norm(x, w["ln1"], m["norm_eps"])
            if kind == "mamba":
                mw = {k[len("mamba."):]: t for k, t in w.items()
                      if k.startswith("mamba.")}
                lo = {s: (rows(f"s{i}.mamba.{s}", "A", l),
                          rows(f"s{i}.mamba.{s}", "B", l))
                      for s in ("in_proj", "out_proj")}
                x = x + _mamba(m, mw, h, lo, scale, prec)
            else:
                aw = {k[len("attn."):]: t for k, t in w.items()
                      if k.startswith("attn.")}
                lo = {s: (rows(f"s{i}.attn.{s}", "A", l),
                          rows(f"s{i}.attn.{s}", "B", l))
                      for s in ("wq", "wv")}
                x = x + _attention(m, aw, h, lo, scale, prec)
            if "ln2" not in w:
                continue
            h = rms_norm(x, w["ln2"], m["norm_eps"])
            if i % mo["layer_period"] == mo["layer_offset"]:
                x = x + _moe(m, {k[4:]: t for k, t in w.items()
                                 if k.startswith("moe.")}, h, prec)
            else:
                x = x + swiglu(prec, h, w["ffn.w1"], w["ffn.w3"],
                               w["ffn.w2"])
    x = rms_norm(x, W["final_ln"], m["norm_eps"])
    head = W["unembed"] if "unembed" in W else W["embed"].T
    return prec.mm(x, head).float()
