"""Plain reference of the training cells: a prefix vision-language decoder
(projected vision tokens ahead of the text, as LLaVA and MiniCPM-V feed
their language model) fine-tuned with FediLoRA for one federated round.

Model: pre-norm decoder layers of RMS norm, grouped-query causal attention
with rotary embeddings and LoRA on the query and value projections, and
SwiGLU; tied or separate output head; masked next-token cross-entropy
over the caption.  Round (FediLoRA, arXiv:2509.06984): each sampled
client starts from the global adapter truncated to its rank, takes
``local_steps`` AdamW steps on rank-masked gradients (global-norm clipping
first), edits its least similar module of A toward the previous global
(cosine similarity as the blend weight, Eqs. 6-8), and the server
averages each rank dimension over the clients that hold it, weighted by
data size (Eqs. 3-5).

Plain PyTorch: no kernel, cache or fused step of the program.  Each
client's batch runs in micro-batches whose summed losses give the whole
batch's mean, so the reference fits beside its own activations.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.common import (Precision, causal_attention,
                                        rms_norm, rope, swiglu)


def param_specs(m: dict) -> dict:
    """The base weights: ``name -> (shape, init, f32)``, the port's tree
    paths as names; normals at std ``fan_in^-1/2`` (the embedding 0.02)."""
    d, H, KV = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd, f, V, L = m["head_dim"], m["d_ff"], m["vocab_size"], m["num_layers"]
    Dv = m["vision_dim"]
    p = "blocks.s0."
    specs = {
        "embed": ((V, d), 0.02, False),
        "final_ln": ((d,), "ones", False),
        p + "ln1": ((L, d), "ones", False),
        p + "attn.wq": ((L, d, H * hd), d ** -0.5, False),
        p + "attn.wk": ((L, d, KV * hd), d ** -0.5, False),
        p + "attn.wv": ((L, d, KV * hd), d ** -0.5, False),
        p + "attn.wo": ((L, H * hd, d), (H * hd) ** -0.5, False),
        p + "ln2": ((L, d), "ones", False),
        p + "ffn.w1": ((L, d, f), d ** -0.5, False),
        p + "ffn.w3": ((L, d, f), d ** -0.5, False),
        p + "ffn.w2": ((L, f, d), f ** -0.5, False),
        "vision_proj": ((Dv, d), Dv ** -0.5, False),
    }
    if not m.get("tie_embeddings", True):
        specs["unembed"] = ((d, V), d ** -0.5, False)
    return specs


def lora_sites(m: dict) -> dict:
    """The adapted weights (the paper: query and value), ``name -> (in,
    out, layers)``."""
    d, hd, L = m["d_model"], m["head_dim"], m["num_layers"]
    return {"s0.attn.wq": (d, m["num_heads"] * hd, L),
            "s0.attn.wv": (d, m["num_kv_heads"] * hd, L)}


def loss_sum(m: dict, W: dict, lora: dict, batch: dict, scale: float,
             prec: Precision):
    """(sum of the caption tokens' negative log-likelihood, their count)
    of one batch."""
    L, H, hd = m["num_layers"], m["num_heads"], m["head_dim"]
    KV, eps = m["num_kv_heads"], m["norm_eps"]
    act = prec.act
    tokens = batch["tokens"]
    B, S = tokens.shape
    image = batch["image"] * batch["image_mask"][:, None, None]
    pre = prec.mm(image.to(act), W["vision_proj"])
    x = torch.cat([pre, W["embed"][tokens].to(act)], 1)
    P = pre.shape[1]
    T = P + S
    pos = torch.arange(T, device=tokens.device)
    q_l, v_l = lora["s0.attn.wq"], lora["s0.attn.wv"]
    for l in range(L):
        w = {k[len("blocks.s0."):]: t[l] for k, t in W.items()
             if k.startswith("blocks.s0.")}
        h = rms_norm(x, w["ln1"], eps)
        q = prec.lora(h, w["attn.wq"], q_l["A"][l], q_l["B"][l], scale)
        k = prec.mm(h, w["attn.wk"])
        v = prec.lora(h, w["attn.wv"], v_l["A"][l], v_l["B"][l], scale)
        q = rope(q.reshape(B, T, H, hd), pos, m["rope_theta"])
        k = rope(k.reshape(B, T, KV, hd), pos, m["rope_theta"])
        o = causal_attention(q, k, v.reshape(B, T, KV, hd))
        x = x + prec.mm(o.reshape(B, T, H * hd), w["attn.wo"])
        h = rms_norm(x, w["ln2"], eps)
        x = x + swiglu(prec, h, w["ffn.w1"], w["ffn.w3"], w["ffn.w2"])
    x = rms_norm(x, W["final_ln"], eps)[:, P:]
    head = W["unembed"] if "unembed" in W else W["embed"].T
    logp = torch.log_softmax(prec.mm(x, head).float(), -1)
    ll = torch.gather(logp, -1, batch["labels"][..., None])[..., 0]
    mask = batch["loss_mask"].float()
    return -(ll * mask).sum(), mask.sum()


def _mask(lora: dict, r: int) -> dict:
    out = {}
    for n, e in lora.items():
        a, b = e["A"].clone(), e["B"].clone()
        a[:, r:] = 0
        b[:, :, r:] = 0
        out[n] = {"A": a, "B": b}
    return out


def local_train(m, W, start, rank, batches, fed, opt, prec, micro):
    """One client's local AdamW steps.  Returns (adapter, losses per step,
    per leaf the largest gradient norm it took, before clipping)."""
    lo = _mask(start, rank)
    mu = {n: {k: torch.zeros_like(t) for k, t in e.items()}
          for n, e in lo.items()}
    nu = {n: {k: torch.zeros_like(t) for k, t in e.items()}
          for n, e in lo.items()}
    b1, b2, lr, eps = opt["b1"], opt["b2"], opt["lr"], opt["eps"]
    losses, gmax = [], {}
    for step, batch in enumerate(batches, start=1):
        leaves = {n: {k: t.detach().requires_grad_(True)
                      for k, t in e.items()} for n, e in lo.items()}
        count = batch["loss_mask"].sum()
        total = 0.0
        n = batch["tokens"].shape[0]
        for i in range(0, n, micro):
            mb = {k: v[i:i + micro] for k, v in batch.items()}
            s, _ = loss_sum(m, W, leaves, mb, fed["lora_scale"], prec)
            (s / count).backward()
            total += float(s.detach())
        losses.append(total / float(count))
        g = _mask({n: {k: t.grad for k, t in e.items()}
                   for n, e in leaves.items()}, rank)
        for n, e in g.items():
            for k, t in e.items():
                gmax[(n, k)] = max(gmax.get((n, k), 0.0),
                                   float(t.float().norm()))
        gnorm = torch.sqrt(sum(t.float().square().sum()
                               for e in g.values() for t in e.values()))
        clip = torch.where(gnorm > opt["grad_clip"],
                           opt["grad_clip"] / gnorm.clamp_min(1e-12),
                           torch.ones_like(gnorm))
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        new = {}
        for n, e in lo.items():
            new[n] = {}
            for k, p in e.items():
                gk = g[n][k] * clip
                mu[n][k] = b1 * mu[n][k] + (1 - b1) * gk
                nu[n][k] = b2 * nu[n][k] + (1 - b2) * gk.square()
                u = (mu[n][k] / c1) / (torch.sqrt(nu[n][k] / c2) + eps) \
                    + opt["weight_decay"] * p
                new[n][k] = p - lr * u
        lo = _mask(new, rank)
    return lo, losses, gmax


def edit(lo: dict, prev: dict, rank: int):
    """Layer-wise editing: the module (site × layer, sites in name order)
    whose A is least similar to the previous global's (truncated to the
    client's rank) is blended toward it with its similarity as weight.
    Returns (adapter, the edited module's index)."""
    g = _mask(prev, rank)
    sims = []
    for n in sorted(lo):
        a, ag = lo[n]["A"].float(), g[n]["A"].float()
        dot = (a * ag).sum((1, 2))
        den = (a.square().sum((1, 2)).sqrt()
               * ag.square().sum((1, 2)).sqrt()).clamp_min(1e-12)
        sims.append(dot / den)
    sims = torch.cat(sims)
    idx = int(torch.sort(sims, stable=True).indices[0])
    out = {n: {k: t.clone() for k, t in e.items()} for n, e in lo.items()}
    at = 0
    for n in sorted(lo):
        L = lo[n]["A"].shape[0]
        if at <= idx < at + L:
            s = sims[idx]
            l = idx - at
            out[n]["A"][l] = s * lo[n]["A"][l] + (1 - s) * g[n]["A"][l]
        at += L
    return _mask(out, rank), idx


def aggregate(clients: list, ranks, sizes) -> dict:
    """Dimension-wise weighted mean: rank dimension ``d`` of the global
    averages the clients with rank > d, weights ∝ data size."""
    r_g = next(iter(clients[0].values()))["A"].shape[1]
    p = torch.tensor(np.asarray(sizes, np.float64) / np.sum(sizes),
                     dtype=torch.float32)
    cover = (torch.arange(r_g)[None, :] < torch.tensor(ranks)[:, None])
    w = cover.float() * p[:, None]
    w = w / w.sum(0, keepdim=True).clamp_min(1e-12)               # [K, r]
    out = {}
    for n in clients[0]:
        wd = w.to(clients[0][n]["A"].device)
        out[n] = {"A": torch.einsum("kd,kldn->ldn", wd, torch.stack(
                      [c[n]["A"] for c in clients])),
                  "B": torch.einsum("kd,klmd->lmd", wd, torch.stack(
                      [c[n]["B"] for c in clients]))}
    return out


def cohort_and_batches(seed: int, fed: dict, sizes) -> tuple:
    """The first round's cohort and each member's minibatches, by the
    protocol's host draws: the cohort uniformly without replacement from
    ``numpy.random.default_rng(seed)``; client k's minibatches from epochs
    shuffled by ``default_rng(seed + 7k + 1)``."""
    K = fed["num_clients"]
    n_s = max(int(round(fed["sample_rate"] * K)), 1)
    rng = np.random.default_rng(seed)
    cohort = sorted(int(k) for k in rng.choice(K, n_s, replace=False))
    B, steps = fed["batch_size"], fed["local_steps"]
    batches = []
    for k in cohort:
        crng = np.random.default_rng(seed + 7 * k + 1)
        out = []
        while len(out) < steps:
            perm = crng.permutation(sizes[k])
            for i in range(0, sizes[k] - B + 1, B):
                out.append(perm[i:i + B])
                if len(out) == steps:
                    break
        batches.append(np.stack(out))
    return cohort, batches


def federated_round(m, W, global0, shards, seed, fed, opt, prec,
                    micro: int, device) -> dict:
    """The first round from ``global0`` (also the previous global that
    editing compares with).  Returns the cohort, each member's adapter
    after editing, last loss, edited module and gradient norms, and the
    new global."""
    sizes = [s["tokens"].shape[0] for s in shards]
    cohort, batches = cohort_and_batches(seed, fed, sizes)
    out = {"cohort": cohort, "clients": [], "losses": [], "edited": [],
           "gmax": []}
    for k, bidx in zip(cohort, batches):
        steps = [{key: torch.from_numpy(np.asarray(v)[ix]).to(device)
                  for key, v in shards[k].items()} for ix in bidx]
        r = fed["ranks"][k]
        lo, losses, gmax = local_train(m, W, global0, r, steps, fed, opt,
                                       prec, micro)
        lo, idx = edit(lo, global0, r)
        out["clients"].append(lo)
        out["losses"].append(losses)
        out["edited"].append(idx)
        out["gmax"].append(gmax)
    out["global"] = aggregate(out["clients"],
                              [fed["ranks"][k] for k in cohort],
                              [sizes[k] for k in cohort])
    return out
