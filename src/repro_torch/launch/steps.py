"""Step functions (port of ``repro/launch/steps.py``): the adapter train
and eval steps, the single-adapter serve step, KV-cached greedy caption
generation, the population evaluation over stacked client adapters, and
the serving engine's multi-adapter decode and chunked prefill.

The reference builds these as jit targets whose state and cache buffers
are donated.  Here they run eagerly and update decode caches and the
engine's slot state IN PLACE; each returns the objects it updated, so the
call sites read like the reference's.  Nothing here reads a value back to
the host.

On a mesh with a ``"model"`` axis the steps take ``tp``, a
``repro_torch.models.tensor_parallel.TensorParallel``: the base params are
this rank's pieces, the adapters whole (cut to what the rank reads by
``tp.local_lora``), and the loss, its gradients and the greedy tokens those
of the whole model (``tp.reduce_lora_grads``, ``tp.argmax``), for every
family.

The serving steps take the adapter bank scan-major, ``{spec: {"A": [L, G,
r, in], "B": [L, G, out, r]}}`` (``AdapterStore.scan_stack``), the layout
the decode loop indexes per layer.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, make_optimizer


def loss_and_grad(cfg: ModelConfig, params, lora, batch, lora_scale: float,
                  tp=None):
    """(loss, metrics, grads) of ``T.loss_fn`` w.r.t. the adapter leaves
    only; the base weights take no gradient.  With ``tp`` the gradients
    are the whole model's, on every rank of the axis."""
    names = [(n, m) for n in sorted(lora) for m in ("A", "B")]
    leaves = {n: {m: lora[n][m].detach().requires_grad_(True)
                  for m in ("A", "B")} for n in lora}
    with torch.enable_grad():
        fwd = leaves if tp is None else tp.local_lora(leaves)
        loss, metrics = T.loss_fn(cfg, params, fwd, batch, lora_scale, tp=tp)
        flat = torch.autograd.grad(loss, [leaves[n][m] for n, m in names])
    grads = {n: {} for n in lora}
    for (n, m), g in zip(names, flat):
        grads[n][m] = g
    if tp is not None:
        tp.reduce_lora_grads(grads)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    lora_scale: float, num_microbatches: int = 1) -> Callable:
    """``(params, lora, opt_state, batch) -> (lora', opt_state',
    metrics)``: one optimizer step on the adapter, the base weights frozen;
    ``num_microbatches > 1`` accumulates the mean gradient over equal
    splits of the batch."""
    _, update_fn = make_optimizer(opt_cfg)

    @torch.no_grad()
    def train_step(params, lora, opt_state, batch):
        n = num_microbatches
        mbs = [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                for k, v in batch.items()} for i in range(n)]
        loss_sum, grads, ms = 0.0, None, []
        for mb in mbs:
            loss, m, g = loss_and_grad(cfg, params, lora, mb, lora_scale)
            loss_sum = loss_sum + loss
            ms.append(m)
            grads = g if grads is None else {
                k: {p: grads[k][p] + g[k][p] for p in g[k]} for k in g}
        if n > 1:
            grads = {k: {p: v / n for p, v in e.items()}
                     for k, e in grads.items()}
        metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        metrics["total_loss"] = loss_sum / n
        lora_new, opt_new = update_fn(lora, grads, opt_state)
        return lora_new, opt_new, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, lora_scale: float,
                   tp=None) -> Callable:
    """``(params, lora, batch) -> metrics`` ({"loss", "aux", "acc"})."""

    @torch.no_grad()
    def eval_step(params, lora, batch):
        lo = lora if tp is None else tp.local_lora(lora)
        _, metrics = T.loss_fn(cfg, params, lo, batch, lora_scale, tp=tp)
        return metrics

    return eval_step


def make_serve_step(cfg: ModelConfig, *, lora_scale: float,
                    tp=None) -> Callable:
    """``(params, lora, cache, tokens, pos, embeds=None) -> (logits [B, V],
    cache)``: one-token decode, one adapter for the batch; ``embeds``
    [B, 1, d] replaces the token embedding (the vision prefix streams
    through it).  With ``tp``, ``lora`` is the rank's local adapter and
    the logits its vocabulary columns."""

    @torch.no_grad()
    def serve_step(params, lora, cache, tokens, pos, embeds=None):
        return T.decode_step(cfg, params, cache, tokens, pos, lora=lora,
                             lora_scale=lora_scale, embeds=embeds, tp=tp)

    return serve_step


def make_greedy_generate(cfg: ModelConfig, *, lora_scale: float,
                         cap_start: int, gen_len: int, tp=None) -> Callable:
    """KV-cached greedy caption generation: ``(params, lora, tokens[B, S],
    vision=None) -> gen int [B, gen_len]``.

    The prompt (a prefix VLM's vision prefix + text up to ``cap_start``)
    fills the cache in one chunk through the decode path (the reference
    streams it one position at a time through ``serve_step``: for
    attention and MLA the same products and the same cache), its last
    position gives the first token, then ``gen_len - 1`` cached one-token
    steps decode greedily.  A cross VLM adds no prefix: ``init_cache``
    builds its layers' static vision K/V, with the adapter.  A stack with a
    Mamba layer (a recurrent state) or an MoE layer (whose capacity depends
    on the tokens routed together) streams the prompt one position at a
    time, as the reference does.  ``tp``: the params are a rank's pieces
    and the cache holds its heads; every rank returns the same tokens."""
    serve_step = make_serve_step(cfg, lora_scale=lora_scale, tp=tp)
    argmax = (lambda lg: lg.argmax(-1)) if tp is None else tp.argmax
    stream = "mamba" in cfg.pattern or cfg.moe is not None
    prefix = cfg.family == "vlm" and cfg.vision_mode == "prefix"
    cross = cfg.family == "vlm" and cfg.vision_mode == "cross"

    @torch.no_grad()
    def generate(params, lora, tokens, vision=None):
        B = tokens.shape[0]
        if tp is None:
            xs = params["embed"][tokens[:, :cap_start + 1]]      # [B, P, d]
        else:
            lora = tp.local_lora(lora)
            xs = tp.embed(params["embed"], tokens[:, :cap_start + 1])
        n_prefix = 0
        if vision is not None and prefix:
            pre = vision.to(xs.dtype) @ params["vision_proj"]
            xs = torch.cat([pre, xs], dim=1)
            n_prefix = pre.shape[1]
        P = xs.shape[1]
        cache = T.init_cache(cfg, params, B, P + gen_len,
                             vision=vision if cross else None, lora=lora,
                             lora_scale=lora_scale, tp=tp)
        if stream:
            for t in range(P - 1):
                serve_step(params, lora, cache, None, t,
                           embeds=xs[:, t:t + 1])
        elif P > 1:
            T.decode_chunk(cfg, params, cache, xs[:, :P - 1],
                           torch.zeros(B, dtype=torch.long,
                                       device=xs.device),
                           adapters=lora, lora_scale=lora_scale,
                           logits=False, tp=tp)
        logits, cache = serve_step(params, lora, cache, None, P - 1,
                                   embeds=xs[:, P - 1:])
        toks = [argmax(logits)]
        for t in range(1, gen_len):
            logits, cache = serve_step(params, lora, cache, toks[-1],
                                       n_prefix + cap_start + t)
            toks.append(argmax(logits))
        return torch.stack(toks, dim=1)

    return generate


def _population_mesh_tools(cfg: ModelConfig, mesh, tp=None):
    """``(client_axis, tp)`` of a population sweep over ``mesh``: the
    client axis the sweep splits its clients over (``None`` without a
    mesh) and, on a 2-D ``(client, "model")`` mesh, the tensor-parallel
    split each client group runs (``tp``, when given, serves a sweep whose
    clients do not split).  A client's decode cache holds its rank's K/V
    heads: ``sharding.cache_spec`` would split its feature dimension over
    ``"model"``, which puts the attention's contraction on the mesh."""
    if mesh is None:
        return None, tp
    from repro_torch.models.tensor_parallel import TensorParallel
    from repro_torch.sharding import round_mesh_axes
    client_ax, model_ax = round_mesh_axes(mesh)
    return client_ax, (None if model_ax is None
                       else tp or TensorParallel(cfg, mesh))


def _client_rows(mesh, client_ax, K: int) -> range:
    """The clients of this rank's group: a contiguous block of K / n."""
    if client_ax is None:
        return range(K)
    n = mesh.shape[client_ax]
    if K % n:
        raise ValueError(f"{K} clients do not divide over the mesh's "
                         f"{client_ax!r} axis ({n})")
    c = mesh.coord(client_ax)
    return range(c * (K // n), (c + 1) * (K // n))


def make_population_generate(cfg: ModelConfig, *, lora_scale: float,
                             cap_start: int, gen_len: int,
                             mesh=None, tp=None) -> Callable:
    """Greedy decode for every client of a stacked population:
    ``(params, stacked_lora[K,...], tokens[K, B, S], vision[K, B, ...]?)
    -> gen [K, B, gen_len]`` (one client after another).  ``mesh``: a
    round mesh whose client axis splits the clients (each group decodes
    its block, and the blocks are gathered; on a 2-D mesh each group runs
    tensor-parallel); ``tp`` alone: every client here, tensor-parallel."""
    client_ax, tp = _population_mesh_tools(cfg, mesh, tp)
    gen = make_greedy_generate(cfg, lora_scale=lora_scale,
                               cap_start=cap_start, gen_len=gen_len, tp=tp)

    def population_generate(params, stacked_lora, tokens, vision=None):
        out = torch.stack([
            gen(params, _client(stacked_lora, k), tokens[k],
                None if vision is None else vision[k])
            for k in _client_rows(mesh, client_ax, tokens.shape[0])])
        return out if client_ax is None else mesh.all_gather(out, client_ax)

    return population_generate


def _client(stacked: dict, k: int) -> dict:
    return {n: {m: e[m][k] for m in ("A", "B")} for n, e in stacked.items()}


def make_population_eval(cfg: ModelConfig, *, lora_scale: float,
                         cap_start: int | None = None,
                         gen_len: int | None = None,
                         loss_rows: int | None = None,
                         gen_rows: int | None = None,
                         generate: bool = True, mesh=None,
                         tp=None) -> Callable:
    """The personalized evaluation sweep: ``(params, stacked_lora[K,...],
    batch {key: [K, rows, ...]}) -> {"loss" [K], "acc" [K], "gen" [K,
    gen_rows, gen_len]?}`` — eval loss over the first ``loss_rows`` rows
    and greedy decode of the first ``gen_rows``, client by client.
    ``mesh`` / ``tp``: as in :func:`make_population_generate`; every rank
    returns every client's results."""
    client_ax, tp = _population_mesh_tools(cfg, mesh, tp)
    gen_fn = None
    if generate:
        gen_fn = make_greedy_generate(cfg, lora_scale=lora_scale,
                                      cap_start=cap_start, gen_len=gen_len,
                                      tp=tp)

    @torch.no_grad()
    def population_eval(params, stacked_lora, batch):
        outs = []
        for k in _client_rows(mesh, client_ax, batch["tokens"].shape[0]):
            lora = _client(stacked_lora, k)
            lo = lora if tp is None else tp.local_lora(lora)
            b = {key: v[k] for key, v in batch.items()}
            lb = b if loss_rows is None else \
                {key: v[:loss_rows] for key, v in b.items()}
            _, m = T.loss_fn(cfg, params, lo, lb, lora_scale, tp=tp)
            out = {"loss": m["loss"], "acc": m["acc"]}
            if gen_fn is not None:
                rows = slice(None) if gen_rows is None else slice(0, gen_rows)
                vis = b.get("image")
                out["gen"] = gen_fn(params, lora, b["tokens"][rows],
                                    None if vis is None else vis[rows])
            outs.append(out)
        res = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
        if client_ax is not None:
            res = {key: mesh.all_gather(v, client_ax)
                   for key, v in res.items()}
        return res

    return population_eval

_BACKENDS = {"gather": False, "grouped": True}


def make_multi_adapter_serve_step(cfg: ModelConfig, *, lora_scale: float,
                                  lora_backend: str = "gather",
                                  tp=None) -> Callable:
    """One-token decode where every batch row uses its own adapter:

        ``(params, adapters, adapter_idx[B], cache, embeds[B, d],
           pos[B]) -> (logits [B, V], cache)``

    ``lora_backend``: ``"gather"`` gathers each row's (A, B) pair per LoRA
    site in plain PyTorch; ``"grouped"`` runs the BGMV kernel.  With
    ``tp`` the bank holds the rank's ``B`` rows (``tp.bank_b``) and, at
    a row-parallel site, its ``A`` columns (``tp.bank_a``), and the logits
    are its vocabulary columns."""
    kernel = _BACKENDS[lora_backend]

    def multi_serve_step(params, adapters, adapter_idx, cache, embeds, pos):
        return T.decode_chunk(cfg, params, cache, embeds[:, None, :], pos,
                              adapters=adapters, adapter_idx=adapter_idx,
                              lora_scale=lora_scale, lora_kernel=kernel,
                              tp=tp)

    return multi_serve_step


def make_chunked_prefill_step(cfg: ModelConfig, *, lora_scale: float,
                              chunk: int, n_prefix: int = 0,
                              lora_backend: str = "gather",
                              flash: bool | None = None,
                              tp=None) -> Callable:
    """Chunked multi-token prefill over a ServingEngine's slot state:

        ``(params, adapters, state, cache) -> (state, cache)``

    One call pushes up to ``chunk`` teacher-forced positions of every
    prefill-phase slot (``pos < plen - 1``) through the decode-cache write
    path; ragged tails are masked, no logits are computed, and slots past
    prefill (or free) advance by zero positions with their cache rows
    unchanged.  ``state["pos"]`` and the cache are updated in place."""
    kernel = _BACKENDS[lora_backend]

    def prefill_step(params, adapters, state, cache):
        pos, plen, tlen = state["pos"], state["plen"], state["tlen"]
        B = pos.shape[0]
        offs = pos[:, None] + torch.arange(chunk, device=pos.device)  # [B, C]
        valid = (offs < (plen - 1)[:, None]) & (tlen > 0)[:, None]
        Sp = state["ptoks"].shape[1]
        tok_pos = (offs - n_prefix).clamp(0, Sp - 1)
        toks = torch.gather(state["ptoks"], 1, tok_pos)
        embeds = (params["embed"][toks] if tp is None          # [B, C, d]
                  else tp.embed(params["embed"], toks))
        if n_prefix:
            rows = torch.arange(B, device=pos.device)[:, None]
            pre = state["vis"][rows, offs.clamp(0, n_prefix - 1)]
            embeds = torch.where((offs < n_prefix)[..., None],
                                 pre.to(embeds.dtype), embeds)
        T.decode_chunk(cfg, params, cache, embeds, pos, adapters=adapters,
                       adapter_idx=state["aidx"], lora_scale=lora_scale,
                       valid=valid, lora_kernel=kernel, logits=False,
                       chunked=flash, tp=tp)
        pos += valid.sum(1)
        return state, cache

    return prefill_step


__all__ = ["loss_and_grad", "make_chunked_prefill_step", "make_eval_step",
           "make_greedy_generate", "make_multi_adapter_serve_step",
           "make_population_eval", "make_population_generate",
           "make_serve_step", "make_train_step"]
