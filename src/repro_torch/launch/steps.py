"""Step functions (port of ``repro/launch/steps.py``): the adapter train
and eval steps, the prefill step, the single-adapter serve step, KV-cached greedy caption
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
family.  The production steps (train, prefill, serve) also take ``mesh``:
their batch is this rank's share of the reference's global batch, and
they compute the reference's step on it (``make_train_step``'s row
contract).

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
                  tp=None, remat: bool = False, mask_count=None):
    """(loss, metrics, grads) of ``T.loss_fn`` w.r.t. the adapter leaves
    only; the base weights take no gradient.  With ``tp`` the gradients
    are the whole model's, on every rank of the axis.  ``remat``: the
    blocks recompute their activations in the backward.  ``mask_count``:
    as in ``T.loss_fn``."""
    names = [(n, m) for n in sorted(lora) for m in ("A", "B")]
    leaves = {n: {m: lora[n][m].detach().requires_grad_(True)
                  for m in ("A", "B")} for n in lora}
    with torch.enable_grad():
        fwd = leaves if tp is None else tp.local_lora(leaves)
        loss, metrics = T.loss_fn(cfg, params, fwd, batch, lora_scale, tp=tp,
                                  remat=remat, mask_count=mask_count)
        flat = torch.autograd.grad(loss, [leaves[n][m] for n, m in names])
    grads = {n: {} for n in lora}
    for (n, m), g in zip(names, flat):
        grads[n][m] = g
    if tp is not None:
        tp.reduce_lora_grads(grads)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _batch_tp(cfg: ModelConfig, tp, mesh):
    """The step's plan when its batch is split over ``mesh``'s batch axes
    (``tp.batched``; where the caller gave none, a plan that splits no
    weight: the params are whole), or ``tp`` as it is without a mesh."""
    if mesh is None:
        return tp, None
    from repro_torch.sharding import batch_axes
    axes = batch_axes(mesh)
    if tp is None:
        from repro_torch.models.tensor_parallel import TensorParallel
        tp = TensorParallel(cfg, mesh, axis=None)
    return tp.batched(axes), axes


def _sum_over(mesh, axes, grads, metrics: dict, keys) -> None:
    """Sum the adapter gradients and the metrics ``keys`` over the
    batch-sharded ranks (``axes`` of ``mesh``), in place, in one
    all-reduce: each rank holds its share of the global batch's."""
    leaves = [grads[n][m] for n in sorted(grads) for m in ("A", "B")]
    flat = torch.cat([g.reshape(-1).float() for g in leaves]
                     + [metrics[k].reshape(-1).float() for k in keys])
    flat = mesh.all_reduce(flat, axes)
    at = 0
    for g in leaves:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    for k in keys:
        metrics[k] = flat[at:at + metrics[k].numel()].view_as(
            metrics[k]).to(metrics[k].dtype)
        at += metrics[k].numel()


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    lora_scale: float, num_microbatches: int = 1,
                    remat: bool = True, tp=None, mesh=None) -> Callable:
    """``(params, lora, opt_state, batch) -> (lora', opt_state',
    metrics)``: one optimizer step on the adapter, the base weights frozen;
    ``num_microbatches > 1`` accumulates the mean gradient over equal
    splits of the batch.  ``remat`` (the reference's default): each block
    recomputes its activations in the backward.

    ``tp``: the base params are a tensor-parallel rank's pieces (the
    adapter and its optimizer state stay whole).

    ``mesh``: the step computes the reference's step on the global batch,
    split over the mesh's batch axes (``repro_torch.sharding.batch_axes``,
    ``dp`` ranks).  The row contract: the rank at batch coordinate ``c``
    holds its share of each of the reference's microbatches — of global
    batch ``B`` and ``n`` microbatches, the global rows
    ``repro_torch.sharding.global_rows(B, n, dp, c)``, in that order — so
    that its local microbatch ``i`` is block ``c`` of the reference's
    microbatch ``i``.  Each microbatch's loss and accuracy are divided by
    the mask count of the whole reference microbatch, the MoE capacity,
    queue places, drops and aux loss are the global batch's
    (``tp.batched``), and the ranks' gradients, losses and accuracies are
    summed (not averaged) in one all-reduce before the update, so every
    rank takes the reference's step: over the batch axes, one all-reduce
    of each microbatch's mask count and one of the gradients, plus the
    MoE's."""
    _, update_fn = make_optimizer(opt_cfg)
    tp, axes = _batch_tp(cfg, tp, mesh)
    dp = mesh.shape[axes] if axes else 1

    @torch.no_grad()
    def train_step(params, lora, opt_state, batch):
        n = num_microbatches
        mbs = [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                for k, v in batch.items()} for i in range(n)]
        # running sums, so that every microbatch after the first holds the
        # same live state (the dry run traces two and scales to n)
        loss_sum, grads, msum = 0.0, None, None
        for mb in mbs:
            count = None
            if dp > 1:    # the reference microbatch's mask count
                count = mesh.all_reduce(mb["loss_mask"].float().sum(), axes)
            loss, m, g = loss_and_grad(cfg, params, lora, mb, lora_scale,
                                       tp=tp, remat=remat, mask_count=count)
            loss_sum = loss_sum + loss
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
            grads = g if grads is None else {
                k: {p: grads[k][p] + g[k][p] for p in g[k]} for k in g}
            del loss, m, g
        grads = {k: {p: v / n for p, v in e.items()}
                 for k, e in grads.items()}
        metrics = {k: v / n for k, v in msum.items()}
        metrics["total_loss"] = loss_sum / n
        if axes:
            # aux is the global batch's on every rank already
            _sum_over(mesh, axes, grads, metrics,
                      ("loss", "acc") if dp > 1 else ())
            if dp > 1:
                metrics["total_loss"] = metrics["loss"] + metrics["aux"]
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


def make_prefill_step(cfg: ModelConfig, *, lora_scale: float,
                      tp=None, mesh=None) -> Callable:
    """``(params, lora, batch) -> logits [B, V]`` (f32) of the last
    position of ``batch["tokens"]`` (with ``"image"`` / ``"audio"`` where
    the family takes them): the unembedding runs on that position only.
    With ``tp``, ``params`` are the rank's pieces, ``lora`` is whole and
    the logits are the rank's vocabulary columns.  ``mesh``: the batch is
    this rank's rows of the global batch (the MoE routes the global
    batch), as in :func:`make_train_step`."""
    tp, _ = _batch_tp(cfg, tp, mesh)

    @torch.no_grad()
    def prefill_step(params, lora, batch):
        lo = lora if tp is None else tp.local_lora(lora)
        logits, _ = T.forward(cfg, params, batch["tokens"], lora=lo,
                              lora_scale=lora_scale,
                              vision=batch.get("image"),
                              audio=batch.get("audio"), last_only=True,
                              tp=tp)
        return logits[:, 0].float()

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, lora_scale: float,
                    tp=None, mesh=None, cache_axis=None,
                    score_axis=None) -> Callable:
    """``(params, lora, cache, tokens, pos, embeds=None) -> (logits [B, V],
    cache)``: one-token decode, one adapter for the batch; ``embeds``
    [B, 1, d] replaces the token embedding (the vision prefix streams
    through it).  With ``tp``, ``lora`` is the rank's local adapter and
    the logits its vocabulary columns.  ``mesh``: the batch is this rank's
    rows of the global batch (the MoE routes the global batch);
    ``cache_axis``, ``score_axis``: as in
    ``repro_torch.models.transformer.decode_step``."""
    tp, _ = _batch_tp(cfg, tp, mesh)

    @torch.no_grad()
    def serve_step(params, lora, cache, tokens, pos, embeds=None):
        return T.decode_step(cfg, params, cache, tokens, pos, lora=lora,
                             lora_scale=lora_scale, embeds=embeds, tp=tp,
                             cache_axis=cache_axis, score_axis=score_axis)

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
            vp = params["vision_proj"] if tp is None else tp.full(
                "", "vision_proj", params["vision_proj"])
            pre = vision.to(xs.dtype) @ vp
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
           "make_prefill_step", "make_serve_step", "make_train_step"]
