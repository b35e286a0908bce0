"""Step functions (port of ``repro/launch/steps.py``): the adapter train
and eval steps, the single-adapter serve step, KV-cached greedy caption
generation, the population evaluation over stacked client adapters, and
the serving engine's multi-adapter decode and chunked prefill.

The reference builds these as jit targets whose state and cache buffers
are donated.  Here they run eagerly and update decode caches and the
engine's slot state IN PLACE; each returns the objects it updated, so the
call sites read like the reference's.  Nothing here reads a value back to
the host.

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


def loss_and_grad(cfg: ModelConfig, params, lora, batch, lora_scale: float):
    """(loss, metrics, grads) of ``T.loss_fn`` w.r.t. the adapter leaves
    only; the base weights take no gradient."""
    names = [(n, m) for n in sorted(lora) for m in ("A", "B")]
    leaves = {n: {m: lora[n][m].detach().requires_grad_(True)
                  for m in ("A", "B")} for n in lora}
    with torch.enable_grad():
        loss, metrics = T.loss_fn(cfg, params, leaves, batch, lora_scale)
        flat = torch.autograd.grad(loss, [leaves[n][m] for n, m in names])
    grads = {n: {} for n in lora}
    for (n, m), g in zip(names, flat):
        grads[n][m] = g
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


def make_eval_step(cfg: ModelConfig, *, lora_scale: float) -> Callable:
    """``(params, lora, batch) -> metrics`` ({"loss", "aux", "acc"})."""

    @torch.no_grad()
    def eval_step(params, lora, batch):
        _, metrics = T.loss_fn(cfg, params, lora, batch, lora_scale)
        return metrics

    return eval_step


def make_serve_step(cfg: ModelConfig, *, lora_scale: float) -> Callable:
    """``(params, lora, cache, tokens, pos, embeds=None) -> (logits [B, V],
    cache)``: one-token decode, one adapter for the batch; ``embeds``
    [B, 1, d] replaces the token embedding (the vision prefix streams
    through it)."""

    @torch.no_grad()
    def serve_step(params, lora, cache, tokens, pos, embeds=None):
        return T.decode_step(cfg, params, cache, tokens, pos, lora=lora,
                             lora_scale=lora_scale, embeds=embeds)

    return serve_step


def make_greedy_generate(cfg: ModelConfig, *, lora_scale: float,
                         cap_start: int, gen_len: int) -> Callable:
    """KV-cached greedy caption generation: ``(params, lora, tokens[B, S],
    vision=None) -> gen int [B, gen_len]``.

    The prompt (vision prefix + text up to ``cap_start``) fills the cache
    in one chunk through the decode path (the reference streams it one
    position at a time through ``serve_step``: for attention and MLA the
    same products and the same cache), its last position gives the first
    token, then ``gen_len - 1`` cached one-token steps decode greedily.  A
    stack with a Mamba layer (a recurrent state) or an MoE layer (whose
    capacity depends on the tokens routed together) streams the prompt one
    position at a time, as the reference does."""
    serve_step = make_serve_step(cfg, lora_scale=lora_scale)
    stream = "mamba" in cfg.pattern or cfg.moe is not None

    @torch.no_grad()
    def generate(params, lora, tokens, vision=None):
        B = tokens.shape[0]
        xs = params["embed"][tokens[:, :cap_start + 1]]          # [B, P, d]
        n_prefix = 0
        if vision is not None and cfg.family == "vlm":
            pre = vision.to(xs.dtype) @ params["vision_proj"]
            xs = torch.cat([pre, xs], dim=1)
            n_prefix = pre.shape[1]
        P = xs.shape[1]
        cache = T.init_cache(cfg, params, B, P + gen_len)
        if stream:
            for t in range(P - 1):
                serve_step(params, lora, cache, None, t,
                           embeds=xs[:, t:t + 1])
        elif P > 1:
            T.decode_chunk(cfg, params, cache, xs[:, :P - 1],
                           torch.zeros(B, dtype=torch.long,
                                       device=xs.device),
                           adapters=lora, lora_scale=lora_scale,
                           logits=False)
        logits, cache = serve_step(params, lora, cache, None, P - 1,
                                   embeds=xs[:, P - 1:])
        toks = [logits.argmax(-1)]
        for t in range(1, gen_len):
            logits, cache = serve_step(params, lora, cache, toks[-1],
                                       n_prefix + cap_start + t)
            toks.append(logits.argmax(-1))
        return torch.stack(toks, dim=1)

    return generate


def make_population_generate(cfg: ModelConfig, *, lora_scale: float,
                             cap_start: int, gen_len: int) -> Callable:
    """Greedy decode for every client of a stacked population:
    ``(params, stacked_lora[K,...], tokens[K, B, S], vision[K, B, ...]?)
    -> gen [K, B, gen_len]`` (one client after another)."""
    gen = make_greedy_generate(cfg, lora_scale=lora_scale,
                               cap_start=cap_start, gen_len=gen_len)

    def population_generate(params, stacked_lora, tokens, vision=None):
        return torch.stack([
            gen(params, _client(stacked_lora, k), tokens[k],
                None if vision is None else vision[k])
            for k in range(tokens.shape[0])])

    return population_generate


def _client(stacked: dict, k: int) -> dict:
    return {n: {m: e[m][k] for m in ("A", "B")} for n, e in stacked.items()}


def make_population_eval(cfg: ModelConfig, *, lora_scale: float,
                         cap_start: int | None = None,
                         gen_len: int | None = None,
                         loss_rows: int | None = None,
                         gen_rows: int | None = None,
                         generate: bool = True) -> Callable:
    """The personalized evaluation sweep: ``(params, stacked_lora[K,...],
    batch {key: [K, rows, ...]}) -> {"loss" [K], "acc" [K], "gen" [K,
    gen_rows, gen_len]?}`` — eval loss over the first ``loss_rows`` rows
    and greedy decode of the first ``gen_rows``, client by client."""
    gen_fn = None
    if generate:
        gen_fn = make_greedy_generate(cfg, lora_scale=lora_scale,
                                      cap_start=cap_start, gen_len=gen_len)

    @torch.no_grad()
    def population_eval(params, stacked_lora, batch):
        outs = []
        for k in range(batch["tokens"].shape[0]):
            lora = _client(stacked_lora, k)
            b = {key: v[k] for key, v in batch.items()}
            lb = b if loss_rows is None else \
                {key: v[:loss_rows] for key, v in b.items()}
            _, m = T.loss_fn(cfg, params, lora, lb, lora_scale)
            out = {"loss": m["loss"], "acc": m["acc"]}
            if gen_fn is not None:
                rows = slice(None) if gen_rows is None else slice(0, gen_rows)
                vis = b.get("image")
                out["gen"] = gen_fn(params, lora, b["tokens"][rows],
                                    None if vis is None else vis[rows])
            outs.append(out)
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return population_eval

_BACKENDS = {"gather": False, "grouped": True}


def make_multi_adapter_serve_step(cfg: ModelConfig, *, lora_scale: float,
                                  lora_backend: str = "gather") -> Callable:
    """One-token decode where every batch row uses its own adapter:

        ``(params, adapters, adapter_idx[B], cache, embeds[B, d],
           pos[B]) -> (logits [B, V], cache)``

    ``lora_backend``: ``"gather"`` gathers each row's (A, B) pair per LoRA
    site in plain PyTorch; ``"grouped"`` runs the BGMV kernel."""
    kernel = _BACKENDS[lora_backend]

    def multi_serve_step(params, adapters, adapter_idx, cache, embeds, pos):
        return T.decode_chunk(cfg, params, cache, embeds[:, None, :], pos,
                              adapters=adapters, adapter_idx=adapter_idx,
                              lora_scale=lora_scale, lora_kernel=kernel)

    return multi_serve_step


def make_chunked_prefill_step(cfg: ModelConfig, *, lora_scale: float,
                              chunk: int, n_prefix: int = 0,
                              lora_backend: str = "gather",
                              flash: bool | None = None) -> Callable:
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
        embeds = params["embed"][toks]                            # [B, C, d]
        if n_prefix:
            rows = torch.arange(B, device=pos.device)[:, None]
            pre = state["vis"][rows, offs.clamp(0, n_prefix - 1)]
            embeds = torch.where((offs < n_prefix)[..., None],
                                 pre.to(embeds.dtype), embeds)
        T.decode_chunk(cfg, params, cache, embeds, pos, adapters=adapters,
                       adapter_idx=state["aidx"], lora_scale=lora_scale,
                       valid=valid, lora_kernel=kernel, logits=False,
                       chunked=flash)
        pos += valid.sum(1)
        return state, cache

    return prefill_step


__all__ = ["loss_and_grad", "make_chunked_prefill_step", "make_eval_step",
           "make_greedy_generate", "make_multi_adapter_serve_step",
           "make_population_eval", "make_population_generate",
           "make_serve_step", "make_train_step"]
