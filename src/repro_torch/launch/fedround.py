"""The fused federated round (port of ``repro/launch/fedround.py``:
``_make_local_train``, the cohort's self-pruning and editing, and
``make_round_engine``).

One call of the returned ``round_step`` is one communication round over
the trainer's persistent stacked client state, all on the device:

1. gather the sampled clients' minibatches from the device-resident
   corpus and redistribute the global adapter truncated to each client's
   rank;
2. train each client locally: AdamW on rank-masked gradients
   (``torch.autograd`` over the adapter leaves only; the base weights are
   frozen);
3. HetLoRA self-pruning (``hetlora`` with ``hetlora_prune_gamma > 0``) and
   layer-wise editing against the previous global (paper Eqs. 6-8);
4. aggregate through ``repro_torch.core.aggregation.AGGREGATORS`` —
   ``fedilora_kernel`` runs the ``dim_agg`` Hopper kernel, one launch over
   the whole stacked tree;
5. scatter the trained clients back into the stacked state.

Where the reference vmaps the cohort, the port loops over it in Python;
the cohort's losses, edited-module indices and ranks stay on the device,
so the round enqueues its work without waiting for the device.  The
stacked client adapters and ranks are updated IN PLACE (the reference
returns new buffers from donated ones); the returned dict names the same
tensors.  FLoRA's round is not ported (its per-round re-init draws from
``jax.random`` inside the program) and raises ``NotImplementedError``;
meshes and fault operands are refused by the trainer.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import aggregation as AG
from repro_torch.core.editing import EditConfig, edit_lora
from repro_torch.core.lora import mask_lora_params, truncate_redistribute
from repro_torch.launch.steps import loss_and_grad
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, make_optimizer


def _make_local_train(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                      lora_scale: float, r_g: int) -> Callable:
    """One client's local fine-tuning: ``(base_params, lora0, rank,
    batches {key: [steps, B, ...]}) -> (lora1, losses [steps])``, AdamW
    with gradients and iterates projected onto the client's rank
    subspace, so masked entries stay exactly zero."""
    opt_init, opt_update = make_optimizer(opt_cfg)

    def local_train(base_params, lora0, rank, batches):
        lo = lora0
        opt = opt_init(lo)
        losses = []
        for step in range(batches["tokens"].shape[0]):
            mb = {k: v[step] for k, v in batches.items()}
            loss, _, g = loss_and_grad(cfg, base_params, lo, mb, lora_scale)
            g = mask_lora_params(g, rank, r_g)
            lo, opt = opt_update(lo, g, opt)
            lo = mask_lora_params(lo, rank, r_g)
            losses.append(loss)
        return lo, torch.stack(losses)

    return local_train


def _cohort_self_prune(loras: list, ranks_s: torch.Tensor, r_g: int,
                       gamma: float):
    """HetLoRA rank self-pruning per client (the reference's
    ``_vmapped_self_prune``): a client's rank becomes the smallest pruned
    rank over its modules, at least 1, and its adapter is re-masked."""
    out, pruned = [], []
    for lo, rank in zip(loras, ranks_s):
        r = rank
        for entry in lo.values():
            r = torch.minimum(r, AG.hetlora_self_prune(entry, rank, r_g,
                                                       gamma))
        r = torch.clamp(r, min=1).to(ranks_s.dtype)
        out.append(mask_lora_params(lo, r, r_g))
        pruned.append(r)
    return out, torch.stack(pruned)


def _cohort_edit(loras: list, ranks_s: torch.Tensor, prev_global,
                 edit: EditConfig, r_g: int):
    """Layer-wise editing (paper Eqs. 6-8) per client against the previous
    global truncated to its rank (the reference's ``_vmapped_edit``);
    returns (edited adapters, edited-module index per client, int32)."""
    out, edited = [], []
    for lo, rank in zip(loras, ranks_s):
        glob_prev = truncate_redistribute(prev_global, rank, r_g)
        lo_e, diag = edit_lora(lo, glob_prev, edit)
        out.append(mask_lora_params(lo_e, rank, r_g))
        edited.append(torch.argmax(diag["selected"]).to(torch.int32))
    return out, torch.stack(edited)


def stack_trees(trees: list) -> dict:
    """Per-client adapter trees → one tree with a leading client axis."""
    return {name: {m: torch.stack([t[name][m] for t in trees])
                   for m in ("A", "B")} for name in trees[0]}


def make_round_engine(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                      lora_scale: float, r_g: int,
                      edit: EditConfig | None = None,
                      aggregator: str = "fedilora",
                      hetlora_beta: float = 1.0,
                      hetlora_prune_gamma: float = 0.0,
                      clip: float | None = None,
                      trim: float = 0.0) -> Callable:
    """Build the fused round over the trainer's persistent stacked state::

        round_step(base_params, stacked_lora[K,...], global_lora,
                   prev_global, ranks[K] int32, sizes[K] f32,
                   data {key: [K, N, ...]}, idx[n_s] long,
                   batch_idx[n_s, steps, B] long) -> dict

    Output keys: ``stacked_lora`` and ``ranks`` (the inputs, updated in
    place), ``global_lora``, ``prev_global`` (the input global, for next
    round's editing) and ``metrics`` (``last_loss`` f32 [n_s], ``edited``
    int32 [n_s] when editing is on)."""
    if aggregator == "flora":
        raise NotImplementedError(
            "FLoRA's round re-initialises adapters from jax.random inside "
            "the program; the port has no such round yet")
    if aggregator not in AG.AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; have "
                         f"{sorted(AG.AGGREGATORS)}")
    edit = edit or EditConfig()
    prune_active = aggregator == "hetlora" and hetlora_prune_gamma > 0
    local_train = _make_local_train(cfg, opt_cfg, lora_scale=lora_scale,
                                    r_g=r_g)

    @torch.no_grad()
    def round_step(base_params, stacked_lora, global_lora, prev_global,
                   ranks, sizes, data, idx, batch_idx):
        n_s = idx.shape[0]
        ranks_s = ranks[idx]
        sizes_s = sizes[idx]
        p = sizes_s / torch.clamp(sizes_s.sum(), min=1e-12)
        # device-side batch gather: [n_s, steps, B, ...]
        batches = {k: v[idx[:, None, None], batch_idx]
                   for k, v in data.items()}

        loras, losses = [], []
        for i in range(n_s):
            lora0 = truncate_redistribute(global_lora, ranks_s[i], r_g)
            lo, ls = local_train(base_params, lora0, ranks_s[i],
                                 {k: v[i] for k, v in batches.items()})
            loras.append(lo)
            losses.append(ls)
        metrics = {"last_loss": torch.stack(losses)[:, -1]}
        if prune_active:
            loras, ranks_s = _cohort_self_prune(loras, ranks_s, r_g,
                                                hetlora_prune_gamma)
        if edit.enabled:
            loras, metrics["edited"] = _cohort_edit(loras, ranks_s,
                                                    prev_global, edit, r_g)

        lora1 = stack_trees(loras)
        kw = {}
        if aggregator in ("fedilora_clip", "fedilora_clip_kernel"):
            kw["anchor"] = global_lora     # clipped-away mass stays here
        global_new, _ = AG.aggregate(
            aggregator, lora1, ranks_s, p, hetlora_beta=hetlora_beta,
            lora_scale=lora_scale, clip=clip, trim=trim, **kw)

        for name, entry in stacked_lora.items():
            for m in ("A", "B"):
                entry[m].index_copy_(0, idx, lora1[name][m])
        ranks.index_copy_(0, idx, ranks_s.to(ranks.dtype))
        return {"stacked_lora": stacked_lora, "ranks": ranks,
                "prev_global": global_lora, "global_lora": global_new,
                "metrics": metrics}

    return round_step


__all__ = ["make_round_engine", "stack_trees"]
