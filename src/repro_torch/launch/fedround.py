"""The fused federated round and the two halves of the buffered-async
round (port of ``repro/launch/fedround.py``: ``_make_local_train``, the
cohort's self-pruning and editing, ``make_round_engine``,
``make_client_update_step`` and ``make_buffer_merge_step``).

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
tensors.  Meshes are refused by the trainer.

FLoRA (``aggregator="flora"``) takes a trailing ``reinit`` operand, the
round's fresh draws ``(client_lora0 [n_s, ...], global_new)`` from the
trainer's ``flora_reinit`` seam (the reference draws them from
``jax.random`` inside its program): each client restarts from its row
masked to its rank, editing is off, the registry's ``flora`` entry gives
the dense delta ``Σ_k p_k·scale·B_k A_k`` per spec (a plain einsum, as in
the reference), :func:`apply_weight_deltas` folds it into the base
weights IN PLACE, and ``global_new`` becomes the global adapter.

With ``faults=True`` each step takes a trailing ``fault`` operand built
from ``repro_torch.federated.faults.FaultSchedule.cohort``: four f32
vectors ``keep``, ``weight``, ``scale``, ``nan`` over the cohort, and
``kept``, the cohort rows whose clients were not dropped, as a long
tensor built on the host from ``keep``.  The reference drops a client's
scatter by sending it to an out-of-range index under ``mode="drop"``;
``index_copy_`` has no such mode, so the port scatters only the ``kept``
rows, and reading ``keep`` back from the device for that would cost a
host sync.

The buffered-async halves: ``make_client_update_step`` is the client half
of the fused round (redistribute, train, prune, edit, scatter back) and
returns the cohort's stacked update for the server to buffer;
``make_buffer_merge_step`` merges ``M`` buffered updates into the global
through the ``fedbuff`` registry entries.  The buffered ``update`` is a
tensor of its own, never a view of ``stacked_lora``: the trainer updates
``stacked_lora`` in place, and a client whose update waits in the buffer
can be sampled and trained again before the merge.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import aggregation as AG
from repro_torch.core.editing import EditConfig, edit_lora
from repro_torch.core.lora import mask_lora_params, truncate_redistribute
from repro_torch.core.tree import tree_leaves, tree_map
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


def _make_client_phases(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                        lora_scale: float, r_g: int, edit: EditConfig,
                        edit_active: bool, prune_active: bool,
                        hetlora_prune_gamma: float) -> Callable:
    """The per-client half shared by the fused round and the async client
    update: ``(base_params, global_lora, prev_global, ranks_s, batches,
    lora0=None) -> (lora1, ranks_s, metrics)``, redistribute → train →
    prune → edit over the cohort; ``lora1`` is a freshly stacked tree.
    With ``lora0`` (FLoRA's restart draws, stacked) client ``i`` starts
    from row ``i`` masked to its rank instead of the global adapter."""
    local_train = _make_local_train(cfg, opt_cfg, lora_scale=lora_scale,
                                    r_g=r_g)

    def client_phases(base_params, global_lora, prev_global, ranks_s,
                      batches, lora0=None):
        loras, losses = [], []
        for i in range(ranks_s.shape[0]):
            if lora0 is None:
                start = truncate_redistribute(global_lora, ranks_s[i], r_g)
            else:
                start = mask_lora_params(
                    {n: {m: e[m][i] for m in ("A", "B")}
                     for n, e in lora0.items()}, ranks_s[i], r_g)
            lo, ls = local_train(base_params, start, ranks_s[i],
                                 {k: v[i] for k, v in batches.items()})
            loras.append(lo)
            losses.append(ls)
        metrics = {"last_loss": torch.stack(losses)[:, -1]}
        if prune_active:
            loras, ranks_s = _cohort_self_prune(loras, ranks_s, r_g,
                                                hetlora_prune_gamma)
        if edit_active:
            loras, metrics["edited"] = _cohort_edit(loras, ranks_s,
                                                    prev_global, edit, r_g)
        return stack_trees(loras), ranks_s, metrics

    return client_phases


def _broadcast_rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-client vector [K] shaped to broadcast against a leaf [K, ...]."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def _wire(tree, fault):
    """The transmitted copy of the cohort's update, ``u·scale + nan``, on
    every row: clean rows too, as the reference does (``-0.0·1 + 0`` is
    ``+0.0``, so skipping them would change the aggregate's input bits)."""
    return tree_map(lambda x: x * _broadcast_rows(fault["scale"], x)
                    + _broadcast_rows(fault["nan"], x), tree)


def _rows_finite(tree) -> torch.Tensor:
    """bool [K]: the client's rows are finite in every leaf."""
    fin = None
    for x in tree_leaves(tree):
        f = torch.isfinite(x).flatten(1).all(dim=1)
        fin = f if fin is None else fin & f
    return fin


def _sanitize_rows(tree, finite: torch.Tensor):
    """Zero the rows of clients that carry a non-finite value, with a
    ``where`` (a zero weight alone would not do: ``0·NaN`` is NaN)."""
    return tree_map(lambda x: torch.where(
        finite.reshape((-1,) + (1,) * (x.dim() - 1)), x,
        torch.zeros((), dtype=x.dtype, device=x.device)), tree)


def _scatter(stacked_lora, ranks, idx, lora1, ranks_s, kept=None) -> None:
    """Write the cohort's rows back into the persistent stacked state in
    place; with ``kept``, only those cohort rows (dropped clients keep
    their pre-round state)."""
    if kept is not None:
        idx = idx[kept]
        ranks_s = ranks_s[kept]
    for name, entry in stacked_lora.items():
        for m in ("A", "B"):
            rows = lora1[name][m]
            entry[m].index_copy_(0, idx, rows if kept is None else rows[kept])
    ranks.index_copy_(0, idx, ranks_s.to(ranks.dtype))


def make_round_engine(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                      lora_scale: float, r_g: int,
                      edit: EditConfig | None = None,
                      aggregator: str = "fedilora",
                      hetlora_beta: float = 1.0,
                      hetlora_prune_gamma: float = 0.0,
                      clip: float | None = None,
                      trim: float = 0.0,
                      faults: bool = False) -> Callable:
    """Build the fused round over the trainer's persistent stacked state::

        round_step(base_params, stacked_lora[K,...], global_lora,
                   prev_global, ranks[K] int32, sizes[K] f32,
                   data {key: [K, N, ...]}, idx[n_s] long,
                   batch_idx[n_s, steps, B] long[, fault]) -> dict

    Output keys: ``stacked_lora`` and ``ranks`` (the inputs, updated in
    place), ``global_lora``, ``prev_global`` (the input global, for next
    round's editing) and ``metrics`` (``last_loss`` f32 [n_s], ``edited``
    int32 [n_s] when editing is on).

    ``faults=True`` adds the trailing ``fault`` operand (module docstring)
    and the round absorbs every fault on the device:

    * a dropped client (``keep == 0``) is neither aggregated nor scattered
      back: its stored row keeps its pre-round state;
    * a forfeited straggler (``weight == 0``, ``keep == 1``) is scattered
      back but carries no aggregation weight;
    * ``scale``/``nan`` corrupt the wire copy entering aggregation while
      the stored adapter stays clean;
    * a client with any non-finite wire value has its rows zeroed and its
      weight dropped, the surviving weights renormalise, a cohort with no
      survivor keeps the previous global (``fallback``);
    * ``out["health"]`` holds ``n_dropped``, ``n_forfeited``,
      ``n_nonfinite`` and ``clip_rate`` (f32 scalars on the device).

    With ``faults=False`` the signature and the work are the fault-free
    round's.  FLoRA adds the keyword operand ``reinit`` (module docstring)
    and the output key ``base_params`` (the input tree, updated in
    place)."""
    if aggregator not in AG.AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; have "
                         f"{sorted(AG.AGGREGATORS)}")
    edit = edit or EditConfig()
    flora = aggregator == "flora"
    client_phases = _make_client_phases(
        cfg, opt_cfg, lora_scale=lora_scale, r_g=r_g, edit=edit,
        edit_active=edit.enabled and not flora,
        prune_active=aggregator == "hetlora" and hetlora_prune_gamma > 0,
        hetlora_prune_gamma=hetlora_prune_gamma)

    @torch.no_grad()
    def round_step(base_params, stacked_lora, global_lora, prev_global,
                   ranks, sizes, data, idx, batch_idx, fault=None, *,
                   reinit=None):
        if flora and reinit is None:
            raise ValueError("FLoRA's round needs its reinit draws")
        ranks_s = ranks[idx]
        sizes_s = sizes[idx]
        # device-side batch gather: [n_s, steps, B, ...]
        batches = {k: v[idx[:, None, None], batch_idx]
                   for k, v in data.items()}
        lora1, ranks_s, metrics = client_phases(
            base_params, global_lora, prev_global, ranks_s, batches,
            lora0=reinit[0] if flora else None)

        agg_lora, kw, health, kept = lora1, {}, None, None
        if aggregator in ("fedilora_clip", "fedilora_clip_kernel"):
            kw["anchor"] = global_lora     # clipped-away mass stays here
        if faults:
            agg_lora = _wire(lora1, fault)
            finite = _rows_finite(agg_lora)
            agg_lora = _sanitize_rows(agg_lora, finite)
            fin = finite.to(sizes_s.dtype)
            sizes_s = sizes_s * fault["weight"] * fin
            kw["fallback"] = global_lora
            kept = fault["kept"]
            keep, weight = fault["keep"] > 0, fault["weight"] > 0
            alive = (keep & weight).float()
            if AG._clip_active(clip):
                norms = AG.client_update_norms(agg_lora)
                part = alive * fin
                clip_rate = ((part * (norms > clip).float()).sum()
                             / torch.clamp(part.sum(), min=1.0))
            else:
                clip_rate = torch.zeros((), device=alive.device)
            health = {"n_dropped": (~keep).float().sum(),
                      "n_forfeited": (keep & ~weight).float().sum(),
                      "n_nonfinite": (alive * (1.0 - fin)).sum(),
                      "clip_rate": clip_rate}
        p = sizes_s / torch.clamp(sizes_s.sum(), min=1e-12)
        global_new, base_delta = AG.aggregate(
            aggregator, agg_lora, ranks_s, p, hetlora_beta=hetlora_beta,
            lora_scale=lora_scale, clip=clip, trim=trim, **kw)

        _scatter(stacked_lora, ranks, idx, lora1, ranks_s, kept)
        out = {"stacked_lora": stacked_lora, "ranks": ranks,
               "prev_global": global_lora, "metrics": metrics}
        if base_delta is not None:                      # FLoRA
            out["base_params"] = apply_weight_deltas(base_params, base_delta)
            global_new = reinit[1]
        out["global_lora"] = global_new
        if health is not None:
            out["health"] = health
        return out

    return round_step


def make_client_update_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                            lora_scale: float, r_g: int,
                            edit: EditConfig | None = None,
                            aggregator: str = "fedbuff",
                            hetlora_prune_gamma: float = 0.0,
                            faults: bool = False) -> Callable:
    """Client half of the fused round for the buffered-async timeline::

        client_update_step(base_params, stacked_lora[K,...], global_lora,
                           prev_global, ranks[K], sizes[K],
                           data {key: [K, N, ...]}, idx[n_s],
                           batch_idx[n_s, steps, B][, fault]) -> dict

    Redistributes the (possibly stale) global, trains, prunes and edits the
    cohort and scatters it back in place, with no aggregation: the cohort's
    ``update`` (a freshly stacked tree), ``update_ranks`` and
    ``update_sizes`` go to the server's buffer.  With ``faults=True``
    dropped clients are not scattered back and the ``update`` rows carry
    the wire corruption (the merge guard catches the poison)."""
    if aggregator == "flora":
        raise ValueError("flora updates base weights; it has no "
                         "buffered-async client half")
    edit = edit or EditConfig()
    client_phases = _make_client_phases(
        cfg, opt_cfg, lora_scale=lora_scale, r_g=r_g, edit=edit,
        edit_active=edit.enabled,
        prune_active=aggregator == "hetlora" and hetlora_prune_gamma > 0,
        hetlora_prune_gamma=hetlora_prune_gamma)

    @torch.no_grad()
    def client_update_step(base_params, stacked_lora, global_lora,
                           prev_global, ranks, sizes, data, idx, batch_idx,
                           fault=None):
        ranks_s = ranks[idx]
        sizes_s = sizes[idx]
        batches = {k: v[idx[:, None, None], batch_idx]
                   for k, v in data.items()}
        lora1, ranks_s, metrics = client_phases(base_params, global_lora,
                                                prev_global, ranks_s, batches)
        update, kept = lora1, None
        if faults:
            update = _wire(lora1, fault)
            kept = fault["kept"]
        _scatter(stacked_lora, ranks, idx, lora1, ranks_s, kept)
        return {"stacked_lora": stacked_lora, "ranks": ranks,
                "update": update, "update_ranks": ranks_s,
                "update_sizes": sizes_s, "metrics": metrics}

    return client_update_step


def make_buffer_merge_step(*, aggregator: str = "fedbuff",
                           staleness_decay: float = 0.5,
                           hetlora_beta: float = 1.0,
                           lora_scale: float = 1.0,
                           guard: bool = False) -> Callable:
    """Server half of the buffered-async round::

        merge_step(buffer_lora[M,...], buf_ranks[M], buf_sizes[M],
                   buf_staleness[M] f32, global_lora) -> dict

    Merges ``M`` buffered client updates into the current global through
    the registry (``fedbuff`` / ``fedbuff_kernel`` discount each by its
    staleness and anchor the forfeited mass on the current global).  The
    input global comes back as ``prev_global``.  ``guard=True``
    (fault-injected trainers) zeroes the rows of updates with a non-finite
    value and their weight, keeps the previous global when nothing
    survives, and reports ``out["health"]["n_nonfinite"]``."""
    if aggregator == "flora":
        raise ValueError("flora has no buffered-async merge (dense base "
                         "deltas cannot be staleness-discounted in LoRA space)")

    @torch.no_grad()
    def merge_step(buffer_lora, buf_ranks, buf_sizes, buf_staleness,
                   global_lora):
        kw, health = {}, None
        if guard:
            finite = _rows_finite(buffer_lora)
            buffer_lora = _sanitize_rows(buffer_lora, finite)
            buf_sizes = buf_sizes * finite.to(buf_sizes.dtype)
            kw["fallback"] = global_lora
            health = {"n_nonfinite": (1.0 - finite.float()).sum()}
        p = buf_sizes / torch.clamp(buf_sizes.sum(), min=1e-12)
        global_new, _ = AG.aggregate(
            aggregator, buffer_lora, buf_ranks, p,
            hetlora_beta=hetlora_beta, lora_scale=lora_scale,
            staleness=buf_staleness, anchor=global_lora,
            staleness_decay=staleness_decay, **kw)
        out = {"global_lora": global_new, "prev_global": global_lora}
        if health is not None:
            out["health"] = health
        return out

    return merge_step


def apply_weight_deltas(params, deltas: dict):
    """Fold FLoRA's dense deltas ``{spec: [L, out, in]}`` into the base
    weights (``[L, in, out]``) IN PLACE; returns ``params``."""
    for name, delta in deltas.items():
        if name.startswith("enc."):
            node = params["encoder"]["blocks"]["s0"]
            path = name.split(".")[1:]
        else:
            sub, rest = name.split(".", 1)
            node = params["blocks"][sub]
            path = rest.split(".")
        for p in path[:-1]:
            node = node[p]
        w = node[path[-1]]
        w.add_(delta.transpose(-1, -2).to(w.dtype))
    return params


__all__ = ["apply_weight_deltas", "make_buffer_merge_step",
           "make_client_update_step", "make_round_engine", "stack_trees"]
