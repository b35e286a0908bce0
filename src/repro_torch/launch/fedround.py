"""The fused federated round and the two halves of the buffered-async
round (port of ``repro/launch/fedround.py``: ``_make_local_train``, the
cohort's self-pruning and editing, ``make_fed_round_step`` (the dry run's
round over already gathered inputs), ``make_round_engine``,
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

Under a runtime's current telemetry (``repro_torch.telemetry.span``) the
phases run in spans: ``batch_gather``; per local step ``fwd_bwd`` (the
backward's kernels launch from autograd's thread while it is open) and
``optimizer`` (gradient mask, AdamW, re-mask); ``edit``; ``aggregate``
(with ``dim_agg`` around the kernel's tree launch); ``scatter``.

Where the reference vmaps the cohort, the port loops over it in Python;
the cohort's losses, edited-module indices and ranks stay on the device,
so the round enqueues its work without waiting for the device.  The
stacked client adapters and ranks are updated IN PLACE (the reference
returns new buffers from donated ones); the returned dict names the same
tensors.

On a round mesh (``mesh=``, with the static cohort size ``n_sample``; see
``repro_torch.sharding.round_mesh_axes``) every rank runs the step: the
cohort is padded to a multiple of the client axis with dummy clients
(:func:`cohort_pad`: ``p = 0``, metrics sliced off, scatters dropped), each
client group trains its contiguous block of rows — tensor-parallel over
``"model"`` on a 2-D mesh (``repro_torch.models.tensor_parallel``) — and the
trained rows, ranks and metrics are all-gathered over the client axis.
Every rank then aggregates the whole padded cohort (one ``dim_agg`` or
``dim_agg_trimmed`` launch for the kernel entries) and scatters it into
its copy of the stacked state, so every rank holds the same global and the
same ``[K, ...]`` state bit for bit.  (The reference lays the ``[K, ...]``
rows out over the client axis; with one process per device that would
need the cohort's rows fetched from their owners before training, so the
port keeps the state whole on every rank.)

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

from typing import Callable, NamedTuple

import torch

from repro_torch.core import aggregation as AG
from repro_torch.core.editing import EditConfig, edit_lora
from repro_torch.core.lora import mask_lora_params, truncate_redistribute
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.steps import loss_and_grad
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.sharding import round_mesh_axes
from repro_torch.telemetry import span


def _make_local_train(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                      lora_scale: float, r_g: int, tp=None) -> Callable:
    """One client's local fine-tuning: ``(base_params, lora0, rank,
    batches {key: [steps, B, ...]}) -> (lora1, losses [steps])``, AdamW
    with gradients and iterates projected onto the client's rank
    subspace, so masked entries stay exactly zero.  ``tp``: the base
    params are a tensor-parallel rank's pieces; the adapter, its
    gradients and the optimizer state stay whole and equal on every rank
    of the axis."""
    opt_init, opt_update = make_optimizer(opt_cfg)

    def local_train(base_params, lora0, rank, batches):
        lo = lora0
        opt = opt_init(lo)
        losses = []
        for step in range(batches["tokens"].shape[0]):
            mb = {k: v[step] for k, v in batches.items()}
            with span("fwd_bwd"):
                loss, _, g = loss_and_grad(cfg, base_params, lo, mb,
                                           lora_scale, tp=tp)
            with span("optimizer"):
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
    with span("edit"):
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


def cohort_pad(n_sample: int, mesh) -> int:
    """The padded cohort size: the next multiple of the mesh's client-axis
    size (``n_sample`` without a mesh)."""
    if mesh is None:
        return n_sample
    client_ax, _ = round_mesh_axes(mesh)
    n_client = mesh.shape[client_ax]
    return -(-n_sample // n_client) * n_client


def _pad_cohort(idx, batch_idx, n_pad: int, n_total: int):
    """Pad ``(idx [n_s], batch_idx [n_s, ...])`` to ``n_pad`` rows of dummy
    clients, which carry the out-of-range index ``n_total``: gathers read
    through the clipped copy (the last real client's data: wasted, harmless
    work) and scatters skip them.  Returns ``(idx, clipped_idx, batch_idx,
    valid [n_pad])``."""
    n_s = idx.shape[0]
    if n_pad > n_s:
        idx = torch.cat([idx, idx.new_full((n_pad - n_s,), n_total)])
        batch_idx = torch.cat([batch_idx, batch_idx.new_zeros(
            (n_pad - n_s,) + tuple(batch_idx.shape[1:]))])
    valid = torch.arange(n_pad, device=idx.device) < n_s
    return idx, idx.clamp(0, n_total - 1), batch_idx, valid


def _pad_fault(fault, n_pad: int):
    """The fault operand's vectors padded with neutral entries, so dummy
    rows read as healthy non-participants (``kept`` indexes real rows and
    stays as it is)."""
    n = fault["keep"].shape[0]
    if n >= n_pad:
        return fault
    ext = lambda v, fill: torch.cat([v, v.new_full((n_pad - n,), fill)])
    return dict(fault, keep=ext(fault["keep"], 1.0),
                weight=ext(fault["weight"], 1.0),
                scale=ext(fault["scale"], 1.0), nan=ext(fault["nan"], 0.0))


class _RoundMesh(NamedTuple):
    mesh: object
    client_axis: str
    tp: object                      # TensorParallel on a 2-D mesh, or None
    n_pad: int                      # the padded cohort


def _round_mesh(cfg: ModelConfig, mesh, n_sample):
    """The round's plan on ``mesh`` (``None`` without one).  Raises on a
    mesh without ``n_sample`` and on a malformed mesh."""
    if mesh is None:
        return None
    n_pad = cohort_pad(n_sample, mesh) if n_sample is not None else None
    if n_pad is None:
        raise ValueError(
            "a round mesh needs n_sample (the static sampled-cohort size) "
            "to split the client axis — pass n_sample=... or drop mesh=")
    client_ax, model_ax = round_mesh_axes(mesh)
    tp = None
    if model_ax is not None:
        from repro_torch.models.tensor_parallel import TensorParallel
        tp = TensorParallel(cfg, mesh)
    return _RoundMesh(mesh, client_ax, tp, n_pad)


def _gather_rows(mesh, axis: str, tensors: list) -> list:
    """All-gather each tensor's leading (row) axis over ``axis``, one
    all-gather per dtype: the rows are packed side by side, gathered and
    unpacked in coordinate order."""
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for ids in by_dtype.values():
        m = tensors[ids[0]].shape[0]
        flat = torch.cat([tensors[i].reshape(m, -1) for i in ids], dim=1)
        got = mesh.all_gather(flat, axis)
        at = 0
        for i in ids:
            t = tensors[i]
            w = t[0].numel()
            out[i] = got[:, at:at + w].reshape(
                (got.shape[0],) + tuple(t.shape[1:])).contiguous()
            at += w
    return out


def _meshed_phases(client_phases, plan: _RoundMesh):
    """Run ``client_phases`` on this rank's client group's block of the
    padded cohort and gather every group's rows: ``(base_params,
    global_lora, prev_global, ranks_s [n_pad], batches(rows), lora0) ->
    (lora1, ranks_s, metrics)`` over all ``n_pad`` rows, equal on every
    rank.  ``batches`` is a function of the block's row range, so each
    rank gathers only its own minibatches."""
    mesh, client_ax = plan.mesh, plan.client_axis
    m = plan.n_pad // mesh.shape[client_ax]
    c = mesh.coord(client_ax)
    rows = slice(c * m, (c + 1) * m)

    def phases(base_params, global_lora, prev_global, ranks_s, batches,
               lora0=None):
        if lora0 is not None:
            lora0 = tree_map(lambda x: x[rows], lora0)
        lora1, r1, met = client_phases(base_params, global_lora, prev_global,
                                       ranks_s[rows], batches(rows), lora0)
        names = [(n, k) for n in lora1 for k in ("A", "B")]
        mkeys = sorted(met)
        got = _gather_rows(mesh, client_ax,
                           [lora1[n][k] for n, k in names] + [r1]
                           + [met[k] for k in mkeys])
        out = {n: {} for n in lora1}
        for (n, k), t in zip(names, got):
            out[n][k] = t
        at = len(names)
        return out, got[at], dict(zip(mkeys, got[at + 1:]))

    return phases


def _make_client_phases(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                        lora_scale: float, r_g: int, edit: EditConfig,
                        edit_active: bool, prune_active: bool,
                        hetlora_prune_gamma: float, tp=None) -> Callable:
    """The per-client half shared by the fused round and the async client
    update: ``(base_params, global_lora, prev_global, ranks_s, batches,
    lora0=None) -> (lora1, ranks_s, metrics)``, redistribute → train →
    prune → edit over the cohort; ``lora1`` is a freshly stacked tree.
    With ``lora0`` (FLoRA's restart draws, stacked) client ``i`` starts
    from row ``i`` masked to its rank instead of the global adapter.
    ``tp``: local training runs tensor-parallel (a 2-D round mesh)."""
    local_train = _make_local_train(cfg, opt_cfg, lora_scale=lora_scale,
                                    r_g=r_g, tp=tp)

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


def _scatter(stacked_lora, ranks, idx, lora1, ranks_s, kept=None,
             n_s: int | None = None) -> None:
    """Write the cohort's rows back into the persistent stacked state in
    place; with ``kept``, only those cohort rows (dropped clients keep
    their pre-round state); with ``n_s``, only the first ``n_s`` rows (a
    padded cohort's dummies never write back)."""
    with span("scatter"):
        if n_s is not None and n_s < idx.shape[0]:
            idx, ranks_s = idx[:n_s], ranks_s[:n_s]
            lora1 = tree_map(lambda x: x[:n_s], lora1)
        if kept is not None:
            idx = idx[kept]
            ranks_s = ranks_s[kept]
        for name, entry in stacked_lora.items():
            for m in ("A", "B"):
                rows = lora1[name][m]
                entry[m].index_copy_(0, idx,
                                     rows if kept is None else rows[kept])
        ranks.index_copy_(0, idx, ranks_s.to(ranks.dtype))


def make_fed_round_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                        lora_scale: float, r_g: int,
                        edit: EditConfig | None = None,
                        aggregator: str = "fedilora",
                        hetlora_beta: float = 1.0, mesh=None) -> Callable:
    """One round over already sampled, already gathered inputs (the
    reference's single-program round of its ``--fedround`` dry run)::

        round_step(base_params, stacked_lora[K,...], prev_global,
                   ranks[K] int32, p[K] f32,
                   batches {key: [K, steps, B, ...]})
            -> (global_new, clients[K,...], mean last-step loss)

    Client ``k`` trains from its row of ``stacked_lora`` on its rows of
    ``batches`` (:func:`_make_local_train`), is edited against
    ``prev_global`` when ``edit`` is on (:func:`_cohort_edit`), and the
    cohort aggregates through the registry (``AG.aggregate``, weights
    ``p``; ``fedilora_kernel`` is one ``dim_agg`` launch).  FLoRA folds
    dense deltas into the base weights and is refused, as the reference
    refuses it; use :func:`make_round_engine`.

    ``mesh``: the clients split over the mesh's batch axes
    (``repro_torch.sharding.batch_axes``: ``"data"``, or ``("pod",
    "data")`` flattened), each rank training its contiguous block of rows
    and the rows all-gathered (:func:`_meshed_phases`), and local training
    runs tensor-parallel over ``"model"`` when the mesh has that axis
    (``base_params`` are then the rank's pieces).  K must divide over the
    batch axes.  Every rank returns the same outputs."""
    edit = edit or EditConfig()
    if aggregator == "flora":
        raise ValueError("flora updates base weights; use make_round_engine")
    if aggregator not in AG.AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; have "
                         f"{sorted(AG.AGGREGATORS)}")
    plan = None
    if mesh is not None:
        from repro_torch.sharding import batch_axes
        axes = batch_axes(mesh)
        if not axes:
            raise ValueError(f"mesh {mesh.axis_names} has no batch axis "
                             "to split the clients over")
        tp = None
        if "model" in mesh.axis_names:
            from repro_torch.models.tensor_parallel import TensorParallel
            tp = TensorParallel(cfg, mesh)
        plan = _RoundMesh(mesh, axes if len(axes) > 1 else axes[0], tp,
                          None)
    local_train = _make_local_train(cfg, opt_cfg, lora_scale=lora_scale,
                                    r_g=r_g, tp=plan.tp if plan else None)

    def client_phases(base_params, _global, prev_global, ranks_s, batches,
                      lora0):
        loras, losses = [], []
        for i in range(ranks_s.shape[0]):
            lo, ls = local_train(base_params,
                                 {n: {m: e[m][i] for m in ("A", "B")}
                                  for n, e in lora0.items()}, ranks_s[i],
                                 {k: v[i] for k, v in batches.items()})
            loras.append(lo)
            losses.append(ls)
        if edit.enabled:
            loras, _ = _cohort_edit(loras, ranks_s, prev_global, edit, r_g)
        return stack_trees(loras), ranks_s, {
            "last_loss": torch.stack(losses)[:, -1]}

    @torch.no_grad()
    def round_step(base_params, stacked_lora, prev_global, ranks, p,
                   batches):
        if plan is None:
            lora1, _, met = client_phases(base_params, None, prev_global,
                                          ranks, batches, stacked_lora)
        else:
            K, n = ranks.shape[0], plan.mesh.shape[plan.client_axis]
            if K % n:
                raise ValueError(f"{K} clients do not divide over the "
                                 f"mesh's {plan.client_axis!r} axes ({n})")
            lora1, _, met = _meshed_phases(
                client_phases, plan._replace(n_pad=K))(
                    base_params, None, prev_global, ranks,
                    lambda rows: {k: v[rows] for k, v in batches.items()},
                    stacked_lora)
        global_new, _ = AG.aggregate(aggregator, lora1, ranks, p,
                                     hetlora_beta=hetlora_beta,
                                     lora_scale=lora_scale)
        return global_new, lora1, met["last_loss"].mean()

    return round_step


def make_round_engine(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                      lora_scale: float, r_g: int,
                      edit: EditConfig | None = None,
                      aggregator: str = "fedilora",
                      hetlora_beta: float = 1.0,
                      hetlora_prune_gamma: float = 0.0,
                      clip: float | None = None,
                      trim: float = 0.0,
                      faults: bool = False, mesh=None,
                      n_sample: int | None = None) -> Callable:
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
    place).

    ``mesh`` (with ``n_sample``): the round runs on every rank of a round
    mesh (module docstring); ``base_params`` are then the rank's pieces
    (``TensorParallel.shard_params`` on a 2-D mesh) and every other
    operand is whole."""
    if aggregator not in AG.AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; have "
                         f"{sorted(AG.AGGREGATORS)}")
    edit = edit or EditConfig()
    flora = aggregator == "flora"
    plan = _round_mesh(cfg, mesh, n_sample)
    tp = plan.tp if plan else None
    client_phases = _make_client_phases(
        cfg, opt_cfg, lora_scale=lora_scale, r_g=r_g, edit=edit,
        edit_active=edit.enabled and not flora,
        prune_active=aggregator == "hetlora" and hetlora_prune_gamma > 0,
        hetlora_prune_gamma=hetlora_prune_gamma, tp=tp)
    if plan:
        client_phases = _meshed_phases(client_phases, plan)

    @torch.no_grad()
    def round_step(base_params, stacked_lora, global_lora, prev_global,
                   ranks, sizes, data, idx, batch_idx, fault=None, *,
                   reinit=None):
        if flora and reinit is None:
            raise ValueError("FLoRA's round needs its reinit draws")
        n_s = idx.shape[0]
        lora0 = reinit[0] if flora else None
        if plan:
            idx, gidx, batch_idx, valid = _pad_cohort(
                idx, batch_idx, plan.n_pad, ranks.shape[0])
            # device-side batch gather of a row block: [rows, steps, B, ...]
            batches = lambda rows: {k: v[gidx[rows, None, None],
                                         batch_idx[rows]]
                                    for k, v in data.items()}
            if lora0 is not None:          # dummies restart from row 0
                rows0 = torch.arange(idx.shape[0], device=idx.device)
                lora0 = tree_map(lambda x: x[rows0.clamp(max=n_s - 1)],
                                 lora0)
            ranks_s = ranks[gidx]
            # dummy rows carry no weight, so no aggregator sees them
            sizes_s = torch.where(valid, sizes[gidx], torch.zeros_like(
                sizes[gidx]))
        else:
            valid = None
            # device-side batch gather: [n_s, steps, B, ...]
            with span("batch_gather"):
                batches = {k: v[idx[:, None, None], batch_idx]
                           for k, v in data.items()}
            ranks_s = ranks[idx]
            sizes_s = sizes[idx]
        lora1, ranks_s, metrics = client_phases(
            base_params, global_lora, prev_global, ranks_s, batches,
            lora0=lora0)
        if plan:
            metrics = {k: v[:n_s] for k, v in metrics.items()}

        agg_lora, kw, health, kept = lora1, {}, None, None
        if aggregator in ("fedilora_clip", "fedilora_clip_kernel"):
            kw["anchor"] = global_lora     # clipped-away mass stays here
        if faults:
            if plan:
                fault = _pad_fault(fault, idx.shape[0])
            agg_lora = _wire(lora1, fault)
            finite = _rows_finite(agg_lora)
            agg_lora = _sanitize_rows(agg_lora, finite)
            fin = finite.to(sizes_s.dtype)
            sizes_s = sizes_s * fault["weight"] * fin
            kw["fallback"] = global_lora
            kept = fault["kept"]
            keep, weight = fault["keep"] > 0, fault["weight"] > 0
            alive = keep & weight
            if valid is not None:          # dummy rows are nobody's health
                alive = alive & valid
            alive = alive.float()
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

        _scatter(stacked_lora, ranks, idx, lora1, ranks_s, kept, n_s)
        out = {"stacked_lora": stacked_lora, "ranks": ranks,
               "prev_global": global_lora, "metrics": metrics}
        if base_delta is not None:                      # FLoRA
            out["base_params"] = apply_weight_deltas(base_params, base_delta,
                                                     tp)
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
                            faults: bool = False, mesh=None,
                            n_sample: int | None = None) -> Callable:
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
    the wire corruption (the merge guard catches the poison).  ``mesh`` /
    ``n_sample``: as in :func:`make_round_engine`; the buffered rows are
    the real clients' (dummies sliced off)."""
    if aggregator == "flora":
        raise ValueError("flora updates base weights; it has no "
                         "buffered-async client half")
    edit = edit or EditConfig()
    plan = _round_mesh(cfg, mesh, n_sample)
    client_phases = _make_client_phases(
        cfg, opt_cfg, lora_scale=lora_scale, r_g=r_g, edit=edit,
        edit_active=edit.enabled,
        prune_active=aggregator == "hetlora" and hetlora_prune_gamma > 0,
        hetlora_prune_gamma=hetlora_prune_gamma,
        tp=plan.tp if plan else None)
    if plan:
        client_phases = _meshed_phases(client_phases, plan)

    @torch.no_grad()
    def client_update_step(base_params, stacked_lora, global_lora,
                           prev_global, ranks, sizes, data, idx, batch_idx,
                           fault=None):
        n_s = idx.shape[0]
        sizes_s = sizes[idx]
        if plan:
            idx, gidx, batch_idx, _ = _pad_cohort(idx, batch_idx, plan.n_pad,
                                                  ranks.shape[0])
            batches = lambda rows: {k: v[gidx[rows, None, None],
                                         batch_idx[rows]]
                                    for k, v in data.items()}
            ranks_s = ranks[gidx]
        else:
            with span("batch_gather"):
                batches = {k: v[idx[:, None, None], batch_idx]
                           for k, v in data.items()}
            ranks_s = ranks[idx]
        lora1, ranks_s, metrics = client_phases(base_params, global_lora,
                                                prev_global, ranks_s, batches)
        if plan:                           # dummies never reach the buffer
            idx, ranks_s = idx[:n_s], ranks_s[:n_s]
            lora1 = tree_map(lambda x: x[:n_s], lora1)
            metrics = {k: v[:n_s] for k, v in metrics.items()}
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


def apply_weight_deltas(params, deltas: dict, tp=None):
    """Fold FLoRA's dense deltas ``{spec: [L, out, in]}`` into the base
    weights (``[L, in, out]``) IN PLACE; returns ``params``.  ``tp``: the
    weights are a tensor-parallel rank's pieces, and each takes its piece
    of the delta."""
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
        upd = delta.transpose(-1, -2)
        if tp is not None:
            upd = tp.shard_site_delta(name, upd)
        w.add_(upd.to(w.dtype))
    return params


__all__ = ["apply_weight_deltas", "cohort_pad", "make_buffer_merge_step",
           "make_client_update_step", "make_fed_round_step",
           "make_round_engine", "stack_trees"]
