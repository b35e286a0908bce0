"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) it traces rank 0's step
program on the production mesh — 16×16 (256 ranks) or 2×16×16 (512
ranks) — and writes one JSON record of its cost, its memory, its
collectives and its roofline terms at H100 constants.  Nothing runs on a
card and nothing allocates: ``main()`` starts a *fake* process group
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), builds the port's :class:`~repro_torch.launch.mesh.Mesh` on it, and
runs rank 0's step on ``meta`` tensors (``repro_torch.launch.specs``:
every op runs its shape function only) under :class:`Tracer`, a dispatch
mode of this module, which counts

* the FLOPs of every matmul-like op, with ``FlopCounterMode``'s own
  formulas (``torch.utils.flop_counter.flop_registry``), so a real run
  on the card under ``FlopCounterMode`` can be held equal to the trace;
* ``bytes accessed``: every non-view op's input and output bytes (eager
  PyTorch fuses nothing, so each op reads its inputs from memory and
  writes its outputs);
* the peak of live bytes the trace allocates above its arguments;

and reads the mesh's collective counters — the bytes of every
all-reduce, all-gather, reduce-scatter and all-to-all — into the
reference's schema (``repro_torch.launch.roofline.collective_bytes``).

What is traced.  A full-size stack traced op by op would take tens of
minutes per combination, so a step runs on the first ``b`` blocks of the
full-size weights (``cfg`` with ``num_layers = b · period``: the
embedding, the head and an enc-dec's encoder whole) at two consecutive
``b`` (1 and 2 for a prefill, 2 and 3 for a train or decode step, whose
first block differs: :func:`scaled_trace`), and a train step at 1 and 2
microbatches: every count is affine in the blocks and in the
microbatches, and the record holds it scaled to ``cfg.num_blocks`` blocks
and ``num_microbatches`` microbatches.  The peak is ``arguments +
(blocks − b) · bytes kept a block + the traced peak`` at the lower ``b``
(at two microbatches where the step runs two or more), the bytes kept a
block being the two traces' difference.  The scaled counts equal a
whole-stack trace's exactly (``tests/test_torch_dryrun.py``).

Records keep the reference's keys where a counterpart exists: ``arch``,
``shape``, ``mesh``, ``kind``, ``sharding_mode``, ``num_microbatches``,
``trace_s`` (in place of ``lower_s`` / ``compile_s``), ``cost_analysis``
(``flops``, ``bytes accessed``), ``memory_analysis``
(``argument_size_bytes`` exact from the fake trees, ``temp_size_bytes``,
``peak_bytes``, ``fits`` against ``HBM_BYTES``), ``collectives``,
``roofline_traced`` (the port's program at H100 constants) beside
``roofline`` (the analytic model, ``repro_torch.launch.analytic``, which
assumes the reference's FSDP placement), ``model_flops_per_device`` and
``useful_flops_ratio``; plus ``traced_blocks``,
``traced_microbatches`` and ``traced_to_analytic_flops``.

Placements.  Every step runs the reference's ``param_spec``: tensor
parallel over ``"model"`` (``repro_torch.models.tensor_parallel``) and
FSDP over ``"data"`` (each rank holds 1/16 of every large weight and
gathers a block's weights as the block runs).  ``--sharding-mode`` is
parsed as the reference parses it, by its ``_``-separated parts (``ep``,
``sp``, ``ep_sp``, ``seq``, ``scoreshard``, ``seq_scoreshard``, ...):

* ``ep``: MoE experts split over ``"data"``, the picks sent to their
  expert's owner and back by all-to-all (where E does not divide, the
  experts stay whole and the record says ``ep_degraded``);
* ``sp``: train steps run sequence parallel over ``"model"``
  (all-gathers and reduce-scatters in place of the all-reduces);
* ``seq``: decode caches split their sequence over ``"model"``;
* ``scoreshard``: MLA's decode scores split over ``"model"`` (every other
  arch runs its baseline, as in the reference).

A decode cache whose batch does not divide the batch axes splits its
sequence over ``"data"`` in every mode (the reference's fallback;
``long_500k``).  The record's ``placement`` says what ran.

Usage (records under ``build/dryrun/`` by default)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --jobs 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fedround --mesh both
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import roofline as RL
from repro_torch.launch.specs import (INPUT_SHAPES, abstract_cache,
                                      abstract_lora, abstract_params,
                                      batch_specs, supports_shape,
                                      tree_bytes)

DEFAULT_RANK = 32
RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "..", "build", "dryrun")
MODES = ("baseline", "ep", "sp", "ep_sp", "seq", "scoreshard")


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _tensors(xs, out: list) -> list:
    """The tensors among ``xs`` (lists and tuples opened, one level at a
    time, as aten ops take them)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


def _key(x):
    """A hashable stand-in for an op argument: a tensor's metadata, a
    list's items', a scalar itself."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, x.device.type, tuple(x.shape), x.stride(),
                x.storage_offset(), x.requires_grad)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return x


def _pure(func) -> bool:
    """Whether ``func`` returns fresh tensors and writes none of its
    arguments (no alias annotation anywhere in its schema)."""
    sch = func._schema
    return not any(a.alias_info is not None
                   for a in list(sch.arguments) + list(sch.returns))


class Tracer(TorchDispatchMode):
    """Counts, for every op dispatched while it is active, its FLOPs
    (``FlopCounterMode``'s formula where its registry has the op, without
    its module tracking), the bytes it reads and writes
    (``bytes_accessed``: inputs plus outputs of every op that is not a
    view), and follows the storages the ops allocate: an output whose
    storage is none of the op's inputs' is a new allocation, live until
    the storage is freed.  ``peak``: the most bytes so allocated that were
    live at once (the arguments and anything made before the trace are
    not counted).

    On ``meta`` tensors a pure op (fresh outputs, no aliasing, no writes)
    whose arguments match an earlier call's metadata is not run again:
    its outputs are new empty meta tensors of the shapes, strides and
    dtypes it gave before (the meta kernels of elementwise ops are Python
    and cost ~10^2 µs a call; a chunked attention repeats the same few
    dozen calls thousands of times)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self._cache: dict = {}
        self._pure: dict = {}
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.ops = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, from the cache where it can be, and
        its FLOPs."""
        pure = self._pure.get(func)
        if pure is None:
            pure = self._pure[func] = _pure(func)
        key = None
        if pure and all(t.device.type == "meta"
                        for t in _tensors(args, [])):
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
            hit = self._cache.get(key)
            if hit is not None:
                seq, meta, flops = hit
                outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in meta]
                return (outs[0] if seq is None else seq(outs)), flops
        out = func(*args, **kwargs)
        count = self._flops.get(func._overloadpacket)
        flops = count(*args, **kwargs, out_val=out) if count else 0
        if key is not None:
            if isinstance(out, torch.Tensor):
                seq, outs = None, [out]
            elif isinstance(out, (tuple, list)) and all(
                    isinstance(t, torch.Tensor) for t in out):
                seq, outs = type(out), list(out)
            else:
                return out, flops
            ins = {id(t.untyped_storage()) for t in _tensors(args, [])}
            if any(id(t.untyped_storage()) in ins for t in outs):
                # an output shares an input's storage though the schema
                # says nothing of it (``_unsafe_view``): never cached
                self._pure[func] = False
                return out, flops
            self._cache[key] = (seq, [(tuple(t.shape), t.stride(), t.dtype)
                                      for t in outs], flops)
        return out, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out, flops = self._run(func, args, kwargs)
        self.ops += 1
        self.flops += flops
        ins = _tensors(kwargs.values(), _tensors(args, []))
        outs = _tensors((out,), [])
        if not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        have = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in have:
                continue
            have.add(id(st))
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


@dataclasses.dataclass
class Trace:
    """What one traced call cost on this rank."""
    flops: int
    bytes_accessed: int
    peak: int                      # live bytes above the arguments
    counts: collections.Counter    # (op, axis) -> calls
    coll_bytes: collections.Counter  # (op, axis) -> operand bytes
    ops: int
    seconds: float

    def _combine(self, other: "Trace", a: float, b: float) -> "Trace":
        """``a · self + b · other``, field by field (the peak too)."""
        keys = set(self.counts) | set(other.counts)
        lin = lambda x, y: a * x + b * y
        return Trace(
            lin(self.flops, other.flops),
            lin(self.bytes_accessed, other.bytes_accessed),
            lin(self.peak, other.peak),
            collections.Counter({k: lin(self.counts[k], other.counts[k])
                                 for k in keys}),
            collections.Counter({k: lin(self.coll_bytes[k],
                                        other.coll_bytes[k]) for k in keys}),
            lin(self.ops, other.ops), lin(self.seconds, other.seconds))

    def __add__(self, o):
        return self._combine(o, 1, 1)

    def __sub__(self, o):
        return self._combine(o, 1, -1)

    def __mul__(self, k):
        return self._combine(self, k, 0)

    __rmul__ = __mul__


def trace(fn, *args, mesh=None) -> Trace:
    """Run ``fn(*args)`` under a :class:`Tracer` (``args``: meta tensors
    for the dry run; real ones work too, but are computed), with
    ``mesh``'s collective counters set to 0 first."""
    if mesh is not None:
        mesh.reset_collectives()
    t0 = time.perf_counter()
    with Tracer() as tr:
        out = fn(*args)
        del out
    secs = time.perf_counter() - t0
    counts = collections.Counter(mesh.collectives) if mesh else \
        collections.Counter()
    nbytes = collections.Counter(mesh.collective_bytes) if mesh else \
        collections.Counter()
    return Trace(tr.flops, tr.bytes_accessed, tr.peak, counts, nbytes,
                 tr.ops, secs)


def meta_copy(tree):
    """A ``meta`` tensor of the same shape, strides and dtype for every
    tensor leaf of ``tree``: the dry run's view of a real run's inputs."""
    if isinstance(tree, dict):
        return {k: meta_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(*(meta_copy(v) for v in tree)) \
            if hasattr(tree, "_fields") else \
            type(tree)(meta_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    return tree


# ---------------------------------------------------------------------------
# the steps, traced and scaled
# ---------------------------------------------------------------------------

def _blocks_cfg(cfg, b: int):
    """``cfg`` cut to its first ``b`` blocks (``b`` pattern periods)."""
    return dataclasses.replace(cfg, num_layers=b * cfg.period)


def scaled_trace(make_call, num_blocks: int, num_micro: int | None,
                 mesh=None, first: int = 1) -> tuple[Trace, dict]:
    """Trace ``make_call(b, m)`` — a ``(fn, args)`` pair for a step over
    ``b`` blocks and ``m`` microbatches (``num_micro=None``: a step with no
    microbatches, ``m`` is ignored) — at ``b`` = ``first`` and ``first +
    1`` and, for a train step that runs two or more microbatches, at
    ``m`` = 2 too, and return the trace scaled to ``num_blocks`` and
    ``num_micro`` with ``{"traced_blocks", "traced_microbatches",
    "kept_per_block", "trace_s"}``.

    Every count is affine in the blocks and the microbatches.  So is the
    peak from block ``first`` on and from the second microbatch on: the
    first block of a train step differs (its backward starts with the
    head's gradient alive), and so does a decode step's (the layer loop of
    ``decode_chunk`` keeps the last sublayer's outputs alive into the next
    block), so those trace from ``first=2``.  A stack of fewer than
    ``first + 2`` blocks is traced whole."""
    def run(b, m):
        fn, args = make_call(b, m)
        return trace(fn, *args, mesh=mesh)

    M = num_micro or 1
    if num_blocks < first + 2:
        first = num_blocks
    t1 = run(first, 1)
    if first == num_blocks:
        traced, k = [first], t1 * 0
    else:
        traced, k = [first, first + 1], run(first + 1, 1) - t1
    if M >= 2:
        t2 = run(first, 2)
        e_k = t2 - t1                        # one more microbatch
        total = (t1 - e_k) + M * (e_k + (num_blocks - first) * k)
        total.peak = t2.peak + (num_blocks - first) * k.peak
    else:
        t2 = None
        total = t1 + (num_blocks - first) * k
        total.peak = t1.peak + (num_blocks - first) * k.peak
    # k.seconds is the second trace's time less the first's
    total.seconds = t1.seconds * len(traced) + k.seconds + (
        t2.seconds if t2 else 0.0)
    return total, {"traced_blocks": traced,
                   "traced_microbatches": min(M, 2),
                   "kept_per_block": k.peak, "trace_s": total.seconds}


def _mesh_dims(mesh) -> tuple:
    from repro_torch.sharding import batch_axes
    axes = batch_axes(mesh) if mesh is not None else None
    dp = mesh.shape[axes] if axes else 1
    return axes, dp


def _local_batch(global_batch: int, dp: int) -> int:
    """A rank's rows of a global batch: split over the batch axes when they
    divide it, else every rank holds all of it (the reference's
    ``fit_spec`` then replicates the batch)."""
    return global_batch // dp if global_batch % dp == 0 else global_batch


def mode_parts(mode: str) -> dict:
    """The reference's reading of a ``--sharding-mode`` string."""
    parts = mode.split("_")
    return {"ep": "ep" in parts, "sp": "sp" in parts, "seq": "seq" in parts,
            "scoreshard": "scoreshard" in mode}


def step_calls(cfg, shape, *, mesh, tp, rank: int, num_micro_override=None,
               mode: str = "baseline"):
    """The abstract inputs of ``shape``'s step on this rank and a
    ``make_call(b, m)`` for :func:`scaled_trace`: ``(args_bytes,
    num_micro, make_call)``.  ``args_bytes`` are the whole model's; a
    traced call over ``b`` blocks reads the first ``b`` blocks of them.
    A batch that divides the batch axes is split over them (the steps get
    ``mesh``: the global batch's MoE routing and loss); a decode cache
    splits its sequence as ``repro_torch.sharding.decode_cache_axis``
    says for ``mode``."""
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding import decode_cache_axis
    _, dp = _mesh_dims(mesh)
    lora_scale = 16.0 / rank
    B = _local_batch(shape.global_batch, dp)
    split = mesh if mesh is not None and B != shape.global_batch else None
    kind = shape.kind
    parts = mode_parts(mode)
    cache_axis = score_axis = None
    if kind == "decode" and mesh is not None:
        cache_axis = decode_cache_axis(mesh, shape.global_batch,
                                       shape.seq_len,
                                       "seq" if parts["seq"] else "baseline")
        if parts["scoreshard"] and cfg.mla is not None \
                and "model" in mesh.axis_names:
            score_axis = "model"
    num_micro = None
    if kind == "train":
        num_micro = num_micro_override or max(shape.global_batch // dp, 1)
        if B % num_micro:
            raise ValueError(f"{num_micro} microbatches do not divide a "
                             f"rank's batch of {B}")

    def inputs(c):
        """(params, lora, opt state | cache | None, the step's batch)."""
        params, lora = abstract_params(c, tp), abstract_lora(c, rank)
        if kind == "train":
            return params, lora, adamw_init(lora), batch_specs(
                cfg, B, shape.seq_len, with_labels=True)
        if kind == "prefill":
            return params, lora, None, batch_specs(cfg, B, shape.seq_len,
                                                   with_labels=False)
        return params, lora, abstract_cache(c, params, B, shape.seq_len,
                                            tp=tp, cache_axis=cache_axis), \
            torch.empty((B,), dtype=torch.long, device="meta")

    args = inputs(cfg)
    params, lora, state, batch = args
    opt_cfg = OptimizerConfig(peak_lr=1e-4, total_steps=1000)

    def make_call(b, m):
        cb = _blocks_cfg(cfg, b)
        if kind == "train":
            step = make_train_step(cb, opt_cfg, lora_scale=lora_scale,
                                   num_microbatches=m, tp=tp, mesh=split)
            mbs = batch_specs(cfg, m * (B // num_micro), shape.seq_len,
                              with_labels=True)
            return step, (params, lora, state, mbs)
        if kind == "prefill":
            return make_prefill_step(cb, lora_scale=lora_scale, tp=tp,
                                     mesh=split), (params, lora, batch)
        serve = make_serve_step(cb, lora_scale=lora_scale, tp=tp, mesh=split,
                                cache_axis=cache_axis, score_axis=score_axis)
        local = (lambda lo: lo) if tp is None else tp.local_lora
        return (lambda p, lo, c, t: serve(p, local(lo), c, t,
                                          shape.seq_len - 1)), \
            (params, lora, state, batch)

    make_call.placement = {"batch_split": split is not None,
                           "cache_axis": cache_axis,
                           "score_axis": score_axis}
    return tree_bytes(args), num_micro, make_call


def make_tp(cfg, mesh, kind: str, mode: str = "baseline"):
    """The production steps' plan on ``mesh`` under ``mode``: tensor
    parallel over ``"model"`` with FSDP over ``"data"``, expert parallel
    under ``ep``, sequence parallel under ``sp`` (train steps only, as in
    the reference)."""
    from repro_torch.models.tensor_parallel import TensorParallel
    if "model" not in mesh.axis_names:
        return None
    parts = mode_parts(mode)
    return TensorParallel(cfg, mesh, fsdp=True, ep=parts["ep"],
                          sp=parts["sp"] and kind == "train")


def _memory(args_bytes: int, temp: int) -> dict:
    peak = args_bytes + temp
    return {"argument_size_bytes": args_bytes, "temp_size_bytes": temp,
            "peak_bytes": peak, "hbm_bytes": RL.HBM_BYTES,
            "fits": peak <= RL.HBM_BYTES}


def _coll(mesh, t: Trace) -> dict:
    if mesh is None:
        return RL.collective_bytes(None, collections.Counter(),
                                   collections.Counter())
    return RL.collective_bytes(mesh, t.counts, t.coll_bytes)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _shape_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def _check_mode(sharding_mode: str) -> None:
    known = {"baseline", "ep", "sp", "seq", "scoreshard"}
    if not set(sharding_mode.split("_")) <= known:
        raise ValueError(f"unknown sharding mode {sharding_mode!r}: its "
                         f"parts must be among {sorted(known)} (the "
                         f"reference's modes are {MODES})")


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool,
               rank: int = DEFAULT_RANK, sharding_mode: str = "baseline",
               num_micro_override: int | None = None, mesh=None,
               cfg=None) -> dict:
    """Trace one (arch × shape × mesh) combination on rank 0 (this
    process's rank) of ``mesh`` (default: the production mesh, which needs
    a process group of 256 or 512 ranks).  ``cfg`` overrides the arch's
    config (the tests pass reduced ones)."""
    from repro_torch.launch.analytic import analytic_terms, mesh_info
    from repro_torch.launch.mesh import make_production_mesh
    _check_mode(sharding_mode)
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
           "kind": shape.kind, "sharding_mode": sharding_mode}
    if num_micro_override:
        rec["num_micro_override"] = num_micro_override
    if not ok:
        rec["skipped"] = why
        return rec
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec["mesh"] = _shape_name(mesh)
    t0 = time.perf_counter()
    tp = make_tp(cfg, mesh, shape.kind, sharding_mode)
    args_bytes, num_micro, make_call = step_calls(
        cfg, shape, mesh=mesh, tp=tp, rank=rank,
        num_micro_override=num_micro_override, mode=sharding_mode)
    parts = mode_parts(sharding_mode)
    rec["placement"] = dict(
        make_call.placement, fsdp=bool(tp and tp.fsdp),
        expert_parallel=bool(tp and tp.ep),
        ep_degraded=bool(tp and tp.ep_degraded),
        seq_parallel=bool(tp and tp.sp),
        kv_heads_replicated=bool(tp and tp.attn and tp.kv_groups < tp.n),
        attention_split=bool(tp and (tp.attn or tp.mla)))
    total, how = scaled_trace(make_call, cfg.num_blocks, num_micro, mesh,
                              first=1 if shape.kind == "prefill" else 2)
    rec["trace_s"] = time.perf_counter() - t0
    if num_micro is not None:
        rec["num_microbatches"] = num_micro
    rec.update(how)
    rec["cost_analysis"] = {"flops": total.flops,
                            "bytes accessed": total.bytes_accessed}
    rec["memory_analysis"] = _memory(args_bytes, total.peak)
    rec["collectives"] = _coll(mesh, total)
    rec["roofline_traced"] = RL.roofline(rec["cost_analysis"],
                                         rec["collectives"]).as_dict()
    opts = {}
    if parts["ep"]:
        opts["expert_parallel"] = True
    if parts["sp"]:
        opts["seq_parallel"] = True
    at = analytic_terms(cfg, shape, mesh_info(multi_pod), rank=rank,
                        num_micro=num_micro, opts=opts)
    rec["roofline"] = at.roofline()
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch
    n_dev = 512 if multi_pod else 256
    rec["model_flops_per_device"] = model_flops / n_dev
    a_flops = rec["roofline"]["flops_per_device"]
    rec["useful_flops_ratio"] = (rec["model_flops_per_device"] / a_flops
                                 if a_flops else None)
    rec["traced_to_analytic_flops"] = (total.flops / a_flops if a_flops
                                       else None)
    return rec


def fed_round_call(cfg, K: int, *, mesh, tp, rank: int, local_steps: int,
                   client_batch: int, seq: int,
                   aggregator: str = "fedilora"):
    """``(args_bytes, fn, args)`` of one fed round step over K clients,
    on meta tensors."""
    from repro_torch.launch.fedround import make_fed_round_step
    from repro_torch.optim import OptimizerConfig
    params = abstract_params(cfg, tp)
    lora = abstract_lora(cfg, rank)
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                             device="meta")
    stacked = {n: {m: empty((K,) + tuple(t.shape), t.dtype)
                   for m, t in e.items()} for n, e in lora.items()}
    ranks = empty((K,), torch.int32)
    p = empty((K,), torch.float32)
    one = batch_specs(cfg, client_batch, seq, with_labels=True)
    batches = {k: empty((K, local_steps) + tuple(v.shape), v.dtype)
               for k, v in one.items()}
    step = make_fed_round_step(
        cfg, OptimizerConfig(peak_lr=1e-3, total_steps=100),
        lora_scale=16.0 / rank, r_g=rank, aggregator=aggregator, mesh=mesh)
    args = (params, stacked, lora, ranks, p, batches)
    return tree_bytes(args), step, args


def dryrun_fedround(arch: str, *, multi_pod: bool, rank: int = DEFAULT_RANK,
                    local_steps: int = 4, client_batch: int = 16,
                    seq: int = 256, mesh=None, cfg=None) -> dict:
    """Trace one federated round (:func:`make_fed_round_step`) on rank 0:
    K clients (the batch axes' size) train their adapters, each rank its
    block of clients, tensor-parallel over ``"model"``, and aggregate with
    FediLoRA's dimension-wise reweighting.  Traced whole."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.tensor_parallel import TensorParallel
    cfg = cfg or get_config(arch)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    _, K = _mesh_dims(mesh)
    rec = {"arch": arch, "shape": f"fedround_K{K}",
           "mesh": _shape_name(mesh), "kind": "fedround",
           "sharding_mode": "client-data-parallel",
           "mesh_axes": list(mesh.axis_names), "local_steps": local_steps,
           "client_batch": client_batch, "seq": seq}
    tp = TensorParallel(cfg, mesh) if "model" in mesh.axis_names else None
    args_bytes, step, args = fed_round_call(
        cfg, K, mesh=mesh, tp=tp, rank=rank, local_steps=local_steps,
        client_batch=client_batch, seq=seq)
    t = trace(step, *args, mesh=mesh)
    rec["trace_s"] = t.seconds
    rec["cost_analysis"] = {"flops": t.flops,
                            "bytes accessed": t.bytes_accessed}
    rec["memory_analysis"] = _memory(args_bytes, t.peak)
    rec["collectives"] = _coll(mesh, t)
    rec["roofline_traced"] = RL.roofline(rec["cost_analysis"],
                                         rec["collectives"]).as_dict()
    return rec


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def fake_process_group(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of
    ``world_size`` ranks (replacing any group it is in)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def _tag(arch, shape, mp, mode="baseline", num_micro=0) -> str:
    tag = f"{arch}__{shape}__{_mesh_name(mp)}"
    if mode != "baseline":
        tag += f"__{mode}"
    if num_micro:
        tag += f"__m{num_micro}"
    return tag


def _run_task(task: tuple) -> tuple:
    """One combination in this process: ``(kind, arch, shape, multi_pod,
    rank, mode, num_micro, out)`` -> ``(tag, record)``; the record is also
    written to ``out``."""
    kind, arch, shape, mp, rank, mode, num_micro, out = task
    fake_process_group(512 if mp else 256)
    if kind == "fedround":
        tag = f"{arch}__fedround__{_mesh_name(mp)}"
        try:
            rec = dryrun_fedround(arch, multi_pod=mp, rank=rank)
        except Exception:
            rec = {"arch": arch, "mesh": _mesh_name(mp),
                   "error": traceback.format_exc()}
    else:
        tag = _tag(arch, shape, mp, mode, num_micro)
        try:
            rec = dryrun_one(arch, shape, multi_pod=mp, rank=rank,
                             sharding_mode=mode,
                             num_micro_override=num_micro or None)
        except Exception:
            rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                   "error": traceback.format_exc()}
    with open(os.path.join(out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    return tag, rec


def _report(tag: str, rec: dict) -> None:
    print(f"== dryrun {tag}", flush=True)
    if "error" in rec:
        print(rec["error"], flush=True)
    elif "skipped" in rec:
        print(f"   skipped: {rec['skipped']}", flush=True)
    else:
        r = rec["roofline_traced"]
        mem = rec["memory_analysis"]
        line = (f"   trace {rec['trace_s']:.1f}s | traced: compute "
                f"{r['compute_s'] * 1e3:.2f}ms mem {r['memory_s'] * 1e3:.2f}ms "
                f"coll {r['collective_s'] * 1e3:.2f}ms -> {r['dominant']} | "
                f"peak {mem['peak_bytes'] / 2**30:.2f} GiB "
                f"fits={mem['fits']}")
        if "roofline" in rec:
            line += f" | analytic -> {rec['roofline']['dominant']}"
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--rank", type=int, default=DEFAULT_RANK)
    ap.add_argument("--sharding-mode", default="baseline")
    ap.add_argument("--num-micro", type=int, default=0,
                    help="override training microbatch count")
    ap.add_argument("--fedround", action="store_true",
                    help="trace one federated round (K clients = the batch "
                         "axes) instead of the per-shape steps")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, each in a process "
                         "of its own")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    _check_mode(args.sharding_mode)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    if args.fedround:
        archs = ["fedbench-100m"] if args.arch == "all" else [args.arch]
        tasks = [("fedround", a, None, mp, args.rank, "baseline", 0,
                  args.out) for a in archs for mp in meshes]
    else:
        archs = list_archs() if args.arch == "all" else [args.arch]
        shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
        tasks = [("step", a, s, mp, args.rank, args.sharding_mode,
                  args.num_micro, args.out)
                 for a in archs for s in shapes for mp in meshes]
    t0 = time.perf_counter()
    if args.jobs > 1 and len(tasks) > 1:
        import multiprocessing as mp_
        ctx = mp_.get_context("spawn")
        with ctx.Pool(min(args.jobs, len(tasks))) as pool:
            results = pool.imap(_run_task, tasks)
            done = []
            for tag, rec in results:
                _report(tag, rec)
                done.append(rec)
    else:
        done = []
        for task in tasks:
            tag, rec = _run_task(task)
            _report(tag, rec)
            done.append(rec)
    failures = sum("error" in r for r in done)
    print(f"dryrun: {len(done)} records, {failures} failed, "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
