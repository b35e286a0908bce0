"""Tensor parallelism over a mesh's ``"model"`` axis, written by hand for
every family: dense, prefix- and cross-attention VLMs, MoE, MLA, Mamba-2,
hybrid and encoder-decoder stacks.

The plan splits each sublayer whose parallel dimension divides the axis
into contiguous, whole pieces (heads, ``d_ff`` columns, expert columns)
and keeps every other sublayer whole on every rank, where it runs without
a collective:

* attention (self, the cross VLM's gated cross layers, the enc-dec
  decoder's cross layers and the encoder's self-attention): ``wq`` /
  ``wk`` / ``wv`` (and their biases) column-parallel over contiguous
  heads, ``wo`` row-parallel — when ``num_heads`` divides the axis and
  ``num_kv_heads`` divides it or it divides ``num_kv_heads`` (qwen2-72b's
  64 / 8 and gemma3-12b's 16 / 8 on 16).  A GQA group stays on one rank;
  where the K/V heads are fewer than the ranks, each rank holds the one
  K/V head its query heads read (its ``wk`` / ``wv`` columns, biases and
  cache head), shared by ``n / num_kv_heads`` ranks, whose adapter
  gradients the one all-reduce of :meth:`reduce_lora_grads` sums.  Query
  heads that do not divide (minicpm-2b's 36, llama4-scout's 40 on 16)
  keep attention whole.  A cross layer's static K/V (the vision's or the
  encoder's) holds the rank's KV heads; its ``gate`` stays whole and
  scales the reduced output;
* the MLP (and the encoder's, and a MoE's shared expert): ``w1`` / ``w3``
  column-parallel over ``d_ff``, ``w2`` row-parallel, when ``d_ff``
  divides;
* MoE: the ``router`` whole, so every rank makes the same routing
  decisions (ids, places, drops) from the whole input; the experts'
  ``w1`` / ``w3`` column-parallel over ``d_ff_expert``, ``w2``
  row-parallel; the routed and the shared experts' partial outputs pass
  one all-reduce — when ``d_ff_expert`` and the shared width divide.
  The expert dimension splits over ``"data"`` under expert parallelism
  (``ep``; ``repro_torch.models.layers.moe_forward``);
* MLA: ``wdq`` and ``wkv_a`` whole (so the compressed cache is whole on
  every rank), ``wuq`` (or ``wq``) and ``wkv_b`` column-parallel over
  heads, ``wo`` row-parallel — when ``num_heads`` divides;
* Mamba-2: ``in_proj``'s output ``[z | xs | B | C | dt]`` is cut segment
  by segment — ``z``, ``xs`` and ``dt`` by SSM heads, the one group's
  ``B`` / ``C`` columns whole on every rank — and the conv channels
  ``[xs | B | C]`` likewise; ``A_log``, ``D``, ``dt_bias`` and
  ``gate_norm`` by heads; ``out_proj`` row-parallel over ``d_in`` — when
  the SSM heads divide (mamba2-130m's 24 on 16 do not; the reference's
  ``fit_spec`` replicates that ``in_proj`` too).  The gated RMS norm
  spans the whole ``d_in``: its
  mean square is each rank's mean times ``d_local / d_in``, summed over
  the axis (exact at one rank);
* the vocabulary: ``embed`` ``[V, d]`` split over rows, ``unembed`` ``[d,
  V]`` over columns, when ``V`` divides: a masked lookup plus an
  all-reduce embeds a token, and the loss and the greedy argmax combine
  the ranks' pieces of the logits;
* everything else (norms, ``vision_proj``, the enc-dec frontend
  ``encoder.in_proj``, which shares its name with Mamba's) stays whole.

The plan reads a weight's place in the tree, not only its name, and
departs from the partition rules of ``repro_torch.sharding`` (kept equal
to the reference's) where they would mix segments or heads: the rules cut
``in_proj`` and ``conv_w`` into contiguous blocks, split ``wdq`` /
``wkv_a`` and ``encoder.in_proj``, and replicate the SSM's per-head
leaves.

A column-parallel product's input passes ``mesh.copy_to`` (its gradient is
a partial sum on each rank) and a row-parallel product's output
``mesh.reduce_from`` (the partial sums are added).  Adapters and their
optimizer state stay whole on every rank: :meth:`TensorParallel.local_lora`
gives the forward the rows of ``B`` its rank computes at a column-parallel
site and the columns of ``A`` it reads at a row-parallel one (differentiable
views and concatenations, so gradients reach the whole adapter), and
:meth:`TensorParallel.reduce_lora_grads` adds the ranks' partial gradients
in one all-reduce.  At an axis of size 1 every piece is the whole tensor
and each collective returns its operand, so the results equal the
unsharded ones bit for bit.

The production steps' placements around the plan (the reference's
``param_spec`` and ``cache_spec`` modes, chosen by the dry run's
``--sharding-mode``):

* FSDP (``fsdp=True``): each weight that ``param_spec`` splits over
  ``"data"`` is held as this rank's 1/``data`` piece of that dimension
  after the ``"model"`` cut, and :meth:`gather` all-gathers a block's
  pieces as the block starts (inside its remat region, so the recompute
  gathers them again) and drops them with the block; the base weights
  take no gradient, so nothing is reduce-scattered.  Round and serving
  meshes, whose ``"data"`` axis holds clients or slots, keep
  ``param_spec_tp``'s placement (``fsdp=False``);
* a batch split over the batch axes (:meth:`batched`): the MoE routes,
  and the loss divides by the mask count of, the global batch;
* sequence parallelism (``sp=True``, train only): the residual stream is
  each rank's ``S / n`` rows (``transformer._run_blocks``);
  :meth:`sp_gather` / :meth:`sp_scatter` are its collectives, and
  :attr:`inner` the plan a sublayer runs under between them;
* sequence-split decode caches (``seq``, the long-context fallback over
  ``"data"``) and ``scoreshard``: :meth:`all_heads`, :meth:`own_heads` and
  :meth:`combine` (``layers.attention_decode_batch``,
  ``layers.mla_decode_batch``).
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_ATTN = {"wq": -1, "wk": -1, "wv": -1, "bq": -1, "bk": -1, "bv": -1,
         "wo": -2}
_KV = ("wk", "wv", "bk", "bv")
_MLP = {"w1": -1, "w3": -1, "w2": -2}
# sublayer (the parent in the tree) -> (the plan's flag, {weight: the
# dimension cut, counted from the end: -1 columns, -2 rows})
_SUBLAYERS = {
    "attn": ("attn", _ATTN), "cross": ("attn", _ATTN),
    "dec_cross": ("attn", _ATTN),
    "ffn": ("mlp", _MLP), "moe": ("moe", _MLP), "shared": ("moe", _MLP),
    "mla": ("mla", {"wq": -1, "wuq": -1, "wkv_b": -1, "wo": -2}),
    "mamba": ("mamba", {"in_proj": -1, "conv_w": -1, "conv_b": -1,
                        "A_log": -1, "D": -1, "dt_bias": -1,
                        "gate_norm": -1, "out_proj": -2}),
}


class TensorParallel:
    """The split of one model over ``mesh``'s ``axis`` at this rank, and
    the placement of the production steps around it.

    ``fsdp``: the base weights that ``repro_torch.sharding.param_spec``
    splits over ``"data"`` are held as this rank's 1/``data`` piece of that
    dimension (after the ``"model"`` cut) and all-gathered over ``"data"``
    right before the sublayer or block that reads them (:meth:`gather`).
    ``ep``: the MoE experts' dimension is split over ``"data"`` (each rank
    holds E/``data`` experts; where E does not divide, the experts stay
    whole and ``ep_degraded`` is set).  ``sp``: sequence parallelism over
    ``axis`` in the training forward.  ``axis=None`` (or a mesh without
    ``axis``) gives a plan that splits no sublayer: a batch-sharded step
    over whole weights."""

    def __init__(self, cfg: ModelConfig, mesh, axis: str = "model", *,
                 fsdp: bool = False, ep: bool = False, sp: bool = False):
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        on = self.has_axis = axis in mesh.axis_names
        n = self.n = mesh.shape[axis] if on else 1
        self.rank = mesh.coord(axis) if on else 0
        h, kv = cfg.num_heads, cfg.num_kv_heads
        # K/V heads fewer than the axis: each rank reads the one K/V head of
        # its query heads, held by n / kv ranks
        self.attn = on and h % n == 0 and (kv % n == 0 or n % kv == 0)
        self.kv_groups = n if kv % n == 0 else kv
        self.mlp = on and cfg.d_ff > 0 and cfg.d_ff % n == 0
        mo = cfg.moe
        self.moe = on and mo is not None and mo.d_ff_expert % n == 0 and (
            (mo.d_ff_shared or mo.d_ff_expert) * mo.num_shared_experts
            % n == 0)
        self.mla = on and cfg.mla is not None and cfg.num_heads % n == 0
        s = cfg.ssm
        self.mamba = on and s is not None and (
            s.expand * cfg.d_model // s.head_dim) % n == 0
        self.vocab = on and cfg.vocab_size % n == 0
        self.v_local = cfg.vocab_size // n if self.vocab else cfg.vocab_size
        self.v0 = self.rank * self.v_local if self.vocab else 0
        self._segments = {}
        if s is not None:
            d_in = s.expand * cfg.d_model
            N, H = s.state_dim, d_in // s.head_dim
            self._segments = {
                "in_proj": ((d_in, True), (d_in, True), (N, False),
                            (N, False), (H, True)),
                "conv_w": ((d_in, True), (N, False), (N, False))}
            self._segments["conv_b"] = self._segments["conv_w"]
        has_data = "data" in mesh.axis_names
        self.data_n = mesh.shape["data"] if has_data else 1
        self.fsdp = bool(fsdp) and has_data
        ep_asked = bool(ep) and mo is not None
        self.ep = ep_asked and has_data and mo.num_experts % self.data_n == 0
        self.ep_degraded = ep_asked and not self.ep
        self.sp = bool(sp) and on
        self.batch_axes, self.dp = None, 1
        self._inner = False
        self._data_dims = (self._data_plan("ep" if ep_asked else "baseline")
                           if self.fsdp or self.ep else {})

    # ------------------------------------------------------------ variants
    def batched(self, axes) -> "TensorParallel":
        """This plan for a step whose batch is split over ``axes`` (the
        mesh's batch axes): MoE capacity, queue places and the aux loss,
        and the loss's mask count, span the global batch."""
        out = copy.copy(self)
        out.batch_axes = axes or None
        out.dp = self.mesh.shape[axes] if axes else 1
        return out

    @property
    def inner(self) -> "TensorParallel":
        """This plan with :meth:`copy` and :meth:`reduce` as identities:
        a sequence-parallel sublayer's input is gathered, and its output
        reduce-scattered, around it."""
        out = copy.copy(self)
        out._inner = True
        return out

    # -------------------------------------------------------------- weights
    def plan(self, parent: str, name: str):
        """How this plan cuts weight ``name`` of sublayer ``parent`` over
        ``axis``: ``(dim, segments, groups)`` — the dimension (from the
        end), for Mamba's concatenated projections the ``(size, split)``
        segments along it (``None``: one contiguous block), and the number
        of distinct pieces (``n``; ``num_kv_heads`` for a K/V head that
        ``n / num_kv_heads`` ranks share) — or ``None`` (whole on every
        rank)."""
        if name in ("embed", "unembed") and parent == "":
            return ((-2 if name == "embed" else -1), None, self.n) \
                if self.vocab else None
        flag, dims = _SUBLAYERS.get(parent, (None, {}))
        if name not in dims or not getattr(self, flag):
            return None
        groups = self.kv_groups if flag == "attn" and name in _KV else self.n
        return dims[name], (self._segments.get(name)
                            if parent == "mamba" else None), groups

    def _cut(self, t: torch.Tensor, plan) -> torch.Tensor:
        """This rank's piece of ``t`` under ``plan`` (views where the
        piece is one block, else a concatenation; both differentiable)."""
        dim, segs, groups = plan
        if segs is None:
            size = t.shape[dim] // groups
            return t.narrow(dim, self.rank // (self.n // groups) * size,
                            size)
        parts, at = [], 0
        for size, split in segs:
            if split:
                loc = size // self.n
                parts.append(t.narrow(dim, at + self.rank * loc, loc))
            else:
                parts.append(t.narrow(dim, at, size))
            at += size
        return torch.cat(parts, dim=dim)

    def _join(self, piece: torch.Tensor, plan) -> torch.Tensor:
        """The whole tensor from every rank's ``piece`` (an all-gather)."""
        dim, segs, groups = plan
        dim = dim % piece.dim()
        got = self.mesh.all_gather(piece, self.axis, dim=dim)
        if segs is None:
            if groups == self.n:
                return got
            return torch.cat(got.chunk(self.n, dim=dim)[::self.n // groups],
                             dim=dim)
        ranks = got.chunk(self.n, dim=dim)
        parts, at = [], 0
        for size, split in segs:
            loc = size // self.n if split else size
            pieces = [r.narrow(dim, at, loc) for r in ranks]
            parts.extend(pieces if split else pieces[:1])
            at += loc
        return torch.cat(parts, dim=dim)

    def _data_plan(self, mode: str) -> dict:
        """``{(parent, name): (dim from the end, "fsdp" | "ep")}`` of every
        weight that ``param_spec`` splits over ``"data"``, from the whole
        model's shapes (on ``meta``): ``"ep"`` for the experts' dimension
        under expert parallelism (held cut), ``"fsdp"`` for the rest
        (gathered before use)."""
        from repro_torch.models.transformer import init_params
        from repro_torch.sharding import param_spec
        whole = init_params(self.cfg, device=torch.device("meta"),
                            generator=torch.Generator())
        out: dict = {}

        def visit(tree, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    visit(v, path + (k,))
                    continue
                spec = param_spec(path + (k,), tuple(v.shape), self.mesh,
                                  mode)
                for i, ax in enumerate(spec):
                    if ax == "data" or (isinstance(ax, tuple)
                                        and "data" in ax):
                        parent = path[-1] if path else ""
                        kind = "ep" if (parent == "moe" and v.dim() == 4
                                        and i == 1) else "fsdp"
                        if kind == "fsdp" and not self.fsdp:
                            continue
                        out[(parent, k)] = (i - v.dim(), kind)
        visit(whole, ())
        return out

    def _data_cut(self, t: torch.Tensor, parent: str, name: str):
        dd = self._data_dims.get((parent, name))
        if dd is None:
            return t
        size = t.shape[dd[0]] // self.data_n
        return t.narrow(dd[0], self.mesh.coord("data") * size, size)

    def full(self, parent: str, name: str, t: torch.Tensor) -> torch.Tensor:
        """Weight ``name`` of ``parent`` whole over ``"data"``: its FSDP
        piece all-gathered (a fresh buffer, freed with the caller's last
        reference), else ``t`` itself."""
        dd = self._data_dims.get((parent, name))
        if dd is None or dd[1] != "fsdp":
            return t
        return self.mesh.all_gather(t, "data", dim=dd[0] % t.dim())

    def gather(self, tree, parent: str = ""):
        """:meth:`full` of every leaf of a (sub)tree of the parameters,
        keyed as in the whole tree (a block ``{"s0": {"attn": ...}}``, a
        sublayer's ``{"wq": ...}`` with its ``parent``)."""
        if not self.fsdp:
            return tree
        return {k: (self.gather(v, k) if isinstance(v, dict)
                    else self.full(parent, k, v)) for k, v in tree.items()}

    def _walk(self, params, fn, path: tuple = ()):
        if isinstance(params, dict):
            return {k: self._walk(v, fn, path + (k,))
                    for k, v in params.items()}
        parent = str(path[-2]) if len(path) > 1 else ""
        return fn(params, parent, str(path[-1]))

    def shard_params(self, params):
        """This rank's pieces of a whole parameter tree (contiguous): the
        ``axis`` cut, then the ``"data"`` cut of FSDP and expert
        parallelism."""
        def cut(t, parent, name):
            plan = self.plan(parent, name)
            t = t if plan is None else self._cut(t, plan)
            t = self._data_cut(t, parent, name)
            return t if plan is None and (parent, name) not in \
                self._data_dims else t.contiguous()
        return self._walk(params, cut)

    def unshard_params(self, params):
        """The whole tree from every rank's pieces (all-gathers of each
        split weight: only when a trainer leaves this mesh)."""
        def join(t, parent, name):
            dd = self._data_dims.get((parent, name))
            if dd is not None:
                t = self.mesh.all_gather(t, "data", dim=dd[0] % t.dim())
            plan = self.plan(parent, name)
            return t if plan is None else self._join(t, plan)
        return self._walk(params, join)

    def _site_plan(self, name: str):
        """The plan of a LoRA site's base weight, by its spec name
        (``s0.mamba.in_proj``, ``enc.attn.wq``, ...)."""
        parent, weight = name.split(".")[-2:]
        return self.plan(parent, weight)

    def shard_site_delta(self, spec_name: str, delta: torch.Tensor):
        """The piece of a dense ``[L, in, out]`` delta to a LoRA site's
        base weight that this rank holds."""
        plan = self._site_plan(spec_name)
        return delta if plan is None else self._cut(delta, plan).contiguous()

    def _lora_cut(self, name: str, part: str, t: torch.Tensor):
        """A LoRA leaf (``A`` ``[..., r, in]``, ``B`` ``[..., out, r]``) as
        this rank's forward reads it: ``B``'s output rows at a
        column-parallel site, ``A``'s input columns at a row-parallel
        one; else the leaf itself."""
        plan = self._site_plan(name)
        if plan is None:
            return t
        dim, segs, groups = plan
        if dim == -1 and part == "B":
            return self._cut(t, (-2, segs, groups))
        if dim == -2 and part == "A":
            return self._cut(t, (-1, segs, groups))
        return t

    def local_lora(self, lora):
        """The forward's adapter: each split site's leaves cut to what
        this rank reads (gradients reach the whole adapter)."""
        if lora is None:
            return None
        return {n: {m: self._lora_cut(n, m, e[m]) for m in e}
                for n, e in lora.items()}

    def bank_b(self, name: str, b: torch.Tensor) -> torch.Tensor:
        """A serving bank's ``B`` leaf ``[..., out, r]`` of spec ``name`` as
        this rank holds it: its output rows at a column-parallel site,
        contiguous (the BGMV kernel takes no views)."""
        return self._lora_cut(name, "B", b).contiguous()

    def bank_a(self, name: str, a: torch.Tensor) -> torch.Tensor:
        """A serving bank's ``A`` leaf ``[..., r, in]``: its input columns
        at a row-parallel site (Mamba's ``out_proj``), contiguous."""
        return self._lora_cut(name, "A", a).contiguous()

    def reduce_lora_grads(self, grads) -> None:
        """Add the ranks' partial gradients of the split sites, in place,
        in one all-reduce (a K/V head that several ranks share is summed
        over them there too).  Under sequence parallelism every site of
        the block stack is partial (each rank's rows), so all of them."""
        leaves = [grads[n][m] for n in sorted(grads)
                  if self._site_plan(n) is not None
                  or (self.sp and n.startswith("s")) for m in ("A", "B")]
        if not leaves:
            return
        flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in leaves]),
                                    self.axis)
        at = 0
        for g in leaves:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    # ---------------------------------------------------------- activations
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._inner else self.mesh.copy_to(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._inner else self.mesh.reduce_from(x, self.axis)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of partial values that each rank goes on
        to use in its own partial computation (the gated norm's mean
        square): the gradient is summed too."""
        return self.mesh.sum_over(x, self.axis)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings from this rank's rows of the table."""
        table = self.full("", "embed", table)
        if not self.vocab:
            return table[tokens]
        loc = tokens - self.v0
        ok = (loc >= 0) & (loc < self.v_local)
        x = table[loc.clamp(0, self.v_local - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return self.reduce(x)

    def logits(self, x: torch.Tensor, params) -> torch.Tensor:
        """This rank's columns of the logits ([..., V / n] when the
        vocabulary splits)."""
        w = (self.full("", "embed", params["embed"]).T
             if self.cfg.tie_embeddings
             else self.full("", "unembed", params["unembed"]))
        return self.copy(x) @ w if self.vocab else x @ w

    def log_prob(self, logits: torch.Tensor, labels: torch.Tensor):
        """(log p(label), whether the label is the argmax) per position
        from this rank's logit columns: ``log_softmax(local)[y] + (lse_local
        - lse_global)``, both terms taken from the rank that holds ``y`` by
        an all-reduce, so every rank computes the same value and its
        gradient is the whole model's.  At one rank the correction is
        exactly 0."""
        if not self.vocab:
            logp = F.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, labels[..., None])[..., 0]
            return ll, logits.argmax(-1) == labels
        lse = torch.logsumexp(logits, dim=-1)
        m = self.mesh.all_reduce(lse.detach().clone(), self.axis, op="max")
        lse_g = m + torch.log(self.reduce(torch.exp(lse - m)))
        loc = labels - self.v0
        ok = (loc >= 0) & (loc < self.v_local)
        pick = torch.gather(F.log_softmax(logits, dim=-1), -1,
                            loc.clamp(0, self.v_local - 1)[..., None])[..., 0]
        both = torch.stack([pick, lse])
        own = self.reduce(torch.where(ok, both, torch.zeros_like(both)))
        return own[0] + (own[1] - lse_g), \
            self.argmax(logits.detach()) == labels

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The global argmax of the logits whose columns this rank holds;
        ties go to the lowest index, as ``torch.argmax`` breaks them."""
        if not self.vocab:
            return logits.argmax(-1)
        val, idx = logits.amax(-1), logits.argmax(-1)
        vals = self.mesh.all_gather(val[None].float(), self.axis)
        idxs = self.mesh.all_gather((idx + self.v0)[None], self.axis)
        best = vals.argmax(0)            # first rank holding the maximum
        return torch.gather(idxs, 0, best[None])[0]

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Every column of the logits on every rank (sampling draws from
        the whole vocabulary)."""
        if not self.vocab:
            return logits
        return self.mesh.all_gather(logits, self.axis, dim=-1)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """Logical or of a bool tensor over the axis."""
        return self.mesh.all_reduce(flag.to(torch.int32), self.axis,
                                    op="max") > 0

    # --------------------------------------------------- sequence parallel
    def sp_check(self, S: int) -> None:
        if S % self.n:
            raise ValueError(
                f"sequence parallelism splits the sequence over the "
                f"{self.axis!r} axis ({self.n} ranks); a sequence of {S} "
                "positions does not divide it")

    def sp_gather(self, h: torch.Tensor, grad: str = "reduce_scatter"):
        """A sublayer's input ``[B, S/n, d]`` gathered to ``[B, S, d]``;
        the gradient reduce-scattered (its consumers on each rank give a
        partial one) or, with ``grad="slice"``, sliced (each rank's is whole
        for its own rows: the MoE, a per-token function)."""
        return self.mesh.gather_seq(h, self.axis, 1, grad)

    def sp_scatter(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel output's partial sums ``[B, S, d]`` summed over
        the axis and left as this rank's rows ``[B, S/n, d]``."""
        return self.mesh.scatter_seq(y, self.axis, 1)

    def sp_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a ``[B, S, d]`` that every rank computed
        whole (the gradient of the other rows is each owner's)."""
        size = y.shape[1] // self.n
        return y.narrow(1, self.rank * size, size)

    # ------------------------------------------ sequence-split decode caches
    def all_heads(self, t: torch.Tensor, kv: bool = False) -> torch.Tensor:
        """Every head of ``t [..., heads, D]`` whose heads this rank holds
        (one all-gather over the axis; a K/V head that several ranks share
        kept once)."""
        got = self.mesh.all_gather(t, self.axis, dim=t.dim() - 2)
        groups = self.kv_groups if kv else self.n
        if groups == self.n:
            return got
        return torch.cat(got.chunk(self.n, dim=-2)[::self.n // groups],
                         dim=-2)

    def own_heads(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's query heads of ``t [..., H, D]``."""
        size = t.shape[-2] // self.n
        return t.narrow(-2, self.rank * size, size)

    def combine(self, out: torch.Tensor, lse: torch.Tensor, axis):
        """Attention over keys split over ``axis``: each rank's output
        ``out [..., H, D]`` normalised over its own keys, with their
        log-sum-exp ``lse [..., H]``, weighted by ``exp(lse - lse_max)`` over
        their sum.  Three all-reduces: the max and the weights' sum of
        ``[..., H]``, and the output.  At one rank the weight is exactly 1
        and the output is ``out`` bit for bit."""
        mesh = self.mesh
        m = mesh.all_reduce(lse.detach().clone(), axis, op="max")
        w = torch.exp(lse - m)
        tot = mesh.all_reduce(w.clone(), axis)
        y = mesh.all_reduce(((w / tot)[..., None] * out.float()).contiguous(),
                            axis)
        return y.to(out.dtype)


__all__ = ["TensorParallel"]
