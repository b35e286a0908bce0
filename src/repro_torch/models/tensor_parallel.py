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
  heads, ``wo`` row-parallel — when both ``num_heads`` and
  ``num_kv_heads`` divide the axis (a GQA group then stays on one rank).
  A cross layer's static K/V (the vision's or the encoder's) holds the
  rank's KV heads; its ``gate`` stays whole and scales the reduced output;
* the MLP (and the encoder's, and a MoE's shared expert): ``w1`` / ``w3``
  column-parallel over ``d_ff``, ``w2`` row-parallel, when ``d_ff``
  divides;
* MoE: the ``router`` whole, so every rank makes the same routing
  decisions (ids, places, drops) from the whole input; the experts'
  ``w1`` / ``w3`` column-parallel over ``d_ff_expert``, ``w2``
  row-parallel; the routed and the shared experts' partial outputs pass
  one all-reduce; no expert-dimension split — when ``d_ff_expert`` and
  the shared width divide;
* MLA: ``wdq`` and ``wkv_a`` whole (so the compressed cache is whole on
  every rank), ``wuq`` (or ``wq``) and ``wkv_b`` column-parallel over
  heads, ``wo`` row-parallel — when ``num_heads`` divides;
* Mamba-2: ``in_proj``'s output ``[z | xs | B | C | dt]`` is cut segment
  by segment — ``z``, ``xs`` and ``dt`` by SSM heads, the one group's
  ``B`` / ``C`` columns whole on every rank — and the conv channels
  ``[xs | B | C]`` likewise; ``A_log``, ``D``, ``dt_bias`` and
  ``gate_norm`` by heads; ``out_proj`` row-parallel over ``d_in`` — when
  the SSM heads divide.  The gated RMS norm spans the whole ``d_in``: its
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_ATTN = {"wq": -1, "wk": -1, "wv": -1, "bq": -1, "bk": -1, "bv": -1,
         "wo": -2}
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
    """The split of one model over ``mesh``'s ``axis`` at this rank."""

    def __init__(self, cfg: ModelConfig, mesh, axis: str = "model"):
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        n = self.n = mesh.shape[axis]
        self.rank = mesh.coord(axis)
        self.attn = cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0
        self.mlp = cfg.d_ff > 0 and cfg.d_ff % n == 0
        mo = cfg.moe
        self.moe = mo is not None and mo.d_ff_expert % n == 0 and (
            (mo.d_ff_shared or mo.d_ff_expert) * mo.num_shared_experts
            % n == 0)
        self.mla = cfg.mla is not None and cfg.num_heads % n == 0
        s = cfg.ssm
        self.mamba = s is not None and (
            s.expand * cfg.d_model // s.head_dim) % n == 0
        self.vocab = cfg.vocab_size % n == 0
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

    # -------------------------------------------------------------- weights
    def plan(self, parent: str, name: str):
        """How this plan cuts weight ``name`` of sublayer ``parent``:
        ``(dim, segments)`` — the dimension (from the end) and, for
        Mamba's concatenated projections, the ``(size, split)`` segments
        along it (``None``: one contiguous block per rank) — or ``None``
        (whole on every rank)."""
        if name in ("embed", "unembed") and parent == "":
            return ((-2 if name == "embed" else -1), None) \
                if self.vocab else None
        flag, dims = _SUBLAYERS.get(parent, (None, {}))
        if name not in dims or not getattr(self, flag):
            return None
        return dims[name], (self._segments.get(name)
                            if parent == "mamba" else None)

    def _cut(self, t: torch.Tensor, plan) -> torch.Tensor:
        """This rank's piece of ``t`` under ``plan`` (views where the
        piece is one block, else a concatenation; both differentiable)."""
        dim, segs = plan
        if segs is None:
            size = t.shape[dim] // self.n
            return t.narrow(dim, self.rank * size, size)
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
        dim, segs = plan
        dim = dim % piece.dim()
        got = self.mesh.all_gather(piece, self.axis, dim=dim)
        if segs is None:
            return got
        ranks = got.chunk(self.n, dim=dim)
        parts, at = [], 0
        for size, split in segs:
            loc = size // self.n if split else size
            pieces = [r.narrow(dim, at, loc) for r in ranks]
            parts.extend(pieces if split else pieces[:1])
            at += loc
        return torch.cat(parts, dim=dim)

    def _walk(self, params, fn, path: tuple = ()):
        if isinstance(params, dict):
            return {k: self._walk(v, fn, path + (k,))
                    for k, v in params.items()}
        parent = str(path[-2]) if len(path) > 1 else ""
        plan = self.plan(parent, str(path[-1]))
        return params if plan is None else fn(params, plan)

    def shard_params(self, params):
        """This rank's pieces of a whole parameter tree (contiguous)."""
        return self._walk(params, lambda t, p: self._cut(t, p).contiguous())

    def unshard_params(self, params):
        """The whole tree from every rank's pieces (an all-gather of each
        split weight: only when a trainer leaves this mesh)."""
        return self._walk(params, self._join)

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
        dim, segs = plan
        if dim == -1 and part == "B":
            return self._cut(t, (-2, segs))
        if dim == -2 and part == "A":
            return self._cut(t, (-1, segs))
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
        in one all-reduce."""
        leaves = [grads[n][m] for n in sorted(grads)
                  if self._site_plan(n) is not None for m in ("A", "B")]
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
        return self.mesh.copy_to(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.reduce_from(x, self.axis)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of partial values that each rank goes on
        to use in its own partial computation (the gated norm's mean
        square): the gradient is summed too."""
        return self.mesh.sum_over(x, self.axis)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings from this rank's rows of the table."""
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
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
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


__all__ = ["TensorParallel"]
