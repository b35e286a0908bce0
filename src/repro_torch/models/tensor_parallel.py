"""Tensor parallelism over a mesh's ``"model"`` axis, written by hand for
the dense and prefix-VLM attention stacks (the families of fedbench-tiny,
fedbench-100m and qwen2-0.5b).

The rules of ``repro_torch.sharding.param_spec_tp`` say which weights
split; the execution here follows them where the split keeps whole
attention heads on each rank:

* attention: ``wq`` / ``wk`` / ``wv`` (and their biases) column-parallel
  over contiguous heads, ``wo`` row-parallel — when both ``num_heads`` and
  ``num_kv_heads`` divide the axis (a GQA group then stays on one rank);
  otherwise the sublayer's weights stay whole on every rank and it runs
  without a collective, although ``fit_spec`` alone (which checks only
  that ``heads × head_dim`` divides) would split them;
* the MLP: ``w1`` / ``w3`` column-parallel over ``d_ff``, ``w2``
  row-parallel, when ``d_ff`` divides;
* the vocabulary: ``embed`` ``[V, d]`` split over rows, ``unembed`` ``[d,
  V]`` over columns, when ``V`` divides: a masked lookup plus an
  all-reduce embeds a token, and the loss and the greedy argmax combine
  the ranks' pieces of the logits;
* everything else (norms, ``vision_proj``) stays whole.

A column-parallel product's input passes ``mesh.copy_to`` (its gradient is
a partial sum on each rank) and a row-parallel product's output
``mesh.reduce_from`` (the partial sums are added).  Adapters and their
optimizer state stay whole on every rank: :meth:`TensorParallel.local_lora`
gives the forward the columns of ``B`` its rank computes, and
:meth:`TensorParallel.reduce_lora_grads` adds the ranks' partial gradients
(of ``A`` over the column pieces, of ``B`` zero outside its columns) in
one all-reduce.  At an axis of size 1 every piece is the whole tensor and
each collective returns its operand, so the results equal the unsharded
ones bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.models.config import ModelConfig

# the LoRA sites of the attention stacks, all column-parallel
_LORA_SITES = ("attn.wq", "attn.wv")


class TensorParallel:
    """The split of one model over ``mesh``'s ``axis`` at this rank."""

    def __init__(self, cfg: ModelConfig, mesh, axis: str = "model"):
        bad = [k for k in cfg.pattern if k not in ("attn", "attn_local")]
        if bad or cfg.mla is not None or cfg.moe is not None \
                or cfg.family == "encdec" or (cfg.family == "vlm" and
                                              cfg.vision_mode != "prefix"):
            raise NotImplementedError(
                f"a (client, 'model') or ('data', 'model') mesh runs the "
                f"dense and prefix-VLM attention stacks; {cfg.name} "
                f"({cfg.family}, pattern {cfg.pattern}) waits for ROADMAP "
                "queue 1, item 1.1 (2-D meshes for the other families)")
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        n = self.n = mesh.shape[axis]
        self.rank = mesh.coord(axis)
        self.attn = cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0
        self.mlp = cfg.d_ff > 0 and cfg.d_ff % n == 0
        self.vocab = cfg.vocab_size % n == 0
        self.v_local = cfg.vocab_size // n if self.vocab else cfg.vocab_size
        self.v0 = self.rank * self.v_local if self.vocab else 0

    # -------------------------------------------------------------- weights
    def exec_spec(self, path: tuple, shape: tuple) -> SH.P:
        """The spec the execution splits a parameter by: the rule's
        (``param_spec_tp``), kept only where the plan splits that
        sublayer."""
        name = str(path[-1])
        parent = str(path[-2]) if len(path) > 1 else ""
        if name in ("bq", "bk", "bv"):          # follow their weights
            return SH.P(*(None,) * (len(shape) - 1), self.axis) \
                if self.attn else SH.P()
        ok = {"attn": self.attn, "ffn": self.mlp}.get(parent)
        if name in ("embed", "unembed"):
            ok = self.vocab
        if not ok:
            return SH.P()
        return SH.param_spec_tp(path, shape, self.mesh)

    def shard_params(self, params, path: tuple = ()):
        """This rank's pieces of a whole parameter tree (contiguous)."""
        if isinstance(params, dict):
            return {k: self.shard_params(v, path + (k,))
                    for k, v in params.items()}
        return SH.shard_local(params, self.exec_spec(path, tuple(
            params.shape)), self.mesh)

    def unshard_params(self, params, path: tuple = ()):
        """The whole tree from every rank's pieces (an all-gather of each
        split weight: only when a trainer leaves this mesh)."""
        if isinstance(params, dict):
            return {k: self.unshard_params(v, path + (k,))
                    for k, v in params.items()}
        spec = self.exec_spec(path, self._whole_shape(path, params))
        for dim, ax in enumerate(spec):
            if ax is not None:
                return self.mesh.all_gather(params, self.axis, dim=dim)
        return params

    def _whole_shape(self, path: tuple, piece: torch.Tensor) -> tuple:
        """The whole shape of a piece: the split dimension times n, where
        the piece's name splits at all (the rules split one dimension of
        each weight over ``"model"``)."""
        shape = list(piece.shape)
        name = str(path[-1])
        if name in ("embed",):
            dim = 0
        elif name in SH._DOWN_LIKE:
            dim = len(shape) - 2
        else:
            dim = len(shape) - 1
        shape[dim] *= self.n
        return tuple(shape)

    def shard_site_delta(self, spec_name: str, delta: torch.Tensor):
        """The piece of a dense ``[L, in, out]`` delta to a LoRA site's
        base weight that this rank holds."""
        if not self._split_site(spec_name):
            return delta
        return self._cols(delta, -1).contiguous()

    def _cols(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        size = t.shape[dim] // self.n
        return t.narrow(dim, self.rank * size, size)

    def _split_site(self, name: str) -> bool:
        return self.attn and name.split(".", 1)[-1] in _LORA_SITES

    def local_lora(self, lora):
        """The forward's adapter: ``B`` cut to this rank's output columns
        at the split sites (views, so gradients reach the whole ``B``)."""
        if lora is None:
            return None
        return {n: ({"A": e["A"], "B": self._cols(e["B"], -2)}
                    if self._split_site(n) else e) for n, e in lora.items()}

    def bank_b(self, name: str, b: torch.Tensor) -> torch.Tensor:
        """A serving bank's ``B`` leaf ``[..., out, r]`` of spec ``name`` as
        this rank holds it: its output columns at a split site, contiguous
        (the BGMV kernel takes no views)."""
        if not self._split_site(name):
            return b
        return self._cols(b, -2).contiguous()

    def reduce_lora_grads(self, grads) -> None:
        """Add the ranks' partial gradients of the split sites, in place,
        in one all-reduce."""
        leaves = [grads[n][m] for n in sorted(grads) if self._split_site(n)
                  for m in ("A", "B")]
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
