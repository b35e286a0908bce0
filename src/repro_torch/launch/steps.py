"""Serving step functions (port of ``repro/launch/steps.py:103-207``).

The reference builds these as jit targets whose state and cache buffers
are donated.  Here they run eagerly and update the decode cache and the
engine's slot state IN PLACE; each returns the objects it updated, so the
call sites read like the reference's.

Both take the adapter bank scan-major, ``{spec: {"A": [L, G, r, in], "B":
[L, G, out, r]}}`` (``AdapterStore.scan_stack``), the layout the decode
loop indexes per layer.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

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


__all__ = ["make_chunked_prefill_step", "make_multi_adapter_serve_step"]
