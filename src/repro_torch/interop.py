"""Carry weights and federated state from the JAX reference into the port.

Both packages use the same parameter tree (``embed``, ``final_ln``,
``blocks.s{i}.attn.wq`` stacked ``[num_blocks, ...]``, ``vision_proj``...)
and the same adapter trees (``{spec: {"A", "B"}}``), so the mapping is leaf
for leaf.  Inputs are trees of numpy arrays (e.g.
``jax.device_get(T.init_params(...))`` or ``load_pytree`` of a
``save_pytree`` file); bf16 leaves arrive as ``ml_dtypes`` bfloat16 and are
reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import torch_dtype


def to_torch(arr, *, device="cpu", dtype=None) -> torch.Tensor:
    """One array → tensor on ``device`` (floating leaves cast to ``dtype``
    when given)."""
    a = np.array(arr)                    # a private, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _tree(tree, **kw):
    if isinstance(tree, dict):
        return {k: _tree(v, **kw) for k, v in tree.items()}
    return to_torch(tree, **kw)


def params_from_numpy(cfg: ModelConfig, tree: dict[str, Any], *, device=None,
                      dtype=None) -> dict[str, Any]:
    """The reference's parameter tree → the port's, on ``device``
    (``None`` = CUDA).  ``dtype`` defaults to ``cfg.dtype``."""
    device = resolve_device(device)
    return _tree(tree, device=device, dtype=torch_dtype(dtype or cfg.dtype))


def adapters_from_numpy(tree: dict[str, Any]) -> dict[str, dict]:
    """A ``{spec: {"A", "B"}}`` adapter tree → CPU tensors (the host master
    copies an ``AdapterStore`` registers), dtypes kept."""
    return {name: {p: to_torch(entry[p]) for p in ("A", "B")}
            for name, entry in tree.items()}


def lora_from_numpy(tree: dict[str, Any], *, device=None) -> dict[str, dict]:
    """An adapter tree (``{spec: {"A", "B"}}``, optionally with a leading
    client axis) → tensors on ``device`` (``None`` = CUDA), dtypes kept."""
    device = resolve_device(device)
    return {name: {p: to_torch(entry[p], device=device) for p in ("A", "B")}
            for name, entry in tree.items()}


def load_reference_state(trainer, *, base_params, global_lora, prev_global,
                         stacked_lora) -> None:
    """Start a port ``FederatedTrainer`` from a reference trainer's state:
    its base weights, server adapters (``server.global_lora``,
    ``server.prev_global``) and stacked client adapters, given as numpy
    trees (``jax.device_get`` of the reference trainer's attributes).
    Their init draws come from ``jax.random``, which torch cannot
    reproduce; everything after the init is the port's own."""
    dev = trainer.device
    trainer.base_params = params_from_numpy(trainer.mcfg, base_params,
                                            device=dev)
    trainer.server.global_lora = lora_from_numpy(global_lora, device=dev)
    trainer.server.prev_global = lora_from_numpy(prev_global, device=dev)
    trainer.stacked_lora = lora_from_numpy(stacked_lora, device=dev)


__all__ = ["adapters_from_numpy", "load_reference_state", "lora_from_numpy",
           "params_from_numpy", "to_torch"]
