"""Carry weights and federated state from the JAX reference into the port.

Both packages use the same parameter tree (``embed``, ``final_ln``,
``blocks.s{i}.attn.wq`` stacked ``[num_blocks, ...]``, ``vision_proj``, a
cross layer's ``gate``, ``lnx`` and ``dec_cross``, the ``encoder`` stacked
``[encoder_layers, ...]``...) and the same adapter trees (``{spec: {"A",
"B"}}``, ``enc.*`` entries included), so the mapping is leaf for leaf.  Inputs are trees of numpy arrays (e.g.
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


def params_from_numpy(cfg: ModelConfig, tree: dict[str, Any], *,
                      device=None, mesh=None) -> dict[str, Any]:
    """The reference's parameter tree for ``cfg`` → the port's, on
    ``device`` (``None`` = CUDA).  Every leaf keeps the dtype the reference
    gave it: under a bf16 config the MoE router and Mamba's ``A_log``,
    ``D`` and ``dt_bias`` stay f32.  ``mesh`` (with a ``"model"`` axis):
    this rank's tensor-parallel pieces
    (``repro_torch.models.tensor_parallel.TensorParallel.shard_params``);
    each piece is cut on the host, so no rank holds the whole tree on its
    device."""
    device = resolve_device(device)
    if mesh is None or "model" not in mesh.axis_names:
        return _tree(tree, device=device)
    from repro_torch.models.tensor_parallel import TensorParallel
    def _to(t):
        return ({k: _to(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(device))

    return _to(TensorParallel(cfg, mesh).shard_params(_tree(tree)))


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
                         stacked_lora=None, client_lora=None) -> None:
    """Start a port ``FederatedTrainer`` from a reference trainer's state:
    its base weights and server adapters (``server.global_lora``,
    ``server.prev_global``), given as numpy trees (``jax.device_get`` of
    the reference trainer's attributes), and its clients' adapters —
    ``stacked_lora`` (``[K, ...]``) for a resident trainer, or for a paged
    one ``client_lora``, a mapping ``{k: tree}`` of per-client initial
    adapters (the reference's ``_init_lora_fn(k)`` as numpy), written into
    the store's host tier through ``write_client`` (no ``[K, ...]`` stack
    is built; clients left out keep the port's own lazy init).  The
    reference's init draws come from ``jax.random``, which torch cannot
    reproduce; everything after the init is the port's own.  On a mesh
    every rank calls this with the same trees and keeps its own pieces of
    the base weights."""
    if trainer.store is None and (stacked_lora is None
                                  or client_lora is not None):
        raise ValueError("a resident trainer takes stacked_lora")
    if trainer.store is not None and stacked_lora is not None:
        raise ValueError("a paged trainer takes client_lora (per client), "
                         "never a [K, ...] stack")
    dev = trainer.device
    trainer.set_base_params(params_from_numpy(trainer.mcfg, base_params,
                                              device=dev, mesh=trainer.mesh),
                            split=True)
    trainer.server.global_lora = lora_from_numpy(global_lora, device=dev)
    trainer.server.prev_global = lora_from_numpy(prev_global, device=dev)
    if trainer.store is None:
        trainer.stacked_lora = lora_from_numpy(stacked_lora, device=dev)
    else:
        for k, tree in (client_lora or {}).items():
            trainer.store.write_client(int(k), tree)


def flora_reinit_from_numpy(clients: dict, globals_: dict, *, device=None):
    """FLoRA's draws in the form of the trainer's ``flora_reinit`` seam,
    from numpy trees (e.g. the reference's ``init_lora_params(
    PRNGKey(1000 * round + k), ...)`` and ``init_lora_params(PRNGKey(round
    + 77), ...)`` through ``jax.device_get``): ``clients[(round, k)]`` and
    ``globals_[round]``.  Assign the result to ``trainer.flora_reinit``."""
    device = resolve_device(device)

    def flora_reinit(round_idx: int, sampled: list[int]):
        trees = [clients[(round_idx, int(k))] for k in sampled]
        lora0 = {n: {m: to_torch(np.stack([t[n][m] for t in trees]),
                                 device=device) for m in ("A", "B")}
                 for n in trees[0]}
        return lora0, lora_from_numpy(globals_[round_idx], device=device)

    return flora_reinit


__all__ = ["adapters_from_numpy", "flora_reinit_from_numpy",
           "load_reference_state", "lora_from_numpy", "params_from_numpy",
           "to_torch"]
