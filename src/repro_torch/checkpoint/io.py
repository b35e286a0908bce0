"""Checkpointing (port of ``repro/checkpoint/io.py``): flat-key npz files of
adapter and parameter trees, and the federated trainer's whole state.

The format is the reference's, so a checkpoint written by either package
loads into the other:

* a tree is one ``.npz`` whose keys are its dict paths joined by ``"/"``;
* ``save_federated`` writes ``global_lora.npz``, ``prev_global.npz``, one
  ``client_<k>.npz`` per client (a paged trainer: per MATERIALISED client)
  and ``meta.json`` with ``round``, ``ranks``, ``aggregator``,
  ``global_version``, ``async_tick``, ``health``, the numpy generator
  states ``rng_state`` / ``client_rng_state`` and, for a paged trainer,
  ``paged`` / ``materialized`` / ``resident`` (the resident set, coldest
  first); the buffered-async timeline's cohorts are written once each
  (``async_cohort_<i>.npz``) and its in-flight and buffered entries point
  at them; FLoRA's trainer also writes ``base_params.npz``.

Leaves must be types numpy holds: the trainers run in f32.  A bf16 leaf is
an error that names its key, never a silent cast.  numpy's PCG64 states
are plain integers in JSON, so a resumed run draws the same cohorts,
minibatches and fault draws as the uninterrupted one.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any

import numpy as np
import torch

Tree = Any
_SEP = "/"
# torch dtypes numpy has no type for
_NO_NUMPY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def to_numpy(x, key: str = "") -> np.ndarray:
    """One leaf → a numpy array (a tensor is copied to the host); raises
    ``TypeError`` naming ``key`` for a type numpy cannot hold."""
    if isinstance(x, torch.Tensor):
        if x.dtype in _NO_NUMPY:
            raise TypeError(
                f"checkpoint leaf {key!r} is {x.dtype}, which numpy cannot "
                "hold; cast it explicitly (the trainers run in float32)")
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype == object or a.dtype.name == "bfloat16":
        raise TypeError(f"checkpoint leaf {key!r} has dtype {a.dtype}, "
                        "which the npz format does not hold")
    return a


def _flatten(tree: Tree, prefix: str = "") -> dict:
    """``{"a/b": array}`` over a nested dict (lists and tuples by index)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        key = prefix.rstrip(_SEP)
        out[key] = to_numpy(tree, key)
    return out


def save_pytree(path: str, tree: Tree) -> None:
    """Write ``tree`` (tensors or arrays) as one flat-key npz file."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str) -> dict[str, Any]:
    """Nested dict of numpy arrays from a ``save_pytree`` npz file."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = root
            parts = key.split(_SEP)
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = data[key]
    return root


def _to_device(tree: Tree, device) -> Tree:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _trainer_span(trainer, name: str):
    tel = getattr(trainer, "telemetry", None)
    if tel is None:
        return contextlib.nullcontext()
    return tel.span(name, cat="io")


def save_federated(dirpath: str, trainer) -> None:
    """Write ``trainer``'s state to ``dirpath`` (``checkpoint_save`` span
    on its telemetry); see :func:`_save_federated_impl`."""
    with _trainer_span(trainer, "checkpoint_save"):
        _save_federated_impl(dirpath, trainer)


def _save_federated_impl(dirpath: str, trainer) -> None:
    """Server and client state of a ``FederatedTrainer``, under every round
    driver: a pending pipelined round is drained first, the buffered-async
    timeline's in-flight and buffered entries are written with their
    cohorts (each once), and the cumulative health counters and numpy
    generator states ride the meta, so a mid-fault-sequence resume replays
    the same timeline.  A paged trainer with pinned rows (an in-flight
    cohort) raises ``ValueError``: its updated adapters are still bank
    rows of a cohort that has not retired."""
    if trainer._pending is not None:
        trainer.flush_rounds()
    store = trainer.store
    if store is not None and store.pinned_ids:
        raise ValueError("client store has pinned rows (an in-flight "
                         "cohort); retire it before checkpointing")
    os.makedirs(dirpath, exist_ok=True)
    save_pytree(os.path.join(dirpath, "global_lora.npz"),
                trainer.server.global_lora)
    save_pytree(os.path.join(dirpath, "prev_global.npz"),
                trainer.server.prev_global)
    if store is not None:
        # captured and dirty rows land on the host first; only
        # materialised clients are written (every other client is still
        # its lazy init, which the loader rebuilds)
        store.flush()
    meta = {"round": trainer.server.round,
            "ranks": [int(r) for r in trainer.client_ranks],
            "aggregator": trainer.fcfg.aggregator,
            "global_version": trainer._global_version,
            "async_tick": trainer._async_tick}
    if store is not None:
        mat = [int(k) for k in store.materialized_ids]
        for k in mat:
            save_pytree(os.path.join(dirpath, f"client_{k}.npz"),
                        store.host_adapter(k))
        meta["paged"] = True
        meta["materialized"] = mat
        # coldest first: prefetching them in this order restores both the
        # resident set and its eviction order
        meta["resident"] = [int(k) for k in sorted(
            store.pager.slot_of, key=lambda i: store.pager.lru[i])]
    else:
        host = {n: {m: to_numpy(e[m], f"{n}/{m}") for m in ("A", "B")}
                for n, e in trainer.stacked_lora.items()}
        for k in range(len(trainer.clients)):
            save_pytree(os.path.join(dirpath, f"client_{k}.npz"),
                        {n: {m: e[m][k] for m in ("A", "B")}
                         for n, e in host.items()})
    entries = list(trainer._inflight) + list(trainer._buffer)
    if entries:
        cohorts, cix = [], {}
        for e in entries:
            if id(e["cohort"]) not in cix:
                cix[id(e["cohort"])] = len(cohorts)
                cohorts.append(e["cohort"])
        for i, c in enumerate(cohorts):
            save_pytree(os.path.join(dirpath, f"async_cohort_{i}.npz"), c)

        def _ent(e):
            return {"client": int(e["client"]), "row": int(e["row"]),
                    "cohort": cix[id(e["cohort"])],
                    "version": int(e["version"]), "finish": int(e["finish"])}

        meta["async_cohorts"] = len(cohorts)
        meta["async_inflight"] = [_ent(e) for e in trainer._inflight]
        meta["async_buffer"] = [_ent(e) for e in trainer._buffer]
    if trainer.health:
        meta["health"] = {k: float(v) for k, v in trainer.health.items()}
    meta["rng_state"] = trainer.rng.bit_generator.state
    meta["client_rng_state"] = [c.rng.bit_generator.state
                                for c in trainer.clients]
    if trainer.fcfg.aggregator == "flora":
        save_pytree(os.path.join(dirpath, "base_params.npz"),
                    trainer.base_params_whole())
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_federated(dirpath: str, trainer) -> None:
    """Restore a ``save_federated`` directory (written by either package)
    into ``trainer`` (``checkpoint_load`` span); see
    :func:`_load_federated_impl`."""
    with _trainer_span(trainer, "checkpoint_load"):
        _load_federated_impl(dirpath, trainer)


def _load_federated_impl(dirpath: str, trainer) -> None:
    """Checkpoint layout and trainer mode cross freely: a paged checkpoint
    holds only its materialised clients, and every other client is rebuilt
    from the loading trainer's own ``_init_lora_fn`` (across packages that
    init is not the writer's: those clients were never trained, and
    compare equal only when the init is injected)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    dev = trainer.device
    trainer.server.global_lora = _to_device(
        load_pytree(os.path.join(dirpath, "global_lora.npz")), dev)
    trainer.server.prev_global = _to_device(
        load_pytree(os.path.join(dirpath, "prev_global.npz")), dev)
    trainer.server.round = meta["round"]
    K = len(trainer.clients)
    mat = set(int(k) for k in meta.get("materialized", range(K)))

    def _client_lora(k):
        if k in mat:
            return _to_device(load_pytree(
                os.path.join(dirpath, f"client_{k}.npz")), dev)
        return trainer._init_lora_fn(k)

    store = trainer.store
    if store is not None:
        # drop residency and host state, rebuild the host tier from the
        # checkpoint, then replay the saved LRU order
        store.invalidate()
        trainer.client_ranks[:] = np.asarray(meta["ranks"], np.int32)
        for k in sorted(mat):
            store.write_client(k, _client_lora(k), rank=int(meta["ranks"][k]))
        resident = [int(k) for k in meta.get("resident", [])]
        for k in resident[-store.slots:]:
            store.prefetch([k])
    else:
        from repro_torch.launch.fedround import stack_trees

        trainer.stacked_lora = stack_trees([_client_lora(k)
                                            for k in range(K)])
        trainer.client_ranks = np.asarray(meta["ranks"], np.int32)
        trainer._ranks_dev = torch.tensor(trainer.client_ranks, device=dev)
    base = os.path.join(dirpath, "base_params.npz")
    if os.path.exists(base):                     # FLoRA's folded base weights
        trainer.set_base_params(_to_device(load_pytree(base), dev))
    trainer._global_version = meta.get("global_version", 0)
    trainer._async_tick = meta.get("async_tick", 0)
    trainer._pending = None
    cohorts = [_to_device(load_pytree(
        os.path.join(dirpath, f"async_cohort_{i}.npz")), dev)
        for i in range(int(meta.get("async_cohorts", 0)))]

    def _entry(e):
        return {"client": int(e["client"]), "row": int(e["row"]),
                "cohort": cohorts[int(e["cohort"])],
                "version": int(e["version"]), "finish": int(e["finish"])}

    trainer._inflight = [_entry(e) for e in meta.get("async_inflight", [])]
    trainer._buffer = [_entry(e) for e in meta.get("async_buffer", [])]
    # in place: the telemetry registry holds this Counter
    trainer.health.clear()
    trainer.health.update(meta.get("health", {}))
    if "rng_state" in meta:
        trainer.rng.bit_generator.state = meta["rng_state"]
    for c, st in zip(trainer.clients, meta.get("client_rng_state", [])):
        c.rng.bit_generator.state = st


__all__ = ["load_federated", "load_pytree", "save_federated", "save_pytree",
           "to_numpy"]
