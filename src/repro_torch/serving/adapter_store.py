"""Multi-tenant adapter residency (port of
``repro/serving/adapter_store.py``): host master copies of every registered
adapter, zero-rank-padded to the bank's shared rank, and a fixed-size
device bank holding the hot set, with LRU paging of cold adapters.

The bank is kept scan-major, ``{spec: {"A": [L, slots, r, in], "B": [L,
slots, out, r]}}`` — the layout the decode loop indexes per layer — and a
page-in writes the adapter's rows into it in place.  (The reference keeps a
slot-major stack and a transposed scan-major copy refreshed on page-in;
here the scan-major bank is the only one.)

* :meth:`register` adds/overwrites a tenant's adapter on host (cold);
* :meth:`acquire` pins an adapter into a bank slot, paging it in when cold
  and evicting the least-recently-used unpinned resident when the bank is
  full (nothing is copied out: serving is read-only);
* :meth:`release` unpins; the adapter stays hot until evicted.

On a serving mesh (``mesh=``, or :meth:`set_mesh`, which a
``ServingEngine`` calls with its tensor-parallel split) every rank keeps
the same host copies and pager, so every rank pages the same adapters
into the same slots.  With a ``"model"`` axis a rank's ``B`` bank holds
only its own contiguous columns at the column-parallel sites (the BGMV
kernel takes no views).  The slot axis is not split over ``"data"``, as
the reference splits it when the slots divide (its ``_bank_sharding``):
an engine's slot rows on one rank may read any bank slot, so a split
bank would have to be gathered for every decode step.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Hashable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.paging import LRUPager
from repro_torch.launch.mesh import Mesh
from repro_torch.telemetry import Telemetry

Tree = Any


class AdapterQuarantinedError(RuntimeError):
    """Raised by :meth:`AdapterStore.acquire` / ``ServingEngine.submit`` for
    an adapter that failed page-in validation (non-finite or
    shape-mismatched tensors)."""


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _pad_rank(entry: dict, r_pad: int) -> dict:
    """Zero-pad one {"A": [L, r, in], "B": [L, out, r]} pair to rank r_pad."""
    a, b = _host_tensor(entry["A"]), _host_tensor(entry["B"])
    r = a.shape[1]
    if r > r_pad:
        raise ValueError(f"adapter rank {r} exceeds store rank {r_pad}")
    if r < r_pad:
        a = F.pad(a, (0, 0, 0, r_pad - r))
        b = F.pad(b, (0, r_pad - r))
    return {"A": a.contiguous(), "B": b.contiguous()}


class AdapterStore:
    """LRU-paged device bank of per-tenant LoRA adapters.

    ``slots``: hot-set size.  ``rank``: the bank's padded rank r_g.
    ``device``: where the bank lives (``None`` = CUDA; raises without one;
    on a mesh, the mesh's device).  The bank keeps the registered
    adapters' dtype.  ``dispatch_count`` tallies ``adapter_load`` page-ins
    (shared with a ServingEngine's counter).  ``mesh``: a serving mesh
    (module docstring)."""

    def __init__(self, *, slots: int, rank: int, device=None,
                 dispatch_count: collections.Counter | None = None,
                 mesh=None, telemetry: Telemetry | None = None):
        self.device = resolve_device(device)
        self.mesh = None
        self._tp = None                            # the split B columns
        self.slots = slots
        self.rank = rank
        self._host: dict[Hashable, Tree] = {}      # id -> padded CPU tree
        self.ranks: dict[Hashable, int] = {}       # id -> true rank
        self.quarantined: dict[Hashable, str] = {}
        self.health: collections.Counter = collections.Counter()
        self._pager = LRUPager(slots, kind="adapter")  # raises on slots < 1
        self._bank: Tree | None = None             # device [L, S, ...] bank
        self.loads = 0
        self.dispatch_count = (collections.Counter()
                               if dispatch_count is None else dispatch_count)
        self.telemetry = Telemetry(enabled=False)
        if telemetry is not None:
            self.use_telemetry(telemetry)
        if mesh is not None:
            self.set_mesh(mesh)

    def set_mesh(self, mesh, tp=None) -> None:
        """Adopt a serving mesh and, with ``tp`` (the
        ``TensorParallel`` of the model the bank serves), its split of the
        ``B`` columns; a bank already built is rebuilt under them from the
        host copies of its residents."""
        if not isinstance(mesh, Mesh):
            raise TypeError(f"a serving mesh is a repro_torch.launch.mesh."
                            f"Mesh, got {type(mesh).__name__}")
        if self.device.type != mesh.device.type:
            raise ValueError(f"the store's device {self.device} is not the "
                             f"mesh's ({mesh.device})")
        self.mesh, self._tp, self.device = mesh, tp, mesh.device
        if self._bank is not None:
            self._bank = None
            bank = self.scan_stack
            for aid in self.resident_ids:
                self._write(bank, self._pager.lookup(aid), self._host[aid])

    def _cut(self, name: str, part: str, x: torch.Tensor) -> torch.Tensor:
        """A host leaf ``[L, ...]`` as this rank's bank holds it."""
        if self._tp is None or part != "B":
            return x
        return self._tp.bank_b(name, x)

    def _write(self, bank, slot: int, host: Tree) -> None:
        for name, entry in bank.items():
            for p, dst in entry.items():
                dst[:, slot].copy_(self._cut(name, p, host[name][p]))

    def use_telemetry(self, telemetry: Telemetry) -> None:
        """Adopt a telemetry bundle (an engine sharing its own calls this
        so one registry sees both engine and store metrics)."""
        self.telemetry = telemetry
        m = telemetry.metrics
        for key in ("hits", "misses", "evictions", "spills", "hit_rate"):
            m.gauge_fn(f"serving.adapters.pager_{key}",
                       lambda k=key: float(self.paging_stats[k]))
        m.counter_group("serving.adapter_health", self.health)
        m.gauge_fn("serving.adapters.quarantined",
                   lambda: float(len(self.quarantined)))

    @property
    def paging_stats(self) -> dict:
        """Pager hit/miss/eviction accounting (read-only bank: spills == 0)."""
        return dict(self._pager.stats(), spills=0)

    @property
    def evictions(self) -> int:
        return self._pager.evictions

    # ------------------------------------------------------------- registry
    def _validate(self, padded: Tree) -> str | None:
        """Page-in validation: a quarantine reason, or ``None``."""
        for name, entry in padded.items():
            for part in ("A", "B"):
                if not torch.isfinite(entry[part]).all():
                    self.health["quarantined_nonfinite"] += 1
                    return (f"non-finite values in {name}/{part} "
                            "(NaN/Inf adapter tensor)")
        if self._host:
            proto = next(iter(self._host.values()))
            for name, entry in padded.items():
                for part in ("A", "B"):
                    if entry[part].shape != proto[name][part].shape:
                        self.health["quarantined_shape"] += 1
                        return (f"shape mismatch in {name}/{part}: "
                                f"{tuple(entry[part].shape)} vs bank "
                                f"{tuple(proto[name][part].shape)}")
        return None

    def register(self, adapter_id: Hashable, lora: Tree, rank: int,
                 *, validate: bool = True) -> None:
        """Add (or overwrite) a tenant's adapter on host.  ``lora`` is a
        ``{spec: {"A", "B"}}`` tree (numpy arrays or tensors) at any rank ≤
        the bank rank; ``rank`` is the tenant's true rank.  With
        ``validate`` (the default) non-finite or shape-mismatched tensors
        quarantine the id instead; a later clean register clears it."""
        padded = {name: _pad_rank(entry, self.rank)
                  for name, entry in lora.items()}
        if self._host and set(padded) != set(next(iter(self._host.values()))):
            raise ValueError("adapter spec names differ from registered ones")
        if self._pager.pinned(adapter_id):
            raise RuntimeError(
                f"adapter {adapter_id!r} is pinned by in-flight requests; "
                "overwriting it would swap weights under them — drain those "
                "requests first")
        if validate:
            reason = self._validate(padded)
            if reason is not None:
                if self._pager.lookup(adapter_id) is not None:
                    self._pager.drop(adapter_id)
                self._host.pop(adapter_id, None)
                self.ranks.pop(adapter_id, None)
                self.quarantined[adapter_id] = reason
                return
        if self._pager.lookup(adapter_id) is not None:  # overwrite hot copy
            self._pager.drop(adapter_id)
        self.quarantined.pop(adapter_id, None)
        self._host[adapter_id] = padded
        self.ranks[adapter_id] = int(rank)

    def __contains__(self, adapter_id: Hashable) -> bool:
        return adapter_id in self._host or adapter_id in self.quarantined

    def __len__(self) -> int:
        return len(self._host)

    @property
    def resident_ids(self) -> list[Hashable]:
        """The adapters in the bank, in slot order."""
        return self._pager.resident_ids

    @property
    def stack(self) -> Tree:
        """The bank slot-major, ``{spec: {"A": [slots, L, r, in], "B":
        [slots, L, out, r]}}``: a view of :attr:`scan_stack` (the
        reference's ``stack``; block-stacked ``s*`` specs only)."""
        return {name: {p: x.transpose(0, 1) for p, x in entry.items()}
                for name, entry in self.scan_stack.items()}

    @property
    def scan_stack(self) -> Tree:
        """The device bank, scan-major ``{spec: {"A": [L, slots, r, in],
        "B": [L, slots, out, r]}}`` (block-stacked ``s*`` specs only),
        built zeroed on first use."""
        if self._bank is None:
            if not self._host:
                raise RuntimeError("no adapters registered")
            proto = next(iter(self._host.values()))
            self._bank = {
                name: {p: torch.zeros(
                    (x.shape[0], self.slots) + tuple(x.shape[1:]),
                    dtype=x.dtype, device=self.device)
                    for p, x in ((p, self._cut(name, p, x))
                                 for p, x in entry.items())}
                for name, entry in proto.items() if name.startswith("s")}
        return self._bank

    # ------------------------------------------------------------ residency
    def acquire(self, adapter_id: Hashable) -> int:
        """Pin ``adapter_id`` into the bank; returns its slot.  Pages it in
        (a host→device copy into the slot's rows) when cold.  Raises
        :class:`~repro_torch.core.paging.AllSlotsPinnedError` when every
        slot is pinned; a failed page-in copy propagates and leaves the
        adapter cold."""
        if adapter_id in self.quarantined:
            raise AdapterQuarantinedError(
                f"adapter {adapter_id!r} is quarantined: "
                f"{self.quarantined[adapter_id]} — re-register a clean "
                "adapter to clear")
        if adapter_id not in self._host:
            raise KeyError(f"unknown adapter {adapter_id!r}")
        slot = self._pager.lookup(adapter_id)
        if slot is None:
            bank = self.scan_stack        # allocated before the pager commits
            slot, _ = self._pager.assign(adapter_id)
            with self.telemetry.span("adapter_load", cat="dispatch",
                                     adapter=str(adapter_id)):
                try:
                    self._write(bank, slot, self._host[adapter_id])
                except BaseException:
                    # the slot's rows are not this adapter's: leave the
                    # slot free rather than resident with unwritten rows
                    self._pager.drop(adapter_id)
                    raise
                self.dispatch_count["adapter_load"] += 1
                self.loads += 1
        else:
            self._pager.hit(adapter_id)
        self._pager.pin(adapter_id)
        return slot

    def release(self, adapter_id: Hashable) -> None:
        """Unpin (the adapter stays hot until LRU-evicted)."""
        self._pager.unpin(adapter_id)

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_trainer(cls, trainer, *, slots: int | None = None, device=None,
                     dispatch_count=None, mesh=None,
                     telemetry: Telemetry | None = None) -> "AdapterStore":
        """Register every personalized client adapter of a live
        ``FederatedTrainer`` (ids ``"client0"``, ``"client1"``, ...),
        read through its ``export_adapters`` (a paged trainer's from its
        host tier)."""
        adapters = trainer.export_adapters()
        store = cls(slots=slots or len(adapters), rank=trainer.lcfg.rank,
                    device=device, dispatch_count=dispatch_count, mesh=mesh,
                    telemetry=telemetry)
        for cid, (lora, rank) in adapters.items():
            store.register(cid, lora, rank)
        return store

    @classmethod
    def from_checkpoint(cls, dirpath: str, *, slots: int | None = None,
                        device=None, dispatch_count=None, mesh=None,
                        telemetry: Telemetry | None = None) -> "AdapterStore":
        """Register the per-client adapters (ids ``"client{k}"``) of a
        ``save_federated`` checkpoint directory written by either package;
        a paged checkpoint carries only its materialised clients."""
        from repro_torch.checkpoint import load_pytree

        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        ranks = meta["ranks"]
        ids = [int(k) for k in meta.get("materialized", range(len(ranks)))]
        if not ids:
            raise ValueError(
                f"checkpoint {dirpath} has no materialised client adapters "
                "(paged trainer saved before any round ran)")
        loras = {k: load_pytree(os.path.join(dirpath, f"client_{k}.npz"))
                 for k in ids}
        # bank rank = the arrays' materialised padding, not max(meta ranks):
        # self-pruning can shrink every true rank below it
        r_pad = int(next(iter(loras[ids[0]].values()))["A"].shape[1])
        store = cls(slots=slots or len(ids), rank=r_pad, device=device,
                    dispatch_count=dispatch_count, mesh=mesh,
                    telemetry=telemetry)
        for k in ids:
            store.register(f"client{k}", loras[k], ranks[k])
        return store


__all__ = ["AdapterQuarantinedError", "AdapterStore"]
