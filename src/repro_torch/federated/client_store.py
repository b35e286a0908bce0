"""Host-backed client-state store (port of
``repro/federated/client_store.py``): the whole federated population
lives on the host (adapters, ranks, sizes, corpus shards — optionally
spilled to disk), and the device holds a cohort-sized bank of ``slots``
rows.

Like ``repro_torch.serving.AdapterStore`` it places rows through
``repro_torch.core.paging.LRUPager``, but the bank is read-write: a round
trains its cohort's rows in place, so an eviction writes back.

* :meth:`acquire_cohort` maps a sampled cohort to bank slots: resident
  clients are touched and pinned; a cold client takes a slot (evicting the
  least recently used unpinned resident, whose dirty row is captured
  first), is materialised through ``init_fn`` on its first use ever (the
  resident trainer's own per-client init, so paged state is bit-identical)
  and is paged in.  A page-in is one host stack of the cold rows per leaf,
  one host-to-device copy per leaf and one ``index_copy_`` per leaf into
  the bank, all on the round's stream; rows still on the device (a fresh
  init, an unflushed capture) are copied device to device.
* Nothing waits for the device.  An eviction capture is a device-side COPY
  of the bank row (``clone``, never a view: the next page-in overwrites
  the slot in place) and reaches numpy only at :meth:`flush`.  A
  ``non_blocking`` copy from pinned host memory keeps its staging buffer
  alive until an event recorded behind the copy has passed.
* :meth:`adopt` rebinds the banks to what the round returned: the port's
  round updates the bank tensors in place and returns those same tensors,
  so the rebind keeps the same objects.  :meth:`mark_trained` marks the
  cohort's rows dirty, so a later eviction or flush writes them back.

The optional cold tier (``host_slots`` + ``spill_dir``) spills the least
recently used host adapters to per-client npz files through
``repro_torch.checkpoint.io.save_pytree``.  Corpus shards and the ``[K]``
rank and size vectors stay in RAM (the sampler reads them).
"""

from __future__ import annotations

import collections
import os
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.checkpoint.io import load_pytree, save_pytree, to_numpy
from repro_torch.core.paging import LRUPager
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.telemetry import Telemetry

Tree = Any


def pad_rows(x: np.ndarray, n_max: int) -> np.ndarray:
    """Zero-pad a shard's example axis to ``n_max``, as the resident
    trainer pads its stacked corpus (batch indices never reach the
    padding)."""
    x = np.asarray(x)
    if x.shape[0] < n_max:
        x = np.pad(x, [(0, n_max - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
    return x


def _on_device(tree: Tree) -> bool:
    return isinstance(tree_leaves(tree)[0], torch.Tensor)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


class ClientStateStore:
    """LRU-paged device bank of per-client federated state.

    ``ranks`` / ``sizes`` are the trainer's host ``[K]`` vectors, shared
    (the trainer's fetches keep them current).  ``data`` is the per-client
    list of host shard dicts and ``batch_keys`` the keys that ride the
    round.  ``init_fn(k)`` returns client ``k``'s initial adapter as
    tensors on ``device``.
    """

    def __init__(self, *, num_clients: int, slots: int,
                 init_fn: Callable[[int], Tree],
                 ranks: np.ndarray, sizes: np.ndarray,
                 data: list[dict], batch_keys: list[str], device,
                 dispatch_count: collections.Counter | None = None,
                 host_slots: int | None = None,
                 spill_dir: str | None = None,
                 telemetry: Telemetry | None = None):
        if host_slots is not None and spill_dir is None:
            raise ValueError("host_slots needs spill_dir (a cold tier to "
                             "spill cold host adapters into)")
        self.num_clients = num_clients
        self.device = torch.device(device)
        self.pager = LRUPager(slots, kind="client")
        self.init_fn = init_fn
        self.ranks = ranks                       # host [K] int32, shared
        self.sizes = sizes                       # host [K] f32, shared
        self.data = data
        self.batch_keys = list(batch_keys)
        self.n_max = int(max(d["tokens"].shape[0] for d in data))
        self.host_slots = host_slots
        self.spill_dir = spill_dir
        self.dispatch_count = (collections.Counter()
                               if dispatch_count is None else dispatch_count)
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry(enabled=False))
        m = self.telemetry.metrics
        for key in ("hits", "misses", "evictions", "spills", "hit_rate"):
            m.gauge_fn(f"fed.clients.pager_{key}",
                       lambda k=key: float(self.paging_stats[k]))
        # device banks, built from the first materialised adapter
        self.lora_bank: Tree | None = None       # {spec: {A, B}} [S, ...]
        self.ranks_bank: torch.Tensor | None = None   # [S] int32
        self.sizes_bank: torch.Tensor | None = None   # [S] f32
        self.data_bank: dict | None = None       # {key: [S, n_max, ...]}
        # host tier: id -> adapter tree, numpy, or tensors on the device
        # (a fresh init or an eviction capture not flushed yet)
        self._host_lora: dict[int, Tree] = {}
        self._pending_rank: dict[int, torch.Tensor] = {}   # of captures
        self._dirty: set[int] = set()            # bank rows newer than host
        self._host_lru: dict[int, int] = {}
        self._host_tick = 0
        self._spilled: set[int] = set()
        self._staging: list[tuple] = []          # (event, pinned buffers)
        self.loads = 0
        self.spills = 0
        self.spill_loads = 0
        self.peak_resident = 0

    # --------------------------------------------------------------- queries
    @property
    def slots(self) -> int:
        return self.pager.slots

    @property
    def evictions(self) -> int:
        return self.pager.evictions

    @property
    def paging_stats(self) -> dict:
        """Hits, misses, evictions and spills (``AdapterStore``'s schema)."""
        return dict(self.pager.stats(), spills=self.spills)

    @property
    def resident_ids(self) -> list[int]:
        return self.pager.resident_ids

    @property
    def pinned_ids(self) -> list[int]:
        """Clients pinned by an in-flight cohort."""
        return sorted(k for k, v in self.pager.pins.items() if v > 0)

    @property
    def materialized_ids(self) -> list[int]:
        """Clients whose adapter has ever been realised (every other one is
        still its lazy init)."""
        return sorted(set(self._host_lora) | self._spilled | self._dirty)

    def device_bytes(self) -> int:
        banks = [self.lora_bank, self.ranks_bank, self.sizes_bank,
                 self.data_bank]
        return sum(_nbytes(x) for b in banks if b is not None
                   for x in tree_leaves(b))

    def host_bytes(self) -> int:
        """Host-tier bytes: materialised adapters plus corpus shards (a
        shard shared between clients counted once, by identity)."""
        n = sum(_nbytes(x) for t in self._host_lora.values()
                for x in tree_leaves(t))
        seen: set[int] = set()
        for d in self.data:
            for v in d.values():
                if id(v) not in seen:
                    seen.add(id(v))
                    n += np.asarray(v).nbytes
        return n

    # ------------------------------------------------------------- host tier
    def _host_touch(self, k: int) -> None:
        self._host_tick += 1
        self._host_lru[k] = self._host_tick

    def _host_set(self, k: int, tree: Tree) -> None:
        self._host_lora[k] = tree
        self._host_touch(k)
        if self.host_slots is None:
            return
        while len(self._host_lora) > self.host_slots:
            # spill the coldest host adapter; a resident one keeps its
            # bank row, so spilling it is safe
            victim = min(self._host_lru, key=self._host_lru.get)
            if victim == k and len(self._host_lora) == 1:
                break
            self._spill(victim)

    def _spill(self, k: int) -> None:
        with self.telemetry.span("spill", cat="paging", client=k):
            tree = self._flush_entry(k)
            os.makedirs(self.spill_dir, exist_ok=True)
            save_pytree(os.path.join(self.spill_dir, f"client_{k}.npz"),
                        tree)
            self._spilled.add(k)
            del self._host_lora[k]
            del self._host_lru[k]
            self.spills += 1

    def _flush_entry(self, k: int) -> Tree:
        """A host entry as numpy (a device entry waits for the device
        here: the lazy half of the eviction write-back)."""
        tree = self._host_lora[k]
        if _on_device(tree):
            tree = tree_map(to_numpy, tree)
            self._host_lora[k] = tree
        if k in self._pending_rank:
            self.ranks[k] = int(self._pending_rank.pop(k))
        return tree

    def _entry(self, k: int) -> Tree:
        """Client ``k``'s host-tier entry, materialising it lazily or
        loading it from the spill tier; device entries stay on the
        device."""
        if k in self._host_lora:
            self._host_touch(k)
            return self._host_lora[k]
        if k in self._spilled:
            tree = load_pytree(os.path.join(self.spill_dir,
                                            f"client_{k}.npz"))
            self._spilled.discard(k)
            self.spill_loads += 1
        else:
            tree = self.init_fn(k)
        self._host_set(k, tree)
        return tree

    def host_adapter(self, k: int) -> Tree:
        """Client ``k``'s host adapter as numpy (materialised lazily or
        loaded from the spill tier).  Not the latest state of a resident
        dirty row: :meth:`client_lora`, or :meth:`flush` first, gives
        that."""
        self._entry(k)
        return self._flush_entry(k)

    # ----------------------------------------------------------- device bank
    def _build_banks(self, proto: Tree) -> None:
        S, dev = self.slots, self.device

        def zeros(x):
            dtype = (x.dtype if isinstance(x, torch.Tensor) else
                     torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype)
            return torch.zeros((S,) + tuple(x.shape), dtype=dtype,
                               device=dev)

        self.lora_bank = tree_map(zeros, proto)
        self.ranks_bank = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.sizes_bank = torch.zeros((S,), dtype=torch.float32, device=dev)
        d0 = self.data[0]
        self.data_bank = {
            kk: zeros(pad_rows(d0[kk], self.n_max)) for kk in self.batch_keys}

    def _capture(self, k: int, slot: int) -> None:
        """Eviction write-back without waiting: a device copy of the dirty
        bank row, numpy only at :meth:`flush`."""
        with self.telemetry.span("evict_capture", cat="paging", client=k):
            self._host_set(k, tree_map(lambda x: x[slot].clone(),
                                       self.lora_bank))
            self._pending_rank[k] = self.ranks_bank[slot].clone()
            self._dirty.discard(k)

    def acquire_cohort(self, ids: Iterable[int]) -> np.ndarray:
        """Pin the cohort into bank slots; returns its ``[C]`` slots.  Cold
        rows page in together (``page_in`` in ``dispatch_count``); evicted
        dirty rows are captured first."""
        ids = [int(k) for k in ids]
        if len(ids) > self.slots:
            raise ValueError(
                f"cohort of {len(ids)} exceeds the {self.slots}-slot device "
                "bank; grow FederatedConfig.store_slots")
        with self.telemetry.span("acquire_cohort", cat="paging",
                                 cohort=len(ids)):
            slots_out, cold = [], []
            for k in ids:
                slot = self.pager.lookup(k)
                if slot is None:
                    if self.lora_bank is None:
                        self._build_banks(self._entry(k))
                    slot, evicted = self.pager.assign(k)
                    if evicted is not None and (
                            evicted in self._dirty
                            or (evicted not in self._host_lora
                                and evicted not in self._spilled)):
                        self._capture(evicted, slot)
                    cold.append((k, slot))
                else:
                    self.pager.hit(k)
                self.pager.pin(k)
                slots_out.append(slot)
            if cold:
                self._page_in(cold)
            self.peak_resident = max(self.peak_resident,
                                     len(self.pager.slot_of))
        return np.asarray(slots_out, np.int32)

    def _h2d(self, arr: np.ndarray, keep: list) -> torch.Tensor:
        """One host array onto the device without waiting: from pinned
        memory on CUDA (the staging buffer joins ``keep``)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        t = t.pin_memory()
        keep.append(t)
        return t.to(self.device, non_blocking=True)

    def _page_in(self, cold: list[tuple[int, int]]) -> None:
        # the span name is the dispatch-count key, as for the round calls
        with self.telemetry.span("page_in", cat="dispatch", rows=len(cold)):
            self._page_in_body(cold)

    def _page_in_body(self, cold: list[tuple[int, int]]) -> None:
        # staging buffers of earlier page-ins whose copies have finished
        self._staging = [(ev, b) for ev, b in self._staging
                         if not ev.query()]
        keep: list = []
        ks = [k for k, _ in cold]
        entries = [self._entry(k) for k in ks]
        slots = np.asarray([s for _, s in cold], np.int64)
        # the cold rows in two groups: numpy rows cross from the host in
        # one copy per leaf, device rows are stacked where they are
        groups = []
        for on_dev in (False, True):
            rows = [i for i, e in enumerate(entries) if _on_device(e) == on_dev]
            if rows:
                groups.append((rows, on_dev, self._h2d(slots[rows], keep)))
        for name, entry in self.lora_bank.items():
            for m, bank in entry.items():
                for rows, on_dev, at in groups:
                    if on_dev:
                        x = torch.stack([entries[i][name][m] for i in rows])
                    else:
                        x = self._h2d(np.stack(
                            [entries[i][name][m] for i in rows]), keep)
                    bank.index_copy_(0, at, x)
        all_at = self._h2d(slots, keep)
        ranks = self._h2d(np.asarray([int(self.ranks[k]) for k in ks],
                                     np.int32), keep)
        pend = [i for i, k in enumerate(ks) if k in self._pending_rank]
        if pend:       # a captured row's rank is still on the device
            ranks.index_copy_(0, self._h2d(np.asarray(pend, np.int64), keep),
                              torch.stack([self._pending_rank[ks[i]]
                                           for i in pend]))
        self.ranks_bank.index_copy_(0, all_at, ranks)
        self.sizes_bank.index_copy_(0, all_at, self._h2d(np.asarray(
            [float(self.sizes[k]) for k in ks], np.float32), keep))
        for kk, bank in self.data_bank.items():
            bank.index_copy_(0, all_at, self._h2d(np.stack(
                [pad_rows(self.data[k][kk], self.n_max) for k in ks]), keep))
        if keep:
            ev = torch.cuda.Event()
            ev.record()
            self._staging.append((ev, keep))
        self.dispatch_count["page_in"] += 1
        self.loads += len(cold)

    def release_cohort(self, ids: Iterable[int]) -> None:
        for k in ids:
            self.pager.unpin(int(k))

    def mark_trained(self, ids: Iterable[int]) -> None:
        """A round's scatter made these bank rows newer than the host."""
        self._dirty.update(int(k) for k in ids)

    def adopt(self, lora_bank: Tree, ranks_bank: torch.Tensor) -> None:
        """Rebind the banks to a round's outputs (the port's round updates
        them in place and returns the same tensors); sizes and data do not
        change in a round."""
        self.lora_bank = lora_bank
        self.ranks_bank = ranks_bank

    def prefetch(self, ids: Iterable[int]) -> np.ndarray:
        """Page rows in without leaving them pinned (checkpoint restore,
        warm-up)."""
        ids = list(ids)
        slots = self.acquire_cohort(ids)
        self.release_cohort(ids)
        return slots

    # ------------------------------------------------------------- state I/O
    def client_lora(self, k: int) -> Tree:
        """Client ``k``'s current adapter as device tensors (a copy of its
        bank row when resident and dirty, else from the host tier)."""
        k = int(k)
        slot = self.pager.lookup(k)
        if slot is not None and k in self._dirty:
            return tree_map(lambda x: x[slot].clone(), self.lora_bank)
        return tree_map(lambda x: torch.as_tensor(x).to(self.device,
                                                        copy=True),
                        self._entry(k))

    def write_client(self, k: int, lora: Tree,
                     rank: int | None = None) -> None:
        """Overwrite client ``k``'s state from the host side (the reference
        loop, checkpoint restore, interop); a resident copy is dropped, so
        the next acquire pages the new state in."""
        k = int(k)
        if self.pager.pinned(k):
            raise RuntimeError(
                f"client {k} is pinned by an in-flight cohort; retire it "
                "before overwriting its state")
        if self.pager.lookup(k) is not None:
            self.pager.drop(k)
        self._dirty.discard(k)
        self._pending_rank.pop(k, None)
        self._spilled.discard(k)
        self._host_set(k, tree_map(lambda x: np.array(to_numpy(x)), lora))
        if rank is not None:
            self.ranks[k] = int(rank)

    def flush(self) -> None:
        """Bring the host tier up to date: capture every dirty resident row
        (the rows stay resident and become clean) and copy every device
        entry to numpy.  Afterwards ``host_adapter(k)`` is current for
        every materialised client."""
        with self.telemetry.span("store_flush", cat="paging",
                                 dirty=len(self._dirty)):
            for k in sorted(self._dirty):
                slot = self.pager.lookup(k)
                self._host_set(k, tree_map(lambda x: x[slot].clone(),
                                           self.lora_bank))
                self._pending_rank[k] = self.ranks_bank[slot].clone()
            self._dirty.clear()
            for k in list(self._host_lora):
                self._flush_entry(k)

    def invalidate(self) -> None:
        """Forget all residency and materialised host state (a checkpoint
        loaded into a used trainer).  Pins must be drained first."""
        if self.pinned_ids:
            raise RuntimeError("cannot invalidate a store with pinned rows")
        for k in list(self.pager.slot_of):
            self.pager.drop(k)
        self._host_lora.clear()
        self._host_lru.clear()
        self._pending_rank.clear()
        self._dirty.clear()
        self._spilled.clear()

    def stack_clients(self, ids: Iterable[int]) -> Tree:
        """A tile of current client adapters stacked on the device
        ``[T, ...]`` (the tiled population eval); flushes first."""
        self.flush()
        trees = [self.host_adapter(int(k)) for k in ids]
        return {n: {m: torch.from_numpy(np.stack(
            [t[n][m] for t in trees])).to(self.device) for m in ("A", "B")}
            for n in trees[0]}


__all__ = ["ClientStateStore", "pad_rows"]
