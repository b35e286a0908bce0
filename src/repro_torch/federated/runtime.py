"""Federated LoRA training runtime (port of ``repro/federated/runtime.py``:
the trainer over resident or paged client state and its fused round).

One communication round (paper Fig. 3): the server redistributes the
global adapter truncated to each sampled client's rank; each client runs
``local_steps`` adapter-only AdamW steps on its private, possibly
modality-incomplete shard; layer-wise editing repairs the least similar
module against the previous global; the server aggregates through
``repro_torch.core.aggregation.AGGREGATORS``.  Clients keep their edited
adapters (the personalized evaluation target); the aggregate is the global
one.

``run_round`` is one call of the fused round (``launch/fedround.py``) over
persistent stacked device state ``[K, ...]``, followed by the round's one
blocking fetch: losses, edited modules, the fault health values and
post-pruning ranks, packed into one tensor and copied to the host once.
Host randomness is numpy, drawn with the reference's calls in the
reference's order, so cohorts, minibatches and fault draws match it bit
for bit.  ``dispatch_count`` tallies the round and evaluation calls under
the reference's names (``round_step``, ``client_update``,
``buffer_merge``, ``eval_loss``, ``generate``, ``population_eval``).

The reference's other timelines:

* ``run_round_reference`` — the host loop: one local-training call and
  one blocking read per client, eager self-pruning and editing, one
  stack, then aggregation through the registry (the numerical reference
  for the fused round, and the only timeline that measures each client's
  step time for ``measure_delays``);
* ``run_round_pipelined`` / ``flush_rounds`` — builds round t+1's host
  inputs while round t runs on the device, fetches round t's record, then
  enqueues round t+1; the record returned is one round stale (``None`` on
  the first call) and ``run_round`` drains a pending round first.  The
  fetch of round t must precede round t+1's enqueue: the stacked state and
  the ranks are updated in place, so a later fetch would read round t+1's
  ranks into round t's record;
* ``run_round_async`` — buffered asynchronous FL (FedBuff): each tick
  trains a cohort of idle clients against the current global
  (``client_update``), retires cohorts whose simulated delay has elapsed
  into a buffer of per-client updates, and merges every ``M`` buffered
  updates through ``fedbuff`` / ``fedbuff_kernel`` (``buffer_merge``) with
  each update's staleness.

An active ``FederatedConfig.faults`` draws dropouts, stragglers and wire
corruption per (round, client) from ``federated/faults.py``; the fused
round and the async tick absorb them on the device and the round's health
values ride its one fetch (``health`` counts them across rounds).

``FederatedConfig(paged=True)`` replaces the persistent ``[K, ...]``
state with ``federated/client_store.py::ClientStateStore``: the device
holds a cohort-sized bank of client rows (adapters, ranks, sizes, corpus
shards), a cohort pages in by LRU slot with write-back on eviction, and
the same fused round runs over the bank with ``idx`` = bank slots (one
``round_step`` a round, ``page_in`` counted beside it), bit-identical to
the resident trainer because every per-client computation is row-local.
Clients materialise lazily through ``_init_lora_fn`` on first use, so a
population of 10^5 clients costs only the clients it has sampled; the
async tick keeps each in-flight cohort pinned until it retires.

FLoRA (``aggregator="flora"``) folds the cohort's dense delta into the
base weights IN PLACE every round and restarts every client, and the
global adapter, from fresh draws; those draws come through one seam,
:meth:`FederatedTrainer.flora_reinit`, which a parity test replaces with
the reference's ``jax.random`` draws.

``evaluate_personalized(vmapped=False)`` and ``generation_scores(
cached=False)`` are the reference arguments: the per-client host loop,
and the decode that re-runs the full forward for every token.

``mesh=`` (or its alias ``client_mesh=``) runs the trainer on every rank
of a ``repro_torch.launch.mesh.Mesh``: a 1-D mesh splits the sampled
clients over its axis, a 2-D ``(client, "model")`` mesh also runs each
client group's local training tensor-parallel over ``"model"`` (every
family: ``models/tensor_parallel.py``; ``launch/fedround.py``).  Every
rank draws the same cohorts and faults, keeps the same whole client state
and global, and holds the base weights as its tensor-parallel pieces
(whole on a 1-D mesh).  The population evaluation splits the clients
over the client axis when they divide it, and warns and runs every client
on every rank otherwise.  A mesh and the paged store exclude each other.
The trainer runs on the CUDA device unless ``device="cpu"`` is passed
(on a mesh: the mesh's device).
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aggregation as AG
from repro_torch.core.editing import edit_lora
from repro_torch.core.lora import (LoRAConfig, init_lora_params,
                                   mask_lora_params, truncate_redistribute)
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import EOS
from repro_torch.federated.client_store import ClientStateStore, pad_rows
from repro_torch.federated.config import FederatedConfig
from repro_torch.federated.faults import FaultSchedule
from repro_torch.launch.fedround import (_make_local_train,
                                         apply_weight_deltas,
                                         make_buffer_merge_step,
                                         make_client_update_step,
                                         make_round_engine, stack_trees)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import (make_eval_step, make_greedy_generate,
                                      make_population_eval)
from repro_torch.metrics import corpus_scores
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.tensor_parallel import TensorParallel
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding import round_mesh_axes
from repro_torch.telemetry import Telemetry

Tree = Any

# batch keys that ride the training step (anything else stays on the host)
_BATCH_KEYS = ("tokens", "labels", "loss_mask", "image", "image_mask",
               "audio", "text_mask")
# keys an evaluation batch may carry (loss + generation)
_EVAL_KEYS = ("tokens", "labels", "loss_mask", "image", "audio")
# the fused round's health values, in the order they ride the round's fetch
_HEALTH_KEYS = ("n_dropped", "n_forfeited", "n_nonfinite", "clip_rate")
# the fault operand vectors a cohort's draws become on the device
_FAULT_KEYS = ("keep", "weight", "scale", "nan")
# generator streams of FLoRA's fresh draws (``flora_reinit``)
_FLORA_CLIENT_STREAM, _FLORA_GLOBAL_STREAM = 10 ** 9, 2 * 10 ** 9


def _mask_decode_bounds(loss_mask: np.ndarray) -> tuple[int, int]:
    """The shared greedy-decode window (``cap_start``, ``gen_len``) from a
    supervised-position mask that must be uniform across rows."""
    lm = np.asarray(loss_mask) > 0
    if lm.ndim != 2:
        raise ValueError(f"loss_mask must be [rows, seq], got {lm.shape}")
    if not (lm == lm[0]).all():
        bad = int(np.argmax((lm != lm[0]).any(axis=1)))
        raise ValueError(
            "loss_mask is not uniform across rows (first mismatch at row "
            f"{bad}): greedy decode derives one (cap_start, gen_len) window "
            "from row 0 and would mis-decode rows with another span")
    cap_start = int(np.argmax(lm[0]))
    gen_len = int(lm[0].sum())
    if gen_len == 0:
        raise ValueError("loss_mask has no supervised positions: there is "
                         "no caption window to decode")
    return cap_start, gen_len


def _score_generated(gen: np.ndarray, labels: np.ndarray,
                     loss_mask: np.ndarray) -> dict:
    """Token-id generations → Google-BLEU / ROUGE-LSum (EOS-truncated)."""
    hyps, refs = [], []
    for i in range(gen.shape[0]):
        h = np.asarray(gen)[i].tolist()
        r = np.asarray(labels)[i][np.asarray(loss_mask)[i] > 0].tolist()
        h = h[: h.index(EOS)] if EOS in h else h
        hyps.append(h)
        refs.append([x for x in r if x != EOS])
    return corpus_scores(hyps, refs)


@dataclasses.dataclass
class ServerState:
    global_lora: Tree            # padded to r_g
    prev_global: Tree            # A_{g,t-1} for editing (paper Eq. 6)
    round: int = 0


class ClientState:
    """One client's private data, its size and its numpy generator, with
    read-through views of its rank and adapter, which live in the
    trainer's stacked state or its client store."""

    def __init__(self, trainer: "FederatedTrainer", index: int, data: dict,
                 eval_data: dict, size: int, rng: np.random.Generator):
        self._trainer = trainer
        self._index = index
        self.data = data
        self.eval_data = eval_data
        self.size = size
        self.rng = rng

    @property
    def rank(self) -> int:
        return int(self._trainer.client_ranks[self._index])

    @property
    def lora(self) -> Tree:
        """A copy of the client's current adapter, on the device."""
        k, tr = self._index, self._trainer
        if tr.store is not None:
            return tr.store.client_lora(k)
        return tree_map(lambda x: x[k].clone(), tr.stacked_lora)


def _generator(device: torch.device, seed: int, stream: int
               ) -> torch.Generator:
    """A torch generator for one named draw of the trainer's init."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (2 ** 63))


class FederatedTrainer:
    """Federated trainer over resident or paged client state (see the
    module docstring).

    ``base_params``: the frozen base weights as port tensors (``None``:
    ``T.init_params`` from ``seed`` on ``device``).  ``device``: ``None``
    means CUDA and raises without it.  The global and per-client adapters
    start from seeded torch generators; to start from a reference
    trainer's state use ``repro_torch.interop.load_reference_state``.

    ``mesh`` / ``client_mesh`` (one of them): a round mesh (module
    docstring); ``base_params`` are then whole, and the trainer cuts them
    to its rank's pieces at first use."""

    def __init__(self, model_cfg: ModelConfig, fed_cfg: FederatedConfig,
                 opt_cfg: OptimizerConfig, client_train: list[dict],
                 client_eval: list[dict], global_test: dict,
                 base_params: Tree | None = None, seed: int = 0,
                 client_mesh=None, mesh=None,
                 telemetry: Telemetry | None = None, device=None):
        if mesh is not None and client_mesh is not None:
            raise ValueError("pass either mesh= or client_mesh=, not both")
        self.mcfg = model_cfg
        self.fcfg = fed_cfg
        self.ocfg = opt_cfg
        self._round_step = None          # the fused round, built on first use
        self._client_update_step = None
        self._pop_eval_cache: dict = {}
        self._gen_cache: dict = {}
        self._base_tp = None             # the split base_params are cut by
        self.client_mesh = mesh if mesh is not None else client_mesh
        self.device = resolve_device(device)
        if self.client_mesh is not None:
            if self.device.type != self.client_mesh.device.type:
                raise ValueError(f"the trainer's device {self.device} is not "
                                 f"the mesh's ({self.client_mesh.device})")
            self.device = self.client_mesh.device
        self.global_test = global_test
        self.base_params = (base_params if base_params is not None else
                            T.init_params(model_cfg, seed=seed,
                                          device=self.device))
        self.specs = T.lora_specs(model_cfg)
        r_g = fed_cfg.global_rank
        self.lcfg = LoRAConfig(rank=r_g, alpha=fed_cfg.lora_alpha)
        self.lora_scale = fed_cfg.lora_alpha / r_g
        g0 = init_lora_params(self.specs, self.lcfg,
                              generator=_generator(self.device, seed, 1))
        self.server = ServerState(global_lora=g0,
                                  prev_global=tree_map(torch.clone, g0))
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry(enabled=False))
        self.dispatch_count: collections.Counter = \
            self.telemetry.metrics.counter_group("fed.dispatch")
        self.client_ranks = np.asarray(fed_cfg.ranks, np.int32)  # host mirror
        sizes = np.asarray([d["tokens"].shape[0] for d in client_train],
                           np.float32)
        self._seed = seed
        self.clients = [ClientState(self, k, client_train[k], client_eval[k],
                                    int(sizes[k]),
                                    np.random.default_rng(seed + 7 * k + 1))
                        for k in range(fed_cfg.num_clients)]
        keys = [kk for kk in _BATCH_KEYS
                if all(kk in d for d in client_train)]
        partial = [kk for kk in _BATCH_KEYS
                   if kk not in keys and any(kk in d for d in client_train)]
        if partial:
            raise ValueError(
                f"batch keys {partial} present in only some client shards; "
                "the stacked corpus needs uniform keys")
        # client k's initial adapter: one function for the resident stack,
        # the store's lazy materialisation and a checkpoint's clients that
        # were never trained
        self._init_lora_fn = lambda k: init_lora_params(
            self.specs, self.lcfg,
            generator=_generator(self.device, seed, 100 + k),
            client_rank=fed_cfg.ranks[k])
        if fed_cfg.paged:
            # ---- host-backed population, a cohort-sized bank on the device
            slots = fed_cfg.store_slots or self._n_sample
            if slots < self._n_sample:
                raise ValueError(
                    f"store_slots={slots} is smaller than the sampled cohort "
                    f"({self._n_sample}); the bank must hold a whole cohort")
            self.store = ClientStateStore(
                num_clients=fed_cfg.num_clients, slots=slots,
                init_fn=self._init_lora_fn, ranks=self.client_ranks,
                sizes=sizes, data=client_train, batch_keys=keys,
                device=self.device, dispatch_count=self.dispatch_count,
                host_slots=fed_cfg.store_host_slots,
                spill_dir=fed_cfg.store_spill_dir, telemetry=self.telemetry)
            self.stacked_lora = None
            self._stacked_data = None
            self._ranks_dev = None
            self._sizes_dev = None
        else:
            # ---- persistent stacked client state [K, ...] on the device
            self.store = None
            self.stacked_lora = stack_trees(
                [self._init_lora_fn(k) for k in range(fed_cfg.num_clients)])
            self._ranks_dev = torch.tensor(self.client_ranks,
                                           device=self.device)
            self._sizes_dev = torch.tensor(sizes, device=self.device)
            # device-resident training corpus [K, N_max, ...], zero-padded
            # to the longest shard (batch indices never reach the padding);
            # the round gathers its minibatches from it on the device
            n_max = max(d["tokens"].shape[0] for d in client_train)
            self._stacked_data = {
                kk: torch.from_numpy(np.stack(
                    [pad_rows(d[kk], n_max) for d in client_train])).to(
                        self.device)
                for kk in keys}
        self.rng = np.random.default_rng(seed)
        self.history: list[dict] = []
        # pipelined rounds: the enqueued round whose record is not fetched
        self._pending: tuple | None = None
        self._last_slots = None           # bank slots of the last paged cohort
        # buffered async state
        self._merge_step = None
        self._inflight: list[dict] = []   # dispatched updates not retired
        self._buffer: list[dict] = []     # retired updates awaiting a merge
        self._async_tick = 0
        self._global_version = 0          # server merges applied so far
        # measured per-client local-training seconds (EMA), recorded with
        # fcfg.measure_delays; the first measurement of each timed path
        # includes its warm-up and is discarded
        self.client_step_ema = np.zeros((fed_cfg.num_clients,), np.float64)
        self._ema_seen = np.zeros((fed_cfg.num_clients,), bool)
        self._measure_warm: set = set()
        # stateless per-(round, client) fault draws, and the cumulative
        # health counters (n_dropped, n_forfeited, n_deferred, n_corrupted,
        # n_nonfinite, clip_rate_sum, fault_rounds)
        self.fault_schedule = (FaultSchedule(fed_cfg.faults,
                                             fed_cfg.num_clients)
                               if fed_cfg.faults.active else None)
        self.health: collections.Counter = \
            self.telemetry.metrics.counter_group("fed.health")
        m = self.telemetry.metrics
        self._h_round = m.histogram("fed.round_seconds")
        self._h_client_step = m.histogram("fed.client_step_seconds")
        m.gauge_fn("fed.server_round", lambda: float(len(self.history)))
        m.gauge_fn("fed.async_buffer_fill",
                   lambda: float(len(self._buffer)))
        m.gauge_fn("fed.async_inflight", lambda: float(len(self._inflight)))
        m.gauge_fn("fed.client_step_ema_mean",
                   lambda: float(self.client_step_ema[self._ema_seen].mean())
                   if self._ema_seen.any() else 0.0)

    # ------------------------------------------------------------ sampling
    def _batch_indices(self, client: ClientState) -> np.ndarray:
        """[local_steps, batch_size] example indices: shuffled epochs from
        the client's numpy generator, exactly the reference's draws."""
        B, steps = self.fcfg.batch_size, self.fcfg.local_steps
        n = client.data["tokens"].shape[0]
        if n < B:
            raise ValueError(f"client shard has {n} examples < batch_size "
                             f"{B}; an epoch yields no batches")
        out: list[np.ndarray] = []
        while len(out) < steps:
            perm = client.rng.permutation(n)
            for i in range(0, n - B + 1, B):
                out.append(perm[i: i + B])
                if len(out) == steps:
                    break
        return np.stack(out)

    @property
    def _n_sample(self) -> int:
        fc = self.fcfg
        return max(int(round(fc.sample_rate * fc.num_clients)), 1)

    def _prefetch(self, client: ClientState) -> dict:
        """The reference loop's batches: the fused round's batch indices,
        gathered on the host and copied once per key."""
        ix = self._batch_indices(client)
        return {k: torch.from_numpy(np.asarray(v)[ix]).to(self.device)
                for k, v in client.data.items() if k in _BATCH_KEYS}

    def _record_step_time(self, clients, seconds: float, *,
                          path: str | None = None,
                          only_unseen: bool = False) -> None:
        """Fold one measured local-training time into the per-client EMA.
        The reference loop times each client; a cohort call sees only the
        cohort's wall, so it passes ``only_unseen=True`` and seeds the
        unmeasured clients without touching measured ones.  The first
        measurement of each ``path`` (its warm-up) is discarded."""
        if path is not None and path not in self._measure_warm:
            self._measure_warm.add(path)
            return
        self._h_client_step.observe(seconds)
        beta = self.fcfg.delay_ema_beta
        for k in np.atleast_1d(np.asarray(clients, np.int64)):
            if self._ema_seen[k]:
                if only_unseen:
                    continue
                self.client_step_ema[k] = (beta * self.client_step_ema[k]
                                           + (1.0 - beta) * seconds)
            else:
                self.client_step_ema[k] = seconds
                self._ema_seen[k] = True

    def derived_async_delays(self) -> tuple:
        """Async delays from the measured EMAs: a client n× slower than the
        fastest measured one retires n-1 ticks late; unmeasured clients in
        a measured pool take the pool median's delay (no measurement at all:
        every delay 0)."""
        if not self._ema_seen.any():
            return (0,) * self.fcfg.num_clients
        base = float(self.client_step_ema[self._ema_seen].min())
        delays = np.zeros((self.fcfg.num_clients,), np.int64)
        if base > 0:
            ratio = self.client_step_ema[self._ema_seen] / base
            delays[self._ema_seen] = np.maximum(
                np.round(ratio).astype(np.int64) - 1, 0)
            med = float(np.median(self.client_step_ema[self._ema_seen]))
            delays[~self._ema_seen] = max(int(round(med / base)) - 1, 0)
        return tuple(int(d) for d in delays)

    def _sample_clients(self, pool: list | None = None,
                        round_idx: int | None = None) -> list[int]:
        """Sample one cohort with the reference's numpy calls.  ``pool``
        restricts the draw (the async tick passes the idle clients).
        ``sampling="availability"`` weights measured clients by
        ``(fastest_ema / ema_k)^alpha`` (unmeasured ones 1.0) and, with an
        active fault schedule, routes around the clients drawn offline for
        ``round_idx`` unless that leaves fewer than a cohort; until an EMA
        lands it is the uniform draw, whose stream faults never touch."""
        fc = self.fcfg
        if fc.sampling not in ("uniform", "availability"):
            raise ValueError(f"unknown sampling {fc.sampling!r} (expected "
                             "'uniform' or 'availability')")
        n = self._n_sample
        if (fc.sampling == "availability"
                and self.fault_schedule is not None):
            off = self.fault_schedule.offline(
                self.server.round if round_idx is None else round_idx)
            if off:
                src = range(fc.num_clients) if pool is None else pool
                kept = [int(k) for k in src if int(k) not in off]
                if len(kept) >= n:
                    pool = kept
        ids = None if pool is None else np.asarray(pool, np.int64)
        if fc.sampling == "availability":
            seen = self._ema_seen if ids is None else self._ema_seen[ids]
            if seen.any():
                ema = (self.client_step_ema if ids is None
                       else self.client_step_ema[ids])
                w = np.ones(seen.shape[0], np.float64)
                base = float(ema[seen].min())
                if base > 0:
                    w[seen] = (base / ema[seen]) ** fc.availability_alpha
                src = np.arange(fc.num_clients) if ids is None else ids
                return sorted(int(k) for k in self.rng.choice(
                    src, n, replace=False, p=w / w.sum()))
        if ids is None:
            return sorted(int(k) for k in self.rng.choice(
                fc.num_clients, n, replace=False))
        return sorted(int(k) for k in self.rng.choice(ids, n, replace=False))

    # ---------------------------------------------------------------- mesh
    @property
    def client_mesh(self):
        return self._client_mesh

    @client_mesh.setter
    def client_mesh(self, m):
        """A new mesh drops the built round steps and evaluation steps
        (their cohort padding and tensor-parallel split are fixed when
        they are built); the base weights are re-cut at the next use."""
        if m is not None and self.fcfg.paged:
            raise NotImplementedError(
                "paged=True with a round mesh is not supported — page the "
                "population or shard the cohort, not both")
        if m is not None and not isinstance(m, Mesh):
            raise TypeError(f"a round mesh is a repro_torch.launch.mesh.Mesh,"
                            f" got {type(m).__name__}")
        if not hasattr(self, "_client_mesh") or self._client_mesh is not m:
            self._round_step = None
            self._client_update_step = None
            self._local_train = None
            self._pop_eval_cache = {}
            self._gen_cache = {}
            tp = None
            if m is not None and round_mesh_axes(m)[1] is not None:
                tp = TensorParallel(self.mcfg, m)
            self._tp = tp
            self._eval_loss = make_eval_step(
                self.mcfg, lora_scale=self.fcfg.lora_alpha
                / self.fcfg.global_rank, tp=tp)
        self._client_mesh = m

    @property
    def mesh(self):
        """The round mesh (alias of ``client_mesh``)."""
        return self.client_mesh

    @mesh.setter
    def mesh(self, m):
        self.client_mesh = m

    def _place_mesh_state(self) -> None:
        """Hold the base weights as the current mesh's pieces: this rank's
        tensor-parallel pieces on a 2-D mesh (``TensorParallel.
        shard_params``), whole otherwise — re-joining the pieces of an
        earlier mesh first.  Every other piece of state is whole on every
        rank.  Idempotent."""
        if self._base_tp is self._tp:
            return
        params = self.base_params
        if self._base_tp is not None:
            params = self._base_tp.unshard_params(params)
        if self._tp is not None:
            params = self._tp.shard_params(params)
        self.base_params, self._base_tp = params, self._tp

    def set_base_params(self, params: Tree, *, split: bool = False) -> None:
        """Adopt base weights on the trainer's device: whole, or with
        ``split`` this rank's pieces for the trainer's mesh (e.g.
        ``interop.params_from_numpy(..., mesh=trainer.mesh)``)."""
        self.base_params = params
        self._base_tp = self._tp if split else None

    def base_params_whole(self) -> Tree:
        """The base weights whole (the pieces of every rank joined)."""
        if self._base_tp is None:
            return self.base_params
        return self._base_tp.unshard_params(self.base_params)

    # --------------------------------------------------------------- round
    def _get_round_step(self):
        self._place_mesh_state()
        if self._round_step is None:
            fc = self.fcfg
            self._round_step = make_round_engine(
                self.mcfg, self.ocfg, lora_scale=self.lora_scale,
                r_g=self.lcfg.rank, edit=fc.edit, aggregator=fc.aggregator,
                hetlora_beta=fc.hetlora_beta,
                hetlora_prune_gamma=fc.hetlora_prune_gamma,
                clip=fc.clip_norm or None, trim=fc.trim_frac,
                faults=self.fault_schedule is not None,
                mesh=self.client_mesh, n_sample=self._n_sample)
        return self._round_step

    def _dispatch(self, name: str, fn, *args, **kw):
        """Call ``fn``, tallied in ``dispatch_count`` under ``name`` and
        spanned (the span name is the dispatch-count key), with the
        telemetry current, so the phases and layers ``fn`` launches record
        their spans under it.  Kernels run asynchronously, so a span
        measures the host's enqueue."""
        self.dispatch_count[name] += 1
        with self.telemetry.current(), \
                self.telemetry.span(name, cat="dispatch"):
            return fn(*args, **kw)

    def flora_reinit(self, round_idx: int, sampled: list[int]):
        """FLoRA's fresh draws for one round: ``(client_lora0, global_new)``
        — the sampled clients' restart adapters stacked ``[n_s, ...]`` at the
        global rank (the round masks each to its client's rank) and the
        next global adapter.  The reference draws them from ``jax.random``
        (``PRNGKey(1000 * round + k)`` and ``PRNGKey(round + 77)``), which
        torch cannot reproduce; here they come from seeded torch
        generators.  This method is the one seam a parity test replaces
        (``repro_torch.interop.flora_reinit_from_numpy``)."""
        clients = stack_trees([init_lora_params(
            self.specs, self.lcfg, generator=_generator(
                self.device, self._seed,
                _FLORA_CLIENT_STREAM + 1000 * round_idx + k))
            for k in sampled])
        glob = init_lora_params(self.specs, self.lcfg, generator=_generator(
            self.device, self._seed, _FLORA_GLOBAL_STREAM + round_idx))
        return clients, glob

    def _fault_cohort(self, round_idx: int, sampled: list[int]) -> dict:
        """One cohort's fault draws, with the measured step-time EMAs fed to
        the deadline check (NaN for unmeasured clients, which the schedule
        ignores); corruption is counted here, on the host, since the device
        sees it only where it makes a value non-finite."""
        with self.telemetry.span("fault_draw", cat="fed",
                                 round=round_idx, cohort=len(sampled)):
            ema = np.where(self._ema_seen, self.client_step_ema, np.nan)
            co = self.fault_schedule.cohort(round_idx, sampled, step_ema=ema)
            self.health["n_corrupted"] += int(co["n_corrupted"])
            return co

    def _fault_operand(self, co: dict) -> dict:
        """The cohort's draws as the round's ``fault`` operand; ``kept``
        (the rows whose clients were not dropped) is built here from the
        host's ``keep``, so the device never reports it back."""
        op = {k: self._to_device(co[k]) for k in _FAULT_KEYS}
        op["kept"] = self._to_device(np.flatnonzero(co["keep"] > 0))
        return op

    def _build_round_inputs(self) -> tuple[list[int], np.ndarray]:
        with self.telemetry.span("sample_cohort", cat="fed"):
            sampled = self._sample_clients()
        with self.telemetry.span("build_batch_indices", cat="fed",
                                 cohort=len(sampled)):
            batch_idx = np.stack([self._batch_indices(self.clients[k])
                                  for k in sampled])
        return sampled, batch_idx

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host arrays → the device without waiting for it: a copy from
        pageable memory synchronises the stream, one from pinned memory
        does not."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _state_operands(self, sampled: list[int]):
        """``(idx, lora, ranks, sizes, data, slots)`` of a cohort: rows of
        the resident ``[K, ...]`` state (``slots`` None), or — paged — its
        bank slots after paging the cohort in (pinned until the caller
        releases it)."""
        if self.store is None:
            return (self._to_device(np.asarray(sampled, np.int64)),
                    self.stacked_lora, self._ranks_dev, self._sizes_dev,
                    self._stacked_data, None)
        st = self.store
        slots = st.acquire_cohort(sampled)
        return (self._to_device(slots.astype(np.int64)), st.lora_bank,
                st.ranks_bank, st.sizes_bank, st.data_bank, slots)

    def _enqueue_round(self, sampled: list[int],
                       batch_idx: np.ndarray) -> dict:
        """Enqueue the fused round; the stacked state (or the store's bank)
        is updated in place and the server's adapters move on (no wait for
        the device).  Paged, the next round's page-in is enqueued behind
        this round on the same stream."""
        idx, lora, ranks, sizes, data, slots = self._state_operands(sampled)
        bidx = self._to_device(batch_idx.astype(np.int64))
        fault_args: tuple = ()
        if self.fault_schedule is not None:
            fault_args = (self._fault_operand(
                self._fault_cohort(self.server.round, sampled)),)
        kw = {}
        if self.fcfg.aggregator == "flora":
            kw["reinit"] = self.flora_reinit(self.server.round, sampled)
        out = self._dispatch(
            "round_step", self._get_round_step(), self.base_params, lora,
            self.server.global_lora, self.server.prev_global, ranks, sizes,
            data, idx, bidx, *fault_args, **kw)
        if slots is not None:
            self.store.adopt(out["stacked_lora"], out["ranks"])
            self.store.mark_trained(sampled)
            self.store.release_cohort(sampled)
        self.server.prev_global = out["prev_global"]
        self.server.global_lora = out["global_lora"]
        if "base_params" in out:          # FLoRA folded its delta in place
            self.base_params = out["base_params"]
        self.server.round += 1
        self._last_slots = slots
        return out

    def _fetch_round_record(self, round_no: int, sampled: list[int],
                            out: dict, slots=None) -> dict:
        """The round's one blocking host sync: last losses, edited modules,
        the health values (faults active) and the post-pruning ranks,
        packed into one f32 tensor (the integers are small enough to ride
        exactly) and copied once.  ``slots`` (paged) maps the bank's
        ``ranks[S]`` back onto the sampled clients of the host mirror,
        which the store shares and so is updated in place."""
        met = out["metrics"]
        n_s = len(sampled)
        parts = [met["last_loss"].float()]
        if "edited" in met:
            parts.append(met["edited"].float())
        if "health" in out:
            parts.append(torch.stack([out["health"][k].float()
                                      for k in _HEALTH_KEYS]))
        parts.append(out["ranks"].float())
        with self.telemetry.span("metrics_fetch", cat="fed", round=round_no):
            host = torch.cat(parts).cpu().numpy()
        losses, at = host[:n_s], n_s
        edited = None
        if "edited" in met:
            edited, at = host[at:at + n_s], at + n_s
        ranks = host[-out["ranks"].shape[0]:].astype(np.int32)
        if slots is None:
            self.client_ranks = ranks
        else:
            self.client_ranks[np.asarray(sampled, np.int64)] = \
                ranks[np.asarray(slots, np.int64)]
        rec = {"round": round_no, "sampled": list(map(int, sampled)),
               "train_loss": float(np.mean(losses)),
               "edited_layers": [] if edited is None
               else [int(e) for e in edited]}
        if "health" in out:
            h = {k: float(v) for k, v in zip(_HEALTH_KEYS,
                                              host[at:at + len(_HEALTH_KEYS)])}
            rec["health"] = h
            for k in ("n_dropped", "n_forfeited", "n_nonfinite"):
                self.health[k] += int(h[k])
            self.health["clip_rate_sum"] += h["clip_rate"]
            self.health["fault_rounds"] += 1
        self.history.append(rec)
        return rec

    def run_round(self) -> dict:
        """One communication round: one fused round call, one host sync
        (a pending pipelined round is drained first)."""
        t0 = time.perf_counter()
        with self.telemetry.span("round", cat="fed", round=self.server.round):
            self.flush_rounds()
            sampled, batch_idx = self._build_round_inputs()
            out = self._enqueue_round(sampled, batch_idx)
            rec = self._fetch_round_record(self.server.round, sampled, out,
                                           self._last_slots)
        self._h_round.observe(time.perf_counter() - t0)
        return rec

    def run_round_pipelined(self) -> dict | None:
        """Build round t's host inputs (the work that overlaps round t-1 on
        the device), fetch round t-1's record, then enqueue round t.  The
        record returned is one round stale (``None`` on the first call;
        ``flush_rounds()`` drains the last)."""
        t0 = time.perf_counter()
        with self.telemetry.span("round_pipelined", cat="fed",
                                 round=self.server.round):
            sampled, batch_idx = self._build_round_inputs()
            rec = self.flush_rounds()
            out = self._enqueue_round(sampled, batch_idx)
            self._pending = (self.server.round, sampled, out,
                             self._last_slots)
        self._h_round.observe(time.perf_counter() - t0)
        return rec

    def flush_rounds(self) -> dict | None:
        """Fetch the pending pipelined round's record (``None`` if none)."""
        rec = None
        if self._pending is not None:
            rec = self._fetch_round_record(*self._pending)
            self._pending = None
        return rec

    def export_adapters(self) -> dict:
        """Personalized adapters for serving: ``{"client<k>": (host adapter
        tree padded to r_g, true rank r_k)}``, after draining a pending
        pipelined round: one copy of the stacked state, or — paged — one
        store flush, then every client from the host tier (no ``[K, ...]``
        stack is built)."""
        self.flush_rounds()
        if self.store is not None:
            self.store.flush()
            return {f"client{k}": (self.store.host_adapter(k),
                                   int(self.client_ranks[k]))
                    for k in range(self.fcfg.num_clients)}
        host = tree_map(lambda x: x.cpu(), self.stacked_lora)
        return {f"client{k}": (tree_map(lambda x, k=k: x[k], host),
                               int(self.client_ranks[k]))
                for k in range(self.fcfg.num_clients)}

    # ------------------------------------------------------------ async
    def _get_client_update_step(self):
        self._place_mesh_state()
        if self._client_update_step is None:
            fc = self.fcfg
            self._client_update_step = make_client_update_step(
                self.mcfg, self.ocfg, lora_scale=self.lora_scale,
                r_g=self.lcfg.rank, edit=fc.edit, aggregator=fc.aggregator,
                hetlora_prune_gamma=fc.hetlora_prune_gamma,
                faults=self.fault_schedule is not None,
                mesh=self.client_mesh, n_sample=self._n_sample)
        return self._client_update_step

    def _get_merge_step(self):
        if self._merge_step is None:
            fc = self.fcfg
            self._merge_step = make_buffer_merge_step(
                aggregator=fc.aggregator,
                staleness_decay=fc.staleness_decay,
                hetlora_beta=fc.hetlora_beta, lora_scale=self.lora_scale,
                guard=self.fault_schedule is not None)
        return self._merge_step

    def run_round_async(self) -> dict:
        """One spanned tick of the buffered asynchronous timeline (see
        :meth:`_run_round_async_impl`)."""
        with self.telemetry.span("async_tick", cat="fed",
                                 tick=self._async_tick):
            return self._run_round_async_impl()

    def _run_round_async_impl(self) -> dict:
        """One tick of the buffered asynchronous (FedBuff) timeline:

        1. train a cohort of ``n_sample`` idle clients against the current
           global (tagged with the server version it saw);
        2. retire the in-flight updates whose simulated delay
           (``FederatedConfig.async_delays``, plus ``straggler_ticks`` for a
           drawn straggler) has elapsed into the buffer;
        3. while ``M`` (``buffer_size`` or ``n_sample``) updates are
           buffered, merge the ``M`` oldest with staleness = current
           version − dispatch version.

        Faults key on the tick: a dropped client's update never reaches the
        buffer, a straggler's arrives late (``n_deferred``), and the merge
        guard counts poisoned updates (``n_nonfinite``).  The tick's
        merged losses, guard counts and ranks come back in one fetch.  With
        zero delays and ``M = n_sample`` a tick is the synchronous round."""
        fc = self.fcfg
        if fc.aggregator not in ("fedbuff", "fedbuff_kernel"):
            raise ValueError(
                f"run_round_async needs aggregator 'fedbuff' or "
                f"'fedbuff_kernel', got {fc.aggregator!r} (synchronous "
                "strategies cannot weight stale deltas)")
        delays = fc.async_delays
        if not delays and fc.measure_delays:
            delays = self.derived_async_delays()
        delays = delays or (0,) * fc.num_clients
        if len(delays) != fc.num_clients:
            raise ValueError(f"async_delays has {len(delays)} entries for "
                             f"{fc.num_clients} clients")
        self.flush_rounds()
        tick = self._async_tick
        n_s = self._n_sample
        rec: dict = {"tick": tick, "sampled": [], "merges": 0,
                     "staleness": [], "version": self._global_version}

        # ---- 1. train a cohort of idle clients
        busy = {e["client"] for e in self._inflight}
        avail = [k for k in range(fc.num_clients) if k not in busy]
        if len(avail) >= n_s:
            sampled = self._sample_clients(pool=avail, round_idx=tick)
            batch_idx = np.stack([self._batch_indices(self.clients[k])
                                  for k in sampled])
            co = None
            fault_args: tuple = ()
            if self.fault_schedule is not None:
                co = self._fault_cohort(tick, sampled)
                fault_args = (self._fault_operand(co),)
            measure = (fc.measure_delays
                       and not self._ema_seen[list(sampled)].all())
            # paged: the cohort stays pinned until it retires (its bank
            # rows hold the updated adapters until then)
            idx, lora, ranks, sizes, data, slots = \
                self._state_operands(sampled)
            bidx = self._to_device(batch_idx.astype(np.int64))
            t0 = time.perf_counter()
            out = self._dispatch(
                "client_update", self._get_client_update_step(),
                self.base_params, lora, self.server.global_lora,
                self.server.prev_global, ranks, sizes, data, idx, bidx,
                *fault_args)
            if measure:
                # the cohort's wall needs it finished: one sync a tick,
                # only while a sampled client is unmeasured
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._record_step_time(sampled, time.perf_counter() - t0,
                                       path="client_update",
                                       only_unseen=True)
            if slots is not None:
                dropped = ([] if co is None else
                           [k for i, k in enumerate(sampled)
                            if co["keep"][i] <= 0])
                self.store.adopt(out["stacked_lora"], out["ranks"])
                # a dropped client was not scattered back: its row is clean
                # and it retires now
                self.store.mark_trained([k for k in sampled
                                         if k not in dropped])
                if dropped:
                    self.store.release_cohort(dropped)
            cohort = {"update": out["update"], "ranks": out["update_ranks"],
                      "sizes": out["update_sizes"],
                      "loss": out["metrics"]["last_loss"]}
            for i, k in enumerate(sampled):
                if co is not None and co["keep"][i] <= 0:
                    continue           # mid-round dropout: never lands
                extra = 0 if co is None else int(co["extra_ticks"][i])
                self._inflight.append({
                    "client": int(k), "row": i, "cohort": cohort,
                    "version": self._global_version,
                    "finish": tick + int(delays[k]) + extra})
            rec["sampled"] = list(map(int, sampled))
            if co is not None:
                self.health["n_dropped"] += int(co["n_dropped"])
                # async stragglers arrive later, they are not forfeited
                self.health["n_deferred"] += int(co["n_forfeited"])
                rec["health"] = {"n_dropped": int(co["n_dropped"]),
                                 "n_deferred": int(co["n_forfeited"])}

        # ---- 2. retire finished updates into the buffer (arrival order)
        done = [e for e in self._inflight if e["finish"] <= tick]
        self._inflight = [e for e in self._inflight if e["finish"] > tick]
        self._buffer.extend(done)
        if self.store is not None and done:
            # retirement: the rows become evictable (dirty, so an eviction
            # captures them)
            self.store.release_cohort([e["client"] for e in done])

        # ---- 3. merge M-update batches through the fedbuff registry entry
        M = fc.buffer_size or n_s
        merged_losses, merge_health = [], []
        while len(self._buffer) >= M:
            batch, self._buffer = self._buffer[:M], self._buffer[M:]
            c0 = batch[0]["cohort"]
            if (M == int(c0["ranks"].shape[0])
                    and all(b["cohort"] is c0 for b in batch)
                    and [b["row"] for b in batch] == list(range(M))):
                # one whole cohort in order: its stacked update, unsliced
                stacked, ranks_b, sizes_b = (c0["update"], c0["ranks"],
                                             c0["sizes"])
            else:                           # rows of several cohorts
                stacked = {n: {m: torch.stack(
                    [b["cohort"]["update"][n][m][b["row"]] for b in batch])
                    for m in ("A", "B")} for n in c0["update"]}
                ranks_b = torch.stack([b["cohort"]["ranks"][b["row"]]
                                       for b in batch])
                sizes_b = torch.stack([b["cohort"]["sizes"][b["row"]]
                                       for b in batch])
            stal = np.asarray([self._global_version - b["version"]
                               for b in batch], np.float32)
            mo = self._dispatch(
                "buffer_merge", self._get_merge_step(), stacked, ranks_b,
                sizes_b, self._to_device(stal), self.server.global_lora)
            self.server.prev_global = mo["prev_global"]
            self.server.global_lora = mo["global_lora"]
            if "health" in mo:
                merge_health.append(mo["health"]["n_nonfinite"])
            self._global_version += 1
            self.server.round += 1
            rec["merges"] += 1
            rec["staleness"].extend(float(s_) for s_ in stal)
            merged_losses.extend(b["cohort"]["loss"][b["row"]]
                                 for b in batch)
        if merged_losses:
            n_l, n_h = len(merged_losses), len(merge_health)
            parts = [torch.stack(merged_losses).float()]
            if merge_health:
                parts.append(torch.stack(merge_health).float())
            if self.store is None:
                # paged: the bank's ranks are not the [K] mirror, and
                # fedbuff never prunes, so only the losses come back
                parts.append(self._ranks_dev.float())
            with self.telemetry.span("metrics_fetch", cat="fed", tick=tick):
                host = torch.cat(parts).cpu().numpy()
            if self.store is None:
                self.client_ranks = host[-fc.num_clients:].astype(np.int32)
            rec["train_loss"] = float(np.mean(host[:n_l]))
            if merge_health:
                nnf = int(np.sum(host[n_l:n_l + n_h]))
                self.health["n_nonfinite"] += nnf
                rec.setdefault("health", {})["n_nonfinite"] = nnf
        rec["buffer_fill"] = len(self._buffer)
        self._async_tick += 1
        self.history.append(rec)
        return rec

    # -------------------------------------------------------- reference
    @torch.no_grad()
    def run_round_reference(self) -> dict:
        """The host loop the fused round is held against: one local-training
        call and one blocking read per client, eager self-pruning and
        editing, one stack and scatter (paged: ``write_client`` per client),
        then aggregation through the registry with an explicit
        ``prev_global`` snapshot.  FLoRA restarts each client from
        :meth:`flora_reinit`'s draws and folds its delta into the base
        weights.  With ``measure_delays`` it times each client's local
        training (the only timeline that measures clients one by one)."""
        fc = self.fcfg
        flora = fc.aggregator == "flora"
        sampled = self._sample_clients()
        r_g = self.lcfg.rank
        self._place_mesh_state()
        if self._local_train is None:
            self._local_train = _make_local_train(
                self.mcfg, self.ocfg, lora_scale=self.lora_scale, r_g=r_g,
                tp=self._tp)
        reinit = self.flora_reinit(self.server.round, sampled) if flora \
            else None
        edited_layers, losses, client_lora = [], [], {}
        for i, k in enumerate(sampled):
            rank_k = int(self.client_ranks[k])
            if flora:       # the base holds the folded delta; start afresh
                lora0 = mask_lora_params(
                    {n: {m: e[m][i] for m in ("A", "B")}
                     for n, e in reinit[0].items()}, rank_k, r_g)
            else:
                lora0 = truncate_redistribute(self.server.global_lora,
                                              rank_k, r_g)
            batches = self._prefetch(self.clients[k])
            t0 = time.perf_counter()
            lora1, ls = self._local_train(self.base_params, lora0, rank_k,
                                          batches)
            losses.append(float(ls[-1]))       # waits for this client
            if fc.measure_delays:
                self._record_step_time(k, time.perf_counter() - t0,
                                       path="local_train")
            if fc.aggregator == "hetlora" and fc.hetlora_prune_gamma > 0:
                pruned = rank_k
                for entry in lora1.values():
                    pruned = min(pruned, int(AG.hetlora_self_prune(
                        entry, rank_k, r_g, fc.hetlora_prune_gamma)))
                if pruned < rank_k:
                    rank_k = max(pruned, 1)
                    self.client_ranks[k] = rank_k
                    lora1 = mask_lora_params(lora1, rank_k, r_g)
            if fc.edit.enabled and not flora:
                glob_prev = truncate_redistribute(self.server.prev_global,
                                                  rank_k, r_g)
                lora1, diag = edit_lora(lora1, glob_prev, fc.edit)
                lora1 = mask_lora_params(lora1, rank_k, r_g)
                edited_layers.append(int(torch.argmax(diag["selected"])))
            client_lora[k] = lora1

        stacked = stack_trees([client_lora[k] for k in sampled])
        if self.store is not None:
            for k in sampled:
                self.store.write_client(k, client_lora[k],
                                        rank=int(self.client_ranks[k]))
        else:
            ks = torch.tensor(sampled, device=self.device)
            for name, entry in self.stacked_lora.items():
                for m in ("A", "B"):
                    entry[m].index_copy_(0, ks, stacked[name][m])
            self._ranks_dev = torch.tensor(self.client_ranks,
                                           device=self.device)

        ranks = torch.tensor([int(self.client_ranks[k]) for k in sampled],
                             dtype=torch.int32, device=self.device)
        sizes = np.asarray([self.clients[k].size for k in sampled],
                           np.float32)
        p = torch.from_numpy(sizes / sizes.sum()).to(self.device)
        self.server.prev_global = tree_map(torch.clone,
                                           self.server.global_lora)
        kw = {}
        if fc.aggregator in ("fedilora_clip", "fedilora_clip_kernel"):
            kw["anchor"] = self.server.prev_global
        global_new, base_delta = AG.aggregate(
            fc.aggregator, stacked, ranks, p, hetlora_beta=fc.hetlora_beta,
            lora_scale=self.lora_scale, clip=fc.clip_norm or None,
            trim=fc.trim_frac, **kw)
        if base_delta is not None:                    # FLoRA
            apply_weight_deltas(self.base_params, base_delta, self._tp)
            global_new = reinit[1]
        self.server.global_lora = global_new
        self.server.round += 1
        rec = {"round": self.server.round, "sampled": list(map(int, sampled)),
               "train_loss": float(np.mean(losses)),
               "edited_layers": edited_layers}
        self.history.append(rec)
        return rec

    # ---------------------------------------------------------- evaluation
    def _eval_batch(self, data: dict, n: int = 64) -> dict:
        return {k: torch.from_numpy(np.asarray(v[:n])).to(self.device)
                for k, v in data.items() if k in _EVAL_KEYS}

    def evaluate_global(self, generate: bool = True, n: int = 32) -> dict:
        """Loss and accuracy of the global adapter on the first 64 global
        test rows and, with ``generate``, BLEU/RSUM of its greedy captions
        for the first ``n``."""
        self._place_mesh_state()
        m = self._dispatch("eval_loss", self._eval_loss, self.base_params,
                           self.server.global_lora,
                           self._eval_batch(self.global_test))
        out = {"loss": float(m["loss"]), "acc": float(m["acc"])}
        if generate:
            out.update(self.generation_scores(self.server.global_lora,
                                              self.global_test, n))
        return out

    def evaluate_personalized(self, generate: bool = True, n: int = 16,
                              loss_n: int = 64, vmapped: bool = True) -> dict:
        """Size-weighted average of every client's evaluation on its own
        adapter (paper Sec. 2.2).  ``vmapped=True``: one population-eval
        call over the stacked state (paged: one a tile of ``store_slots``
        clients, from the flushed host tier); client k contributes
        ``min(loss_n, |shard_k|)`` loss rows and ``min(n, |shard_k|)``
        generation rows, shorter shards zero-padded (zero loss mask,
        padded generations sliced off before scoring).  ``vmapped=False``
        is the reference's per-client host loop (``eval_loss`` and
        ``generate`` per client), the same numbers client by client."""
        w = np.asarray([c.size for c in self.clients], np.float64)
        w = w / w.sum()
        self._place_mesh_state()
        if not vmapped:
            accs, losses, bleus, rsums = [], [], [], []
            for c in self.clients:
                lora_k = c.lora
                m = self._dispatch("eval_loss", self._eval_loss,
                                   self.base_params, lora_k,
                                   self._eval_batch(c.eval_data, loss_n))
                losses.append(float(m["loss"]))
                accs.append(float(m["acc"]))
                if generate:
                    g = self.generation_scores(lora_k, c.eval_data, n)
                    bleus.append(g["bleu"])
                    rsums.append(g["rsum"])
            out = {"loss": float(np.dot(w, losses)),
                   "acc": float(np.dot(w, accs))}
            if generate:
                out["bleu"] = float(np.dot(w, bleus))
                out["rsum"] = float(np.dot(w, rsums))
            return out

        shard_rows = [c.eval_data["tokens"].shape[0] for c in self.clients]
        rows = min(max(n, loss_n), max(shard_rows))
        keys = [k for k in _EVAL_KEYS
                if all(k in c.eval_data for c in self.clients)]
        partial = [k for k in _EVAL_KEYS if k not in keys
                   and any(k in c.eval_data for c in self.clients)]
        if partial:
            raise ValueError(f"eval batch keys {partial} present in only "
                             "some client shards; use vmapped=False")

        def _pad(x):
            x = np.asarray(x)[:rows]
            if x.shape[0] < rows:
                x = np.pad(x, [(0, rows - x.shape[0])]
                           + [(0, 0)] * (x.ndim - 1))
            return x

        gen_rows = [min(n, r) for r in shard_rows]
        cap_start = gen_len = None
        if generate:
            cap_start, gen_len = _mask_decode_bounds(np.concatenate(
                [np.asarray(c.eval_data["loss_mask"])[:gen_rows[k]]
                 for k, c in enumerate(self.clients)]))
        # split the clients over the mesh's client axis (each group
        # evaluates its block, tensor-parallel on a 2-D mesh) when they
        # divide it; otherwise every rank evaluates every client
        K = len(self.clients)
        mesh = self.client_mesh
        sharded = (mesh is not None
                   and K % mesh.shape[round_mesh_axes(mesh)[0]] == 0)
        if mesh is not None and not sharded:
            warnings.warn(
                f"client mesh {mesh} unusable for the population eval (need "
                f"a client axis whose size divides K={K}); running "
                "unsharded", stacklevel=2)
        key = (rows, loss_n, n, cap_start, gen_len, sharded)
        fn = self._pop_eval_cache.get(key)
        if fn is None:
            fn = make_population_eval(
                self.mcfg, lora_scale=self.lora_scale, cap_start=cap_start,
                gen_len=gen_len, loss_rows=min(loss_n, rows),
                gen_rows=min(n, rows), generate=generate,
                mesh=mesh if sharded else None, tp=self._tp)
            self._pop_eval_cache[key] = fn

        def _sweep(ids, lora):
            batch = {kk: torch.from_numpy(np.stack(
                [_pad(self.clients[k].eval_data[kk]) for k in ids])).to(
                    self.device) for kk in keys}
            res = self._dispatch("population_eval", fn, self.base_params,
                                 lora, batch)
            return {kk: v.cpu().numpy() for kk, v in res.items()}

        if self.store is None:
            fetched = _sweep(range(K), self.stacked_lora)
        else:
            # tiles of at most store_slots clients: the device never holds
            # more than one bank-sized adapter stack and its eval batch; a
            # short last tile is padded with its first client, whose rows
            # are dropped
            T_ = min(K, self.store.slots)
            self.store.flush()
            fetched = {}
            for t0 in range(0, K, T_):
                ids = list(range(t0, min(t0 + T_, K)))
                pad_ids = ids + [ids[0]] * (T_ - len(ids))
                tile = _sweep(pad_ids, self.store.stack_clients(pad_ids))
                for kk, v in tile.items():
                    fetched.setdefault(kk, []).append(v[:len(ids)])
            fetched = {kk: np.concatenate(v) for kk, v in fetched.items()}
        out = {"loss": float(np.dot(w, fetched["loss"])),
               "acc": float(np.dot(w, fetched["acc"]))}
        if generate:
            bleus, rsums = [], []
            for k, c in enumerate(self.clients):
                nk = gen_rows[k]
                sc = _score_generated(
                    fetched["gen"][k][:nk],
                    np.asarray(c.eval_data["labels"][:nk]),
                    np.asarray(c.eval_data["loss_mask"][:nk]))
                bleus.append(sc["bleu"])
                rsums.append(sc["rsum"])
            out["bleu"] = float(np.dot(w, bleus))
            out["rsum"] = float(np.dot(w, rsums))
        return out

    @torch.no_grad()
    def _next_logits(self, base_params, toks, lora, pos: int, image):
        """Logits [B, V] at position ``pos`` of a full forward (on a 2-D
        mesh, this rank's vocabulary columns)."""
        tp = self._tp
        logits, _ = T.forward(self.mcfg, base_params, toks,
                              lora=lora if tp is None else tp.local_lora(lora),
                              lora_scale=self.lora_scale, vision=image, tp=tp)
        return logits[:, pos]

    def _generate_cached(self, lora, tokens: np.ndarray, image,
                         cap_start: int, gen_len: int) -> np.ndarray:
        """KV-cached greedy decode of ``gen_len`` tokens after
        ``tokens[:, :cap_start + 1]`` (``image``: a tensor on the device or
        ``None``): one ``generate`` dispatch → int [B, gen_len]."""
        key = (tokens.shape[0], cap_start, gen_len)
        fn = self._gen_cache.get(key)
        if fn is None:
            fn = make_greedy_generate(
                self.mcfg, lora_scale=self.lora_scale,
                cap_start=cap_start, gen_len=gen_len, tp=self._tp)
            self._gen_cache[key] = fn
        toks = torch.from_numpy(
            np.ascontiguousarray(tokens[:, :cap_start + 1])).to(self.device)
        gen = self._dispatch("generate", fn, self.base_params, lora, toks,
                             image)
        return gen.cpu().numpy()

    def generation_scores(self, lora, data: dict, n: int = 32,
                          cached: bool = True) -> dict:
        """Greedy caption generation with ``lora`` → Google-BLEU /
        ROUGE-LSum over the first ``n`` rows of ``data``.  ``cached=True``
        decodes with the KV cache (one ``generate`` call); ``cached=False``
        is the reference's O(T²) decode, one full forward per token
        (``next_logits``), the same tokens."""
        tokens = np.asarray(data["tokens"][:n])
        labels = np.asarray(data["labels"][:n])
        loss_mask = np.asarray(data["loss_mask"][:n])
        cap_start, gen_len = _mask_decode_bounds(loss_mask)
        self._place_mesh_state()
        image = (torch.from_numpy(np.asarray(data["image"][:n])).to(
            self.device) if "image" in data else None)
        if cached:
            gen = self._generate_cached(lora, tokens, image, cap_start,
                                        gen_len)
            return _score_generated(gen, labels, loss_mask)
        toks = np.array(tokens, copy=True)
        toks[:, cap_start + 1:] = 0
        toks = torch.from_numpy(toks).to(self.device)
        cols = []
        for t in range(gen_len):
            lg = self._dispatch("next_logits", self._next_logits,
                                self.base_params, toks, lora, cap_start + t,
                                image)
            nxt = lg.argmax(-1) if self._tp is None else self._tp.argmax(lg)
            cols.append(nxt)                  # fetched once, below
            # a window ending at the sequence's end decodes its last token
            # past the buffer: nothing reads it back
            if cap_start + 1 + t < toks.shape[1]:
                toks[:, cap_start + 1 + t] = nxt.to(toks.dtype)
        gen = torch.stack(cols, dim=1).cpu().numpy()
        return _score_generated(gen, labels, loss_mask)


__all__ = ["ClientState", "FederatedTrainer", "ServerState"]
