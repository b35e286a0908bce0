"""Federated LoRA training runtime (port of ``repro/federated/runtime.py``:
the resident-state trainer and its fused round).

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
blocking fetch: losses, edited modules and post-pruning ranks, packed
into one tensor and copied to the host once.  Host randomness is numpy,
drawn with the reference's calls in the reference's order, so cohorts and
minibatches match it bit for bit.  ``dispatch_count`` tallies the round
and evaluation calls under the reference's names (``round_step``,
``eval_loss``, ``generate``, ``population_eval``).

Not ported yet (each raises ``NotImplementedError`` where it is asked
for): device meshes, the paged client store, fault injection, FLoRA's
round, and the reference's other timelines (``run_round_reference``,
``run_round_pipelined``, ``run_round_async``).  The trainer runs on the
CUDA device unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lora import LoRAConfig, init_lora_params
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import EOS
from repro_torch.federated.config import FederatedConfig
from repro_torch.launch.fedround import make_round_engine, stack_trees
from repro_torch.launch.steps import (make_eval_step, make_greedy_generate,
                                      make_population_eval)
from repro_torch.metrics import corpus_scores
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig
from repro_torch.telemetry import Telemetry

Tree = Any

# batch keys that ride the training step (anything else stays on the host)
_BATCH_KEYS = ("tokens", "labels", "loss_mask", "image", "image_mask",
               "audio", "text_mask")
# keys an evaluation batch may carry (loss + generation)
_EVAL_KEYS = ("tokens", "labels", "loss_mask", "image", "audio")


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


@dataclasses.dataclass
class ClientState:
    """One client's private data, its size and its numpy generator (its
    adapter and rank live in the trainer's stacked state)."""

    data: dict
    eval_data: dict
    size: int
    rng: np.random.Generator


def _generator(device: torch.device, seed: int, stream: int
               ) -> torch.Generator:
    """A torch generator for one named draw of the trainer's init."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (2 ** 63))


class FederatedTrainer:
    """Resident-state federated trainer (see the module docstring).

    ``base_params``: the frozen base weights as port tensors (``None``:
    ``T.init_params`` from ``seed`` on ``device``).  ``device``: ``None``
    means CUDA and raises without it.  The global and per-client adapters
    start from seeded torch generators; to start from a reference
    trainer's state use ``repro_torch.interop.load_reference_state``."""

    def __init__(self, model_cfg: ModelConfig, fed_cfg: FederatedConfig,
                 opt_cfg: OptimizerConfig, client_train: list[dict],
                 client_eval: list[dict], global_test: dict,
                 base_params: Tree | None = None, seed: int = 0,
                 mesh=None, telemetry: Telemetry | None = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError("the port's trainer runs on one "
                                      "device; round meshes are not ported")
        if fed_cfg.paged:
            raise NotImplementedError("the paged client store is not "
                                      "ported yet; use resident state")
        if fed_cfg.faults.active:
            raise NotImplementedError("fault injection is not ported yet")
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.fcfg = fed_cfg
        self.ocfg = opt_cfg
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
        self.clients = [ClientState(client_train[k], client_eval[k],
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
        # ---- persistent stacked client state [K, ...] on the device
        self.stacked_lora = stack_trees([
            init_lora_params(self.specs, self.lcfg,
                             generator=_generator(self.device, seed, 100 + k),
                             client_rank=fed_cfg.ranks[k])
            for k in range(fed_cfg.num_clients)])
        self._ranks_dev = torch.tensor(self.client_ranks, device=self.device)
        self._sizes_dev = torch.tensor(sizes, device=self.device)
        # device-resident training corpus [K, N_max, ...], zero-padded to the
        # longest shard (batch indices never reach the padding); the round
        # gathers its minibatches from it on the device
        n_max = max(d["tokens"].shape[0] for d in client_train)
        self._stacked_data = {
            kk: torch.from_numpy(np.stack([
                np.pad(np.asarray(d[kk]),
                       [(0, n_max - d[kk].shape[0])]
                       + [(0, 0)] * (np.asarray(d[kk]).ndim - 1))
                for d in client_train])).to(self.device)
            for kk in keys}
        self._round_step = None          # the fused round, built on first use
        self._eval_loss = make_eval_step(model_cfg,
                                         lora_scale=self.lora_scale)
        self._gen_cache: dict = {}
        self._pop_eval_cache: dict = {}
        self.rng = np.random.default_rng(seed)
        self.history: list[dict] = []
        m = self.telemetry.metrics
        self._h_round = m.histogram("fed.round_seconds")
        m.gauge_fn("fed.server_round", lambda: float(len(self.history)))

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

    def _sample_clients(self) -> list[int]:
        """Sample one cohort with the reference's numpy call.
        ``sampling="availability"`` weights clients by measured local-step
        times; the fused round measures none (in the reference too), so
        there it is the same uniform draw."""
        fc = self.fcfg
        if fc.sampling not in ("uniform", "availability"):
            raise ValueError(f"unknown sampling {fc.sampling!r} (expected "
                             "'uniform' or 'availability')")
        return sorted(int(k) for k in self.rng.choice(
            fc.num_clients, self._n_sample, replace=False))

    # --------------------------------------------------------------- round
    def _get_round_step(self):
        if self._round_step is None:
            fc = self.fcfg
            self._round_step = make_round_engine(
                self.mcfg, self.ocfg, lora_scale=self.lora_scale,
                r_g=self.lcfg.rank, edit=fc.edit, aggregator=fc.aggregator,
                hetlora_beta=fc.hetlora_beta,
                hetlora_prune_gamma=fc.hetlora_prune_gamma,
                clip=fc.clip_norm or None, trim=fc.trim_frac)
        return self._round_step

    def _dispatch(self, name: str, fn, *args):
        """Call ``fn``, tallied in ``dispatch_count`` under ``name`` and
        spanned (the span name is the dispatch-count key).  Kernels run
        asynchronously, so the span measures the host's enqueue."""
        self.dispatch_count[name] += 1
        with self.telemetry.span(name, cat="dispatch"):
            return fn(*args)

    def _build_round_inputs(self) -> tuple[list[int], np.ndarray]:
        with self.telemetry.span("sample_cohort", cat="fed"):
            sampled = self._sample_clients()
        with self.telemetry.span("build_batch_indices", cat="fed",
                                 cohort=len(sampled)):
            batch_idx = np.stack([self._batch_indices(self.clients[k])
                                  for k in sampled])
        return sampled, batch_idx

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host indices → the device without waiting for it: a copy from
        pageable memory synchronises the stream, one from pinned memory
        does not."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _enqueue_round(self, sampled: list[int],
                       batch_idx: np.ndarray) -> dict:
        """Enqueue the fused round; the stacked state is updated in place
        and the server's adapters move on (no wait for the device)."""
        idx = self._to_device(np.asarray(sampled, np.int64))
        bidx = self._to_device(batch_idx.astype(np.int64))
        out = self._dispatch(
            "round_step", self._get_round_step(), self.base_params,
            self.stacked_lora, self.server.global_lora,
            self.server.prev_global, self._ranks_dev, self._sizes_dev,
            self._stacked_data, idx, bidx)
        self.server.prev_global = out["prev_global"]
        self.server.global_lora = out["global_lora"]
        self.server.round += 1
        return out

    def _fetch_round_record(self, round_no: int, sampled: list[int],
                            out: dict) -> dict:
        """The round's one blocking host sync: last losses, edited modules
        and the post-pruning ranks, packed into one f32 tensor (the integers
        are small enough to ride exactly) and copied once."""
        met = out["metrics"]
        n_s = len(sampled)
        parts = [met["last_loss"].float()]
        if "edited" in met:
            parts.append(met["edited"].float())
        parts.append(out["ranks"].float())
        with self.telemetry.span("metrics_fetch", cat="fed", round=round_no):
            host = torch.cat(parts).cpu().numpy()
        losses = host[:n_s]
        edited = host[n_s:2 * n_s] if "edited" in met else None
        self.client_ranks = host[-len(self.client_ranks):].astype(np.int32)
        rec = {"round": round_no, "sampled": list(map(int, sampled)),
               "train_loss": float(np.mean(losses)),
               "edited_layers": [] if edited is None
               else [int(e) for e in edited]}
        self.history.append(rec)
        return rec

    def run_round(self) -> dict:
        """One communication round: one fused round call, one host sync."""
        t0 = time.perf_counter()
        with self.telemetry.span("round", cat="fed", round=self.server.round):
            sampled, batch_idx = self._build_round_inputs()
            out = self._enqueue_round(sampled, batch_idx)
            rec = self._fetch_round_record(self.server.round, sampled, out)
        self._h_round.observe(time.perf_counter() - t0)
        return rec

    def export_adapters(self) -> dict:
        """Personalized adapters for serving: ``{"client<k>": (CPU adapter
        tree padded to r_g, true rank r_k)}``, from one copy of the
        stacked state."""
        host = tree_map(lambda x: x.cpu(), self.stacked_lora)
        return {f"client{k}": (tree_map(lambda x, k=k: x[k], host),
                               int(self.client_ranks[k]))
                for k in range(self.fcfg.num_clients)}

    # ---------------------------------------------------------- evaluation
    def _eval_batch(self, data: dict, n: int = 64) -> dict:
        return {k: torch.from_numpy(np.asarray(v[:n])).to(self.device)
                for k, v in data.items() if k in _EVAL_KEYS}

    def evaluate_global(self, generate: bool = True, n: int = 32) -> dict:
        """Loss and accuracy of the global adapter on the first 64 global
        test rows and, with ``generate``, BLEU/RSUM of its greedy captions
        for the first ``n``."""
        m = self._dispatch("eval_loss", self._eval_loss, self.base_params,
                           self.server.global_lora,
                           self._eval_batch(self.global_test))
        out = {"loss": float(m["loss"]), "acc": float(m["acc"])}
        if generate:
            out.update(self.generation_scores(self.server.global_lora,
                                              self.global_test, n))
        return out

    def evaluate_personalized(self, generate: bool = True, n: int = 16,
                              loss_n: int = 64) -> dict:
        """Size-weighted average of every client's evaluation on its own
        adapter (paper Sec. 2.2), in one population-eval call: client k
        contributes ``min(loss_n, |shard_k|)`` loss rows and
        ``min(n, |shard_k|)`` generation rows; shorter shards are zero-padded
        (zero loss mask, padded generations sliced off before scoring)."""
        w = np.asarray([c.size for c in self.clients], np.float64)
        w = w / w.sum()
        shard_rows = [c.eval_data["tokens"].shape[0] for c in self.clients]
        rows = min(max(n, loss_n), max(shard_rows))
        keys = [k for k in _EVAL_KEYS
                if all(k in c.eval_data for c in self.clients)]
        partial = [k for k in _EVAL_KEYS if k not in keys
                   and any(k in c.eval_data for c in self.clients)]
        if partial:
            raise ValueError(f"eval batch keys {partial} present in only "
                             "some client shards")

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
        batch = {k: torch.from_numpy(np.stack(
            [_pad(c.eval_data[k]) for c in self.clients])).to(self.device)
            for k in keys}
        key = (rows, loss_n, n, cap_start, gen_len)
        fn = self._pop_eval_cache.get(key)
        if fn is None:
            fn = make_population_eval(
                self.mcfg, lora_scale=self.lora_scale, cap_start=cap_start,
                gen_len=gen_len, loss_rows=min(loss_n, rows),
                gen_rows=min(n, rows), generate=generate)
            self._pop_eval_cache[key] = fn
        res = self._dispatch("population_eval", fn, self.base_params,
                             self.stacked_lora, batch)
        fetched = {k: v.cpu().numpy() for k, v in res.items()}
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

    def generation_scores(self, lora, data: dict, n: int = 32) -> dict:
        """Greedy caption generation with ``lora`` (KV-cached) →
        Google-BLEU / ROUGE-LSum over the first ``n`` rows of ``data``."""
        tokens = np.asarray(data["tokens"][:n])
        labels = np.asarray(data["labels"][:n])
        loss_mask = np.asarray(data["loss_mask"][:n])
        cap_start, gen_len = _mask_decode_bounds(loss_mask)
        key = (tokens.shape[0], cap_start, gen_len)
        fn = self._gen_cache.get(key)
        if fn is None:
            fn = make_greedy_generate(self.mcfg, lora_scale=self.lora_scale,
                                      cap_start=cap_start, gen_len=gen_len)
            self._gen_cache[key] = fn
        image = (torch.from_numpy(np.asarray(data["image"][:n])).to(
            self.device) if "image" in data else None)
        toks = torch.from_numpy(tokens[:, :cap_start + 1]).to(self.device)
        gen = self._dispatch("generate", fn, self.base_params, lora, toks,
                             image)
        return _score_generated(gen.cpu().numpy(), labels, loss_mask)


__all__ = ["ClientState", "FederatedTrainer", "ServerState"]
