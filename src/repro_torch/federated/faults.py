"""Deterministic client-fault injection for federated rounds (copy of
``repro/federated/faults.py``; numpy only).

Real federations are hostile: clients crash mid-round (dropout), miss the
round deadline (stragglers), or return corrupted updates (NaN/Inf deltas,
scaled outliers, sign-flipped "Byzantine" adapters — Koo et al. 2410.22815).
This module decides *which* faults happen; the fused round
(``repro_torch.launch.fedround``) absorbs them on the device, so a faulted
round is still one call of the fused round and one host fetch.

Determinism contract: every draw is a stateless function of
``(cfg.seed, round_idx, client_id)`` — no mutable RNG stream.  The schedule
therefore produces identical faults under paged and resident client state,
under any sampling order, and across checkpoint save/restore (the "RNG
position" is just the round counter, which the checkpoint already carries).

Host-side only (numpy); the round receives the draws as small per-cohort
f32 operand vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_CORRUPT_MODES = ("sign_flip", "scale", "nan", "inf")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round client fault model.  Disabled by default (zero faults)."""

    enabled: bool = False
    # P(a sampled client crashes mid-round): its trained update never arrives
    # and its local state stays at the pre-round value.
    dropout_rate: float = 0.0
    # P(a sampled client misses the round deadline).  Sync: forfeited from
    # the aggregation (weight renormalised over survivors) but its local
    # state still advances — it finished training, just too late to merge.
    # Async: deferred ``straggler_ticks`` extra ticks into the fedbuff
    # buffer, arriving staler.
    straggler_rate: float = 0.0
    # Wall-clock deadline (seconds) against the measured ``client_step_ema``:
    # a measured client whose EMA exceeds it is forfeited/deferred exactly
    # like a drawn straggler.  0 → no deadline.
    round_deadline: float = 0.0
    straggler_ticks: int = 2
    # P(a surviving client's *transmitted* update is corrupted).  Corruption
    # is wire-level: the client's own stored adapter stays clean, only the
    # copy entering aggregation is damaged.
    corrupt_rate: float = 0.0
    corrupt_mode: str = "sign_flip"          # sign_flip | scale | nan | inf
    corrupt_scale: float = 100.0             # multiplier for mode "scale"
    # Persistent adversaries: these client ids sign-flip their update every
    # round they participate in (independent of ``corrupt_rate``).
    byzantine_clients: tuple = ()
    seed: int = 0

    def __post_init__(self):
        if self.corrupt_mode not in _CORRUPT_MODES:
            raise ValueError(
                f"corrupt_mode {self.corrupt_mode!r}; have {_CORRUPT_MODES}")

    @property
    def active(self) -> bool:
        return bool(self.enabled and (
            self.dropout_rate > 0 or self.straggler_rate > 0
            or self.round_deadline > 0 or self.corrupt_rate > 0
            or self.byzantine_clients))


def _corrupt_wire(mode: str, scale: float) -> tuple[float, float]:
    """(multiplier, additive) wire representation of one corruption: the
    engine computes ``agg_update = update * mult + add`` — add of NaN/Inf
    poisons every element, mult of -1/scale flips/inflates it."""
    if mode == "sign_flip":
        return -1.0, 0.0
    if mode == "scale":
        return float(scale), 0.0
    if mode == "nan":
        return 1.0, float("nan")
    return 1.0, float("inf")


class FaultSchedule:
    """Stateless per-(round, client) fault draws from a :class:`FaultConfig`.

    ``cohort(round_idx, cids, ...)`` returns the engine operand vectors for
    one sampled cohort; ``offline(round_idx)`` returns the clients drawn as
    dropped this round (for availability-aware sampling to route around).
    """

    def __init__(self, cfg: FaultConfig, num_clients: int):
        self.cfg = cfg
        self.num_clients = int(num_clients)
        self._byz = frozenset(int(c) for c in cfg.byzantine_clients)

    def _draws(self, round_idx: int, cid: int) -> np.ndarray:
        # one independent uniform triple per (seed, round, client) — order-
        # and state-free, so paged/resident/replayed timelines agree bitwise
        rng = np.random.default_rng(
            (0x5EED, int(self.cfg.seed), int(round_idx), int(cid)))
        return rng.random(3)

    def dropped(self, round_idx: int, cid: int) -> bool:
        if not self.cfg.active:
            return False
        return bool(self._draws(round_idx, cid)[0] < self.cfg.dropout_rate)

    def straggling(self, round_idx: int, cid: int,
                   step_ema: float | None = None) -> bool:
        if not self.cfg.active:
            return False
        if self._draws(round_idx, cid)[1] < self.cfg.straggler_rate:
            return True
        return bool(self.cfg.round_deadline > 0 and step_ema is not None
                    and step_ema > self.cfg.round_deadline)

    def corrupted(self, round_idx: int, cid: int) -> str | None:
        """Corruption mode applied to ``cid``'s update this round, or None."""
        if not self.cfg.active:
            return None
        if cid in self._byz:
            return "sign_flip"
        if self._draws(round_idx, cid)[2] < self.cfg.corrupt_rate:
            return self.cfg.corrupt_mode
        return None

    def offline(self, round_idx: int) -> frozenset:
        """Clients drawn as dropped this round over the whole population."""
        if not self.cfg.active or self.cfg.dropout_rate <= 0:
            return frozenset()
        return frozenset(c for c in range(self.num_clients)
                         if self.dropped(round_idx, c))

    def cohort(self, round_idx: int, cids, step_ema=None) -> dict:
        """Fault operands for one sampled cohort (numpy, host-side).

        Returns ``keep`` (0 = dropped), ``weight`` (0 = dropped OR
        forfeited — the aggregation-weight multiplier), ``scale``/``nan``
        (wire corruption: ``update*scale + nan``), ``extra_ticks`` (async
        straggler deferral) and host-side counts.
        """
        n = len(cids)
        keep = np.ones(n, np.float32)
        weight = np.ones(n, np.float32)
        scale = np.ones(n, np.float32)
        nanv = np.zeros(n, np.float32)
        ticks = np.zeros(n, np.int32)
        n_dropped = n_forfeited = n_corrupted = 0
        for i, cid in enumerate(cids):
            cid = int(cid)
            if self.dropped(round_idx, cid):
                keep[i] = 0.0
                weight[i] = 0.0
                n_dropped += 1
                continue
            ema = None
            if step_ema is not None:
                ema = float(step_ema[cid])
                if not np.isfinite(ema) or ema <= 0:
                    ema = None
            if self.straggling(round_idx, cid, ema):
                weight[i] = 0.0
                ticks[i] = self.cfg.straggler_ticks
                n_forfeited += 1
            mode = self.corrupted(round_idx, cid)
            if mode is not None:
                scale[i], nanv[i] = _corrupt_wire(mode, self.cfg.corrupt_scale)
                n_corrupted += 1
        return {"keep": keep, "weight": weight, "scale": scale, "nan": nanv,
                "extra_ticks": ticks, "n_dropped": n_dropped,
                "n_forfeited": n_forfeited, "n_corrupted": n_corrupted}

    @staticmethod
    def clean(n: int) -> dict:
        """Neutral operands (used to pad cohorts / for fault-free rounds of
        a fault-enabled trainer — the engine program is identical either
        way, only the operand values change)."""
        return {"keep": np.ones(n, np.float32),
                "weight": np.ones(n, np.float32),
                "scale": np.ones(n, np.float32),
                "nan": np.zeros(n, np.float32),
                "extra_ticks": np.zeros(n, np.int32),
                "n_dropped": 0, "n_forfeited": 0, "n_corrupted": 0}


__all__ = ["FaultConfig", "FaultSchedule"]
