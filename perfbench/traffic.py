"""Traffic built from ``--seed``: arrival times, lengths and tenants.

The arrival processes follow ``benchmarks/load.py`` (open loop; Poisson
gaps, or Poisson-spaced bursts of simultaneous arrivals at the same mean
rate), plus a backlog that is all due at t = 0.  Every draw here is
*stratified*: a mix of ``n`` values is the distribution's quantiles at
``(i + 0.5) / n``, put in an order drawn from the seed.  So every seed
offers the same set of sizes, gaps and tenants, in another order, and the
spread from seed to seed is that of the order alone.

Everything is plain numpy.  A mix is a dict read from a workload file:

    {"arrivals": "poisson" | "bursty" | "backlog", "rate": req/s,
     "burst": n, "requests": n (backlog) ,
     "prompt": {"dist": "lognormal", "median": m, "sigma": s,
                "min": a, "max": b}
             | {"dist": "uniform", "min": a, "max": b},
     "gen": {...}, "tenants": n, "zipf": s}
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: dict, n: int, rng: np.random.Generator
                      ) -> np.ndarray:
    """``n`` whole lengths, lognormal with median ``spec["median"]`` and
    log-scale ``spec["sigma"]``, clipped to ``[min, max]``, stratified."""
    inv = NormalDist().inv_cdf
    z = np.array([inv(q) for q in _quantiles(n)])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    x = np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    return x[rng.permutation(n)]


def uniform_lengths(spec: dict, n: int, rng: np.random.Generator
                    ) -> np.ndarray:
    """``n`` whole lengths, uniform over ``[min, max]``, stratified."""
    lo, hi = int(spec["min"]), int(spec["max"])
    x = lo + np.floor(_quantiles(n) * (hi - lo + 1)).astype(np.int64)
    return x[rng.permutation(n)]


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths drawn by ``spec["dist"]`` (``lognormal`` if absent)."""
    dist = spec.get("dist", "lognormal")
    if dist == "lognormal":
        return lognormal_lengths(spec, n, rng)
    if dist == "uniform":
        return uniform_lengths(spec, n, rng)
    raise ValueError(f"unknown length distribution {dist!r}")


def zipf_tenants(n_tenants: int, s: float, n: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Tenant ids of ``n`` requests: tenant ``t`` (0 the most popular)
    with probability ∝ (t + 1)^-s, the counts fixed by largest remainders
    and the order drawn from the seed."""
    p = (np.arange(1, n_tenants + 1, dtype=np.float64)) ** -s
    p /= p.sum()
    exact = p * n
    counts = np.floor(exact).astype(np.int64)
    rest = n - counts.sum()
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    ids = np.repeat(np.arange(n_tenants), counts)
    return ids[rng.permutation(n)]


def arrival_offsets(mix: dict, seconds: float, rng: np.random.Generator
                    ) -> np.ndarray:
    """Due times (seconds from the window's start), sorted, all inside
    ``(0, seconds)``.  ``poisson``: ``round(rate · seconds)`` requests with
    stratified exponential gaps; ``bursty``: bursts of ``burst`` at the
    same mean rate; ``backlog``: ``requests`` all due at 0."""
    kind = mix["arrivals"]
    if kind == "backlog":
        return np.zeros(int(mix["requests"]))
    rate = float(mix["rate"])
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    burst = int(mix.get("burst", 1)) if kind == "bursty" else 1
    if kind not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrivals {kind!r}")
    n_events = max(int(round(rate * seconds / burst)), 1)
    gaps = -np.log1p(-_quantiles(n_events)) * burst / rate
    starts = np.cumsum(gaps[rng.permutation(n_events)])
    # the last arrival (the sum of every gap, whatever their order) falls
    # just inside the window
    starts *= seconds * (1 - 0.5 / n_events) / starts[-1]
    return np.repeat(starts, burst)


def requests(mix: dict, seconds: float, seed: int) -> dict:
    """The whole mix of one run: ``due`` [n] seconds, ``prompt`` [n] and
    ``gen`` [n] lengths, ``tenant`` [n] ids, each from its own stream of
    the seed."""
    ss = np.random.SeedSequence(seed)
    r_due, r_p, r_g, r_t = (np.random.default_rng(s) for s in ss.spawn(4))
    due = arrival_offsets(mix, seconds, r_due)
    n = due.shape[0]
    return {"due": due,
            "prompt": lengths(mix["prompt"], n, r_p),
            "gen": lengths(mix["gen"], n, r_g),
            "tenant": zipf_tenants(int(mix["tenants"]),
                                   float(mix.get("zipf", 0.0)), n, r_t)}
