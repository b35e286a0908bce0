"""Traffic from the seed: the same seed gives the same mix, another seed
another order of the same sizes, gaps and tenants."""

from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench.tests.checkout import DATA, ROOT
from perfbench import traffic

#: a real cell's mix, and a backlog (the toy cell's)
CELLS = ["serve.granite-h-small-10.steady", "serve.tiny-hybrid.batch"]


def _mix(cell):
    real = ROOT / "perfbench" / "workloads" / f"{cell}.json"
    path = real if real.exists() else DATA / "workloads" / f"{cell}.json"
    return json.loads(path.read_text())["traffic"]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_traffic(cell):
    a = traffic.requests(_mix(cell), 40.0, 2 ** 31 + 5)
    b = traffic.requests(_mix(cell), 40.0, 2 ** 31 + 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cell", CELLS)
def test_another_seed_reorders_the_same_mix(cell):
    a = traffic.requests(_mix(cell), 40.0, 2 ** 31 + 5)
    b = traffic.requests(_mix(cell), 40.0, 2 ** 31 + 6)
    assert any(not np.array_equal(a[k], b[k]) for k in ("prompt", "gen",
                                                         "tenant"))
    for k in ("prompt", "gen", "tenant"):
        np.testing.assert_array_equal(np.sort(a[k]), np.sort(b[k]))
    if a["due"].any():
        gaps = lambda d: np.sort(np.diff(np.concatenate([[0.0], d])))
        np.testing.assert_allclose(gaps(a["due"]), gaps(b["due"]),
                                   rtol=1e-9, atol=1e-12)


def test_arrivals_lie_in_the_window_at_the_rate():
    mix = _mix("serve.granite-h-small-10.steady")
    due = traffic.arrival_offsets(mix, 40.0, np.random.default_rng(1))
    assert due.shape[0] == round(mix["rate"] * 40.0)
    assert due[0] > 0.0 and due[-1] < 40.0 and np.all(np.diff(due) >= 0)
    bursty = dict(mix, arrivals="bursty", burst=8)
    due = traffic.arrival_offsets(bursty, 40.0, np.random.default_rng(1))
    assert due.shape[0] == 8 * round(mix["rate"] * 40.0 / 8)
    assert np.all(due.reshape(-1, 8) == due.reshape(-1, 8)[:, :1])


def test_backlog_is_all_due_at_once_and_lengths_keep_their_bounds():
    mix = _mix("serve.tiny-hybrid.batch")
    t = traffic.requests(mix, 40.0, 7)
    assert t["due"].shape[0] == mix["requests"] and not t["due"].any()
    for k in ("prompt", "gen"):
        assert t[k].min() >= mix[k]["min"] and t[k].max() <= mix[k]["max"]
        mid = mix[k].get("median", (mix[k]["min"] + mix[k]["max"]) / 2)
        assert abs(np.median(t[k]) - mid) <= 1
    assert set(t["tenant"]) == set(range(mix["tenants"]))


def test_uniform_lengths_cover_the_range_evenly():
    spec = {"dist": "uniform", "min": 8, "max": 512}
    x = traffic.lengths(spec, 505 * 3, np.random.default_rng(0))
    np.testing.assert_array_equal(np.bincount(x - 8), np.full(505, 3))
    with pytest.raises(ValueError):
        traffic.lengths(dict(spec, dist="pareto"), 4,
                        np.random.default_rng(0))


def test_zipf_counts_follow_the_law():
    ids = traffic.zipf_tenants(64, 1.0, 6400, np.random.default_rng(0))
    counts = np.bincount(ids, minlength=64)
    p = 1.0 / np.arange(1, 65)
    assert counts.sum() == 6400
    assert np.all(np.abs(counts - 6400 * p / p.sum()) < 1)
