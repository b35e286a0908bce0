"""The port's ``AdapterStore`` against the JAX package's on the CPU: one
register / acquire / release sequence through both stores, paging in,
evicting the least recently used tenant, refusing to evict pinned ones and
dropping a hot copy that a re-registration overwrites.  After every step
the two stores agree on ``len``, ``resident_ids`` (in slot order), the
slot each acquire returns, the page-in and eviction counts, and the bank
rows (``stack``, slot-major) of every resident tenant, bit for bit."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import AdapterStore as JStore  # noqa: E402
from repro_torch.core.paging import AllSlotsPinnedError  # noqa: E402
from repro_torch.serving import AdapterStore  # noqa: E402

SPECS = {"s0.attn.wq": (24, 24), "s0.attn.wv": (24, 8),
         "s1.cross.wv": (12, 8)}
L, R_PAD = 2, 8


def _adapter(seed: int, rank: int) -> dict:
    """An unpadded rank-``rank`` adapter (the store pads it to R_PAD)."""
    rng = np.random.default_rng(seed)
    return {n: {"A": rng.standard_normal((L, rank, i)).astype(np.float32),
                "B": rng.standard_normal((L, o, rank)).astype(np.float32)}
            for n, (i, o) in SPECS.items()}


def _held(js: JStore, ts: AdapterStore) -> None:
    assert len(ts) == len(js)
    assert ts.resident_ids == js.resident_ids
    assert (ts.loads, ts.evictions) == (js.loads, js.evictions)
    if not js.resident_ids:
        return
    jbank, tbank = jax.device_get(js.stack), ts.stack
    assert set(tbank) == set(SPECS)
    for aid in js.resident_ids:
        slot = js._pager.lookup(aid)
        assert ts._pager.lookup(aid) == slot
        for n in SPECS:
            for p in ("A", "B"):
                got = tbank[n][p][slot]
                assert got.shape == jbank[n][p][slot].shape
                np.testing.assert_array_equal(got.numpy(), jbank[n][p][slot])


def test_resident_set_and_bank_rows_match_reference():
    js = JStore(slots=3, rank=R_PAD)
    ts = AdapterStore(slots=3, rank=R_PAD, device="cpu")
    ranks = {f"a{i}": r for i, r in enumerate((2, 4, 8, 4, 6))}

    def both(fn):
        out = [fn(js), fn(ts)]
        _held(js, ts)
        return out

    for i, (aid, r) in enumerate(ranks.items()):
        both(lambda s: s.register(aid, _adapter(i, r), r))
    assert len(ts) == 5 and ts.resident_ids == []

    def cycle(aid):                  # acquire, check the slot, release
        sj, st = both(lambda s: s.acquire(aid))
        assert sj == st
        both(lambda s: s.release(aid))
        return st

    cycle("a0")
    cycle("a1")
    cycle("a2")
    assert ts.evictions == 0 and ts.loads == 3
    cycle("a3")                      # full bank: evicts the LRU, a0
    assert "a0" not in ts.resident_ids and ts.stack["s0.attn.wq"][
        "A"].shape == (3, L, R_PAD, 24)
    cycle("a0")                      # a0 back in, a1 out
    assert ts.evictions == 2
    assert ts.resident_ids == js.resident_ids and "a1" not in ts.resident_ids
    cycle("a2")                      # a hit: no page-in
    assert ts.loads == 5

    # pin every slot: a cold acquire is refused by both
    for aid in list(ts.resident_ids):
        both(lambda s: s.acquire(aid))
    with pytest.raises(RuntimeError, match="pinned"):
        js.acquire("a4")
    with pytest.raises(AllSlotsPinnedError):
        ts.acquire("a4")
    _held(js, ts)
    pinned = list(ts.resident_ids)
    both(lambda s: s.release(pinned[1]))
    sj, st = both(lambda s: s.acquire("a4"))       # evicts the unpinned one
    assert sj == st and pinned[1] not in ts.resident_ids
    for aid in list(ts.resident_ids):
        both(lambda s: s.release(aid))

    # a cold overwrite of a hot tenant drops its bank copy; the next
    # acquire pages the new rows in
    victim = ts.resident_ids[0]
    both(lambda s: s.register(victim, _adapter(9, 3), 3))
    assert victim not in ts.resident_ids and len(ts) == 5
    cycle(victim)
    assert ts.ranks == js.ranks
