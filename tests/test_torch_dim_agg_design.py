"""The design of the Hopper ``dim_agg`` kernels (``csrc/dim_agg.cu``), on
the CPU: what the kernels compute, written out in PyTorch, and the pure
Python that packs a tree's leaves into one launch.

* Pair counting.  ``dim_agg_trimmed`` counts each unordered pair of clients
  once, with one comparison (``x_j <= x_i``: lo_i += c_j, hi_j += c_i;
  else hi_i += c_j, lo_j += c_i), then sums ``keep·p·x`` over every client
  in order.  That arithmetic is held against the JAX package's oracle
  ``repro.kernels.ref.dim_agg_trimmed_ref`` and its Pallas kernel
  ``dim_agg_trimmed_pallas`` in interpret mode, on inputs full of ties
  (values from {-2..2}), with NaN and ±Inf in some clients and clients
  that cover nothing.  With ``le`` and ``gt`` taken apart the counts are
  the reference's ``lo``/``hi`` everywhere; with one comparison they are
  on every element without a NaN client, so the kept sets agree there,
  and an element with a NaN client is NaN in both whatever is kept.  The
  finite values agree within 1e-5.
* The leaf table.  Tiles numbered in leaf order, every output element of
  every leaf covered by exactly one thread of one tile on both routes,
  the vector/scalar route from pure inputs, the compiled client counts,
  and the launches a tree takes (one for the fedbench-100m round, more
  past ``MAX_LEAVES`` leaves)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dim_agg import dim_agg_trimmed_pallas  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.aggregation import dimension_wise_weights  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import dim_agg as DK  # noqa: E402
from repro_torch.models.transformer import lora_specs  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# dim_agg_trimmed: pair counting and the ordered sum
# ---------------------------------------------------------------------------

def _pair_counts(x, cover, *, one_compare=True):
    """Counts lo, hi [K, ...] over x [K, L, r, n] and cover [K, r], each
    unordered pair once.  The kernel takes one comparison a pair
    (``x_q <= x_i``, else the other way); with ``one_compare=False`` a NaN
    counts in neither direction (``le`` and ``gt`` apart), which is the
    reference's count exactly."""
    K = x.shape[0]
    c = [cover[k][None, :, None].expand_as(x[0]) for k in range(K)]
    lo = [torch.zeros_like(x[0]) for _ in range(K)]
    hi = [torch.zeros_like(x[0]) for _ in range(K)]
    for i in range(1, K):
        for q in range(i):
            le = x[q] <= x[i]
            gt = ~le if one_compare else x[q] > x[i]
            lo[i] = torch.where(le, lo[i] + c[q], lo[i])
            hi[q] = torch.where(le, hi[q] + c[i], hi[q])
            hi[i] = torch.where(gt, hi[i] + c[q], hi[i])
            lo[q] = torch.where(gt, lo[q] + c[i], lo[q])
    return torch.stack(lo), torch.stack(hi)


def _trimmed_emulated(x, p, cover, t):
    """The kernel's trimmed mean: the pair counts, then
    num += (keep·p_i)·x_i and den += keep·p_i over every client in order,
    the dropped ones included."""
    K = x.shape[0]
    lo, hi = _pair_counts(x, cover)
    td = t[None, :, None]
    num = torch.zeros_like(x[0])
    den = torch.zeros_like(x[0])
    keeps = []
    for i in range(K):
        keep = (cover[i][None, :, None] * (lo[i] >= td).float()
                * (hi[i] >= td).float())
        kp = keep * p[i]
        num = num + kp * x[i]
        den = den + kp
        keeps.append(keep)
    return num / torch.clamp(den, min=1e-12), torch.stack(keeps), lo, hi


def _reference_counts(x, cover):
    """lo, hi exactly as ``dim_agg.py:77-78`` writes them (numpy)."""
    K = x.shape[0]
    xi, xj = x[:, None], x[None, :]
    ki = np.arange(K)[:, None, None, None, None]
    kj = np.arange(K)[None, :, None, None, None]
    cj = cover[None, :, None, :, None]
    lo = np.sum(cj * ((xj < xi) | ((xj == xi) & (kj < ki))), axis=1)
    hi = np.sum(cj * ((xj > xi) | ((xj == xi) & (kj > ki))), axis=1)
    return lo.astype(np.float32), hi.astype(np.float32)


def _trimmed_inputs(K, seed, trim=0.25):
    """Ties from {-2..2}, NaN / +Inf / -Inf in some clients, a client that
    covers nothing, distinct client weights, the trim counts of ``trim``."""
    rng = np.random.default_rng(seed)
    Lx, r, n = 2, 8, 24
    x = rng.integers(-2, 3, (K, Lx, r, n)).astype(np.float32)
    if K >= 2:
        x[K - 1, 0, 1, :5] = np.nan
        x[0, 1, 2, 3:7] = np.inf
        x[K // 2, 0, 3, 10:12] = -np.inf
        x[1, 1, :, 20] = np.nan
    p = (rng.permutation(K) + 1).astype(np.float32)
    p /= p.sum()
    cover = (rng.random((K, r)) < 0.8).astype(np.float32)
    if K >= 3:
        cover[1] = 0.0
    m = cover.sum(0)
    t = np.maximum(np.minimum(np.floor(trim * m), np.floor((m - 1) / 2)),
                   0).astype(np.float32)
    return x, p, cover, t


def _same_nan_and_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("K", [1, 2, 3, 5, 10, 17, 32])
def test_pair_counting_matches_reference_and_pallas(K):
    x, p, cover, t = _trimmed_inputs(K, seed=40 + K)
    tx, tp, tc, tt = (torch.from_numpy(v) for v in (x, p, cover, t))
    got, keep, lo, hi = _trimmed_emulated(tx, tp, tc, tt)
    rlo, rhi = _reference_counts(x, cover)
    # le and gt apart: the reference's counts, term for term
    lo2, hi2 = _pair_counts(tx, tc, one_compare=False)
    np.testing.assert_array_equal(lo2.numpy(), rlo)
    np.testing.assert_array_equal(hi2.numpy(), rhi)
    # one comparison a pair: the same counts, so the same kept set, on
    # every element without a NaN client; an element with one is NaN
    # whatever is kept (0·NaN and 1·NaN are NaN)
    clean = ~np.isnan(x).any(0)[None]
    np.testing.assert_array_equal(np.where(clean, lo.numpy(), 0),
                                  np.where(clean, rlo, 0))
    np.testing.assert_array_equal(np.where(clean, hi.numpy(), 0),
                                  np.where(clean, rhi, 0))
    rkeep = (cover[:, None, :, None] * (rlo >= t[None, None, :, None])
             * (rhi >= t[None, None, :, None]))
    np.testing.assert_array_equal(np.where(clean, keep.numpy(), 0),
                                  np.where(clean, rkeep, 0))
    args = [jnp.asarray(v) for v in (x, p, cover, t)]
    want = np.asarray(jref.dim_agg_trimmed_ref(*args))
    np.testing.assert_array_equal(np.isnan(want), ~clean[0] | np.isnan(want))
    _same_nan_and_close(got.numpy(), want)
    _same_nan_and_close(got.numpy(),
                        dim_agg_trimmed_pallas(*args, interpret=True))
    # the port's plain version (what the CPU runs) agrees as well
    _same_nan_and_close(DK.plain_dim_agg_trimmed(tx, tp, tc, tt).numpy(),
                        want)


def test_nan_and_inf_are_where_the_reference_puts_them():
    """A NaN client counts in neither direction; a dropped NaN or Inf
    still reaches the sum as 0·NaN, so the element is NaN in both."""
    x, p, cover, t = _trimmed_inputs(10, seed=7, trim=0.34)
    got = _trimmed_emulated(*(torch.from_numpy(v)
                              for v in (x, p, cover, t)))[0].numpy()
    want = np.asarray(jref.dim_agg_trimmed_ref(
        *[jnp.asarray(v) for v in (x, p, cover, t)]))
    assert np.isnan(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ---------------------------------------------------------------------------
# the leaf table
# ---------------------------------------------------------------------------

def _kernel_elements(kind, n_out, tile, first, tiles, vec, threads=256):
    """Output elements each tile of a packed leaf writes, as the kernels
    index them: ``dim_agg`` 4 a thread (a float4 at 4t on the vector route,
    t + 256c on the scalar route), ``dim_agg_trimmed`` element t + 256j."""
    seen = np.zeros(n_out, np.int64)
    t = np.arange(threads)
    for b in range(first, first + tiles):
        base = (b - first) * tile
        if kind == "dim_agg":
            idx = [base + 4 * t + c if vec else base + t + threads * c
                   for c in range(4)]
        else:
            idx = [base + t + threads * j for j in range(tile // threads)]
        idx = np.concatenate(idx)
        np.add.at(seen, idx[idx < n_out], 1)
    return seen


def _leaf_of(table, b):
    """The kernel's ``leaf_of``: the last entry whose first tile is <= b."""
    i = 0
    while i + 1 < len(table) and table[i + 1][1] <= b:
        i += 1
    return i


@pytest.mark.parametrize("kind", ["dim_agg", "dim_agg_trimmed"])
def test_every_element_is_written_once(kind):
    tile = DK.DIM_AGG_TILE if kind == "dim_agg" else DK.TRIMMED_TILE
    n_outs = [294912, 0, 98304, 37, 1024, 2049, 1]
    launches = DK.pack_leaves(n_outs, tile)
    assert len(launches) == 1
    (table,) = launches
    assert [i for i, _, _ in table] == [0, 2, 3, 4, 5, 6]   # empty: no entry
    assert table[0][1] == 0
    for (_, first, tiles), nxt in zip(table, table[1:] + [None]):
        if nxt is not None:
            assert nxt[1] == first + tiles
    grid = table[-1][1] + table[-1][2]
    owner = [table[_leaf_of(table, b)][0] for b in range(grid)]
    for i, first, tiles in table:
        n = n_outs[i]
        assert tiles == -(-n // tile)
        assert owner[first:first + tiles] == [i] * tiles
        for vec in ((False, True) if n % 4 == 0 else (False,)):
            assert (_kernel_elements(kind, n, tile, first, tiles,
                                     vec) == 1).all()


def test_chunks_past_the_table_limit():
    n_outs = [4096] * (2 * DK.MAX_LEAVES + 3)
    launches = DK.pack_leaves(n_outs, DK.DIM_AGG_TILE)
    assert [len(t) for t in launches] == [DK.MAX_LEAVES, DK.MAX_LEAVES, 3]
    assert [e[0] for t in launches for e in t] == list(range(len(n_outs)))
    for t in launches:      # each launch numbers its own tiles from 0
        assert [e[1] for e in t] == [4 * j for j in range(len(t))]
    assert len(DK.pack_leaves(n_outs[:DK.MAX_LEAVES], 2048)) == 1
    assert len(DK.pack_leaves(n_outs[:DK.MAX_LEAVES + 1], 2048)) == 2
    assert DK.pack_leaves([0, 0], 2048) == []
    assert len(DK.pack_leaves([5, 6, 7], 4, max_leaves=1)) == 3


def test_round_tree_takes_one_launch():
    """fedbench-100m's round: 4 sampled clients, r_g 32, LoRA on wq and wv
    of 12 layers — four leaves, one launch of each kernel, 960 tiles of
    ``dim_agg`` for the 132 SMs."""
    K, r_g = 4, 32
    tree = {s.name: {"A": torch.empty(K, s.num_layers, r_g, s.in_dim),
                     "B": torch.empty(K, s.num_layers, s.out_dim, r_g)}
            for s in lora_specs(get_config("fedbench-100m"))}
    leaves = DK.tree_leaves(tree)
    assert [(tuple(x.shape), ax) for x, ax in leaves] == [
        ((4, 12, 32, 768), 2), ((4, 12, 768, 32), 3),
        ((4, 12, 32, 768), 2), ((4, 12, 256, 32), 3)]
    n_outs = [x[0].numel() for x, _ in leaves]
    (table,) = DK.pack_leaves(n_outs, DK.DIM_AGG_TILE)
    assert table[-1][1] + table[-1][2] == 960
    (trimmed,) = DK.pack_leaves(n_outs, DK.TRIMMED_TILE)
    assert trimmed[-1][1] + trimmed[-1][2] == 3840
    # every leaf of the round reads 16-byte vectors
    assert {DK.dim_agg_route(x.shape[3], True) for x, _ in leaves} == {
        "vector"}


@pytest.mark.parametrize("Q,aligned,route", [
    (768, True, "vector"), (32, True, "vector"), (4, True, "vector"),
    (37, True, "scalar"), (6, True, "scalar"), (768, False, "scalar")])
def test_route_from_pure_inputs(Q, aligned, route):
    assert DK.dim_agg_route(Q, aligned) == route


def test_offset_view_of_a_leaf_takes_the_scalar_route():
    leaf = torch.zeros(4, 2, 8, 40)
    buf = torch.zeros(leaf.numel() + 1)
    view = buf[1:].view(leaf.shape)
    assert view.is_contiguous()
    assert DK.dim_agg_route(view.shape[3], kbuild.aligned16(view)) == "scalar"
    assert DK.dim_agg_route(leaf.shape[3], kbuild.aligned16(leaf)) == "vector"


def test_leaf_entry_mirrors_the_kernel_struct():
    """``DimAggLeaf`` in csrc/dim_agg.cu: two pointers, n_out as 64 bits,
    six ints — 48 bytes, in that order."""
    import ctypes

    assert ctypes.sizeof(DK._Leaf) == 48
    assert [f for f, _ in DK._Leaf._fields_] == [
        "x", "out", "n_out", "P", "Q", "rank_axis", "vec", "tile0", "tiles"]
    src = (kbuild.CSRC / "dim_agg.cu").read_text()
    body = src[src.index("struct DimAggLeaf {"):src.index("};")]
    names = [n for line in body.splitlines()[1:]
             for n in re.findall(r"(\w+)(?=\s*[,;])", line.split("//")[0])]
    assert names == [f for f, _ in DK._Leaf._fields_]


def test_cpu_tree_functions_launch_nothing():
    """On the CPU a tree function computes the plain version per leaf and
    counts no launch on any route or instance."""
    rng = np.random.default_rng(3)
    K, r_g = 4, 8
    tree = {"s0.attn.wq": {
        "A": torch.from_numpy(rng.standard_normal((K, 2, r_g, 12))
                              .astype(np.float32)),
        "B": torch.from_numpy(rng.standard_normal((K, 2, 10, r_g))
                              .astype(np.float32))}}
    ranks = torch.tensor([2, 8, 4, 8])
    p = torch.tensor([0.1, 0.4, 0.2, 0.3])
    DK.reset_launches()
    out = DK.fedilora_aggregate_tree(tree, ranks, p)
    DK.fedbuff_aggregate_tree(tree, ranks, p, torch.tensor([0., 1., 2., 0.]))
    DK.fedilora_trimmed_tree(tree, ranks, p, 0.25)
    assert DK.launches == {"dim_agg": 0, "dim_agg_trimmed": 0}
    assert DK.leaves_by_route == {"vector": 0, "scalar": 0}
    assert DK.launches_by_clients == {}
    w = dimension_wise_weights(ranks, p, r_g)
    torch.testing.assert_close(out["s0.attn.wq"]["B"], DK.plain_dim_agg(
        tree["s0.attn.wq"]["B"], w, rank_axis=3), atol=0, rtol=0)
