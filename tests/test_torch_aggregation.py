"""The port's aggregation against the JAX package on the CPU: every
``AGGREGATORS`` entry on the same random stacked client adapters
(heterogeneous ranks, a zero-weight client, the zero-survivor
``fallback``), and the ``dim_agg`` kernels' plain versions against the
Pallas kernels in interpret mode.  Inputs are made with numpy from a seed.

Tolerance: atol = rtol = 1e-5 in f32 (the same sums in another order).
The trimmed mean's kept set is held exactly: on inputs full of duplicate
values with distinct client weights, any other kept set moves the result
by far more than the tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as JAG  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.core import aggregation as TAG  # noqa: E402
from repro_torch.kernels import dim_agg as DK  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
R_G = 8
RANKS = np.array([2, 8, 4, 8, 3], np.int32)
SPECS = {"s0.attn.wq": (16, 12), "s0.attn.wv": (16, 6)}   # in, out
L = 2


def _stacked(seed):
    """Random stacked adapters [K, ...], rank-masked like client state."""
    rng = np.random.default_rng(seed)
    K = len(RANKS)
    mask = (np.arange(R_G)[None, :] < RANKS[:, None]).astype(np.float32)
    out = {}
    for name, (n_in, n_out) in SPECS.items():
        a = rng.standard_normal((K, L, R_G, n_in)).astype(np.float32)
        b = rng.standard_normal((K, L, n_out, R_G)).astype(np.float32)
        out[name] = {"A": a * mask[:, None, :, None],
                     "B": b * mask[:, None, None, :]}
    return out


def _anchor(seed):
    rng = np.random.default_rng(seed)
    return {name: {"A": rng.standard_normal((L, R_G, n_in)).astype(np.float32),
                   "B": rng.standard_normal((L, n_out, R_G)).astype(np.float32)}
            for name, (n_in, n_out) in SPECS.items()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(port, ref, **tol):
    ref = jax.device_get(ref)
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _close(port[k], ref[k], **tol)
        return
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


P_CASES = {
    "weighted": np.array([0.1, 0.3, 0.2, 0.25, 0.15], np.float32),
    "zero_row": np.array([0.4, 0.0, 0.2, 0.25, 0.15], np.float32),
}


@pytest.mark.parametrize("name", sorted(TAG.AGGREGATORS))
@pytest.mark.parametrize("pcase", sorted(P_CASES))
def test_registry_entry_matches_reference(name, pcase):
    assert sorted(TAG.AGGREGATORS) == sorted(JAG.AGGREGATORS)
    stacked = _stacked(1)
    p = P_CASES[pcase]
    anchor, fallback = _anchor(2), _anchor(3)
    staleness = np.array([0, 2, 1, 0, 3], np.float32)
    kw = dict(hetlora_beta=0.7, lora_scale=2.0, staleness=staleness,
              anchor=anchor, staleness_decay=0.5, clip=2.5, trim=0.25,
              fallback=fallback)
    jg, jd = JAG.aggregate(name, _jax(stacked), jnp.asarray(RANKS),
                           jnp.asarray(p), **{
                               k: (_jax(v) if isinstance(v, (dict, np.ndarray))
                                   else v) for k, v in kw.items()})
    tg, td = TAG.aggregate(name, _torch(stacked), torch.from_numpy(RANKS),
                           torch.from_numpy(p), **{
                               k: (_torch(v) if isinstance(v, (dict, np.ndarray))
                                   else v) for k, v in kw.items()})
    assert (jg is None) == (tg is None) and (jd is None) == (td is None)
    if jg is not None:
        _close(tg, jg)
    if jd is not None:
        _close(td, jd)


@pytest.mark.parametrize("name", [n for n in sorted(TAG.AGGREGATORS)
                                  if n != "flora"])
def test_zero_survivors_fall_back_to_previous_global(name):
    """An all-zero cohort weight returns ``fallback`` exactly, as the
    reference does."""
    stacked = _stacked(4)
    p = np.zeros(len(RANKS), np.float32)
    fallback = _anchor(5)
    kw = dict(clip=1.0, trim=0.25)
    jg, _ = JAG.aggregate(name, _jax(stacked), jnp.asarray(RANKS),
                          jnp.asarray(p), fallback=_jax(fallback), **kw)
    tg, _ = TAG.aggregate(name, _torch(stacked), torch.from_numpy(RANKS),
                          torch.from_numpy(p), fallback=_torch(fallback), **kw)
    _close(tg, fallback, atol=0, rtol=0)
    _close(tg, jg, atol=0, rtol=0)


def test_kernel_entries_equal_their_plain_entries():
    stacked = _torch(_stacked(6))
    ranks, p = torch.from_numpy(RANKS), torch.from_numpy(P_CASES["weighted"])
    for name, kw in [("fedilora", {}), ("fedbuff", dict(
            staleness=torch.tensor([0., 1., 2., 0., 1.]),
            anchor=_torch(_anchor(7)))),
            ("fedilora_clip", dict(clip=3.0, anchor=_torch(_anchor(7)))),
            ("fedilora_trimmed", dict(trim=0.3))]:
        plain, _ = TAG.aggregate(name, stacked, ranks, p, **kw)
        kern, _ = TAG.aggregate(name + "_kernel", stacked, ranks, p, **kw)
        for n in plain:
            for m in ("A", "B"):
                torch.testing.assert_close(kern[n][m], plain[n][m], **TOL)


def test_helpers_match_reference():
    stacked = _stacked(8)
    p = P_CASES["zero_row"]
    jr, jp = jnp.asarray(RANKS), jnp.asarray(p)
    tr, tp = torch.from_numpy(RANKS), torch.from_numpy(p)
    np.testing.assert_allclose(
        TAG.dimension_wise_weights(tr, tp, R_G).numpy(),
        np.asarray(JAG.dimension_wise_weights(jr, jp, R_G)), **TOL)
    np.testing.assert_allclose(
        TAG.client_update_norms(_torch(stacked)).numpy(),
        np.asarray(JAG.client_update_norms(_jax(stacked))), **TOL)
    cover = (np.arange(R_G)[None, :] < RANKS[:, None]).astype(np.float32)
    for trim in (0.1, 0.25, 0.5):
        np.testing.assert_array_equal(
            TAG.trimmed_dimension_counts(torch.from_numpy(cover),
                                         trim).numpy(),
            np.asarray(JAG.trimmed_dimension_counts(jnp.asarray(cover),
                                                    trim)))
    np.testing.assert_allclose(
        TAG.staleness_discount(torch.tensor([0., 1., 4.]), 0.5).numpy(),
        np.asarray(JAG.staleness_discount(jnp.asarray([0., 1., 4.]), 0.5)),
        **TOL)
    for gamma in (0.5, 0.9, 0.99):
        for name in SPECS:
            for k, rank in enumerate(RANKS):
                entry = {m: stacked[name][m][k] for m in ("A", "B")}
                assert int(TAG.hetlora_self_prune(
                    _torch(entry), int(rank), R_G, gamma)) == int(
                    JAG.hetlora_self_prune(_jax(entry), int(rank), R_G, gamma))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 3, 8, 40), (10, 2, 32, 256),
                                   (3, 1, 5, 7)])
@pytest.mark.parametrize("scaled", [False, True])
def test_dim_agg_plain_matches_pallas(shape, scaled):
    K, Lx, r, n = shape
    rng = np.random.default_rng(9)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.random((K, r)).astype(np.float32)
    s = rng.random(K).astype(np.float32) if scaled else None
    ref = JOPS.dimension_wise_aggregate(
        jnp.asarray(x), jnp.asarray(w), None if s is None else jnp.asarray(s),
        interpret=True)
    oracle = JREF.dim_agg_ref(jnp.asarray(x), jnp.asarray(
        w if s is None else w * s[:, None]))
    sx = None if s is None else torch.from_numpy(s)
    port_a = DK.dimension_wise_aggregate(torch.from_numpy(x),
                                         torch.from_numpy(w), sx)
    # the B layout: the same reduction over the last axis, no transpose
    port_b = DK.dimension_wise_aggregate(
        torch.from_numpy(np.ascontiguousarray(x.swapaxes(-1, -2))),
        torch.from_numpy(w), sx, rank_axis=3)
    np.testing.assert_allclose(port_a.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(port_a.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(port_b.numpy().swapaxes(-1, -2),
                               np.asarray(ref), **TOL)
    assert DK.launches == {"dim_agg": 0, "dim_agg_trimmed": 0}


@pytest.mark.parametrize("shape,trim", [((5, 2, 8, 40), 0.25),
                                        ((9, 1, 4, 130), 0.34),
                                        ((4, 3, 6, 16), 0.5)])
def test_dim_agg_trimmed_plain_matches_pallas_with_duplicates(shape, trim):
    """Values drawn from {-2..2}: most comparisons are ties, settled by
    client index.  Distinct weights p make every kept set give its own
    mean, so agreement at 1e-5 means the same kept set."""
    K, Lx, r, n = shape
    rng = np.random.default_rng(10)
    x = rng.integers(-2, 3, shape).astype(np.float32)
    p = (rng.permutation(K) + 1).astype(np.float32)
    p /= p.sum()
    cover = (rng.random((K, r)) < 0.8).astype(np.float32)
    m = cover.sum(0)
    t = np.maximum(np.minimum(np.floor(trim * m), np.floor((m - 1) / 2)),
                   0).astype(np.float32)
    args = [jnp.asarray(v) for v in (x, p, cover, t)]
    ref = JOPS.dimension_wise_trimmed(*args, interpret=True)
    oracle = JREF.dim_agg_trimmed_ref(*args)
    targs = [torch.from_numpy(v) for v in (p, cover, t)]
    port_a = DK.dimension_wise_trimmed(torch.from_numpy(x), *targs)
    port_b = DK.dimension_wise_trimmed(
        torch.from_numpy(np.ascontiguousarray(x.swapaxes(-1, -2))), *targs,
        rank_axis=3)
    np.testing.assert_allclose(port_a.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(port_a.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(port_b.numpy().swapaxes(-1, -2),
                               np.asarray(ref), **TOL)
    # the registry's own trimmed mean (the reference algorithm) agrees too
    np.testing.assert_allclose(
        TAG._trimmed_merge(torch.from_numpy(x), *targs).numpy(),
        np.asarray(ref), **TOL)


def test_cuda_operands_are_validated_before_any_launch():
    """The kernel entry refuses CPU tensors instead of computing anything:
    there is no silent fallback from the CUDA path."""
    x = torch.zeros(2, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        DK.dim_agg_cuda(x, torch.ones(2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        DK.dim_agg_trimmed_cuda(x, torch.ones(2), torch.ones(2, 4),
                                torch.zeros(4))
    with pytest.raises(ValueError, match="rank_axis"):
        DK.dimension_wise_aggregate(x, torch.ones(2, 4), rank_axis=1)
