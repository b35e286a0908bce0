"""The port's partition rules (``repro_torch/sharding.py``) against the JAX
package's (``repro/sharding.py``) on the reference's stand-in meshes
(``tests/test_sharding.py``): every rule, on every leaf of every
architecture's parameters, adapters and decode caches, in every mode, on
every mesh — equal exactly, the port's spec as a tuple against the
reference's ``PartitionSpec``; then ``cohort_pad``, ``round_mesh_axes``
and ``shard_local``, which has no counterpart (a rank's contiguous
piece)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import sharding as JS  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.launch.fedround import cohort_pad as j_cohort_pad  # noqa: E402
from repro.launch.specs import (abstract_cache, abstract_lora,  # noqa: E402
                                abstract_params)
from repro_torch import sharding as TS  # noqa: E402
from repro_torch.launch.fedround import cohort_pad  # noqa: E402


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """The mesh surface the rules read (``tests/test_sharding.py:24``)."""

    axes: tuple            # ((name, size), ...)

    @property
    def shape(self):
        return dict(self.axes)

    @property
    def axis_names(self):
        return tuple(n for n, _ in self.axes)

    def coord(self, axis):                 # shard_local's rank coordinates
        return dict(self.at)[axis]

    at: tuple = ()


MESHES = [FakeMesh((("data", 16), ("model", 16))),
          FakeMesh((("pod", 2), ("data", 16), ("model", 16))),
          FakeMesh((("clients", 4),)),
          FakeMesh((("client", 4), ("model", 2))),
          FakeMesh((("data", 2),)),
          FakeMesh((("data", 2), ("model", 2))),
          FakeMesh((("data", 4), ("model", 8))),
          FakeMesh((("client", 1), ("model", 1)))]


def _leaves(tree):
    return [(JS._path_names(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree)]


def _same(port, ref, what):
    assert isinstance(port, TS.P), what
    assert port == ref and ref == port, (what, port, ref)
    assert tuple(port) == tuple(ref), (what, port, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_match_reference(arch):
    cfg = get_config(arch)
    params = _leaves(abstract_params(cfg))
    lora = _leaves(abstract_lora(cfg, 16))
    for mesh in MESHES:
        for mode in ("baseline", "ep"):
            for path, shape in params:
                for name in ("param_spec", "param_spec_tp"):
                    _same(getattr(TS, name)(path, shape, mesh, mode),
                          getattr(JS, name)(path, shape, mesh, mode),
                          (arch, mesh, mode, name, path, shape))
            for path, shape in lora:
                _same(TS.lora_spec(path, shape, mesh, mode),
                      JS.lora_spec(path, shape, mesh, mode),
                      (arch, mesh, mode, path))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_rules_match_reference(arch):
    cfg = get_config(arch)
    for batch, max_len in ((32, 256), (1, 4096), (6, 64)):
        cache = _leaves(abstract_cache(cfg, abstract_params(cfg), batch,
                                       max_len))
        for mesh in MESHES:
            for mode in ("baseline", "seq"):
                for path, shape in cache:
                    _same(TS.cache_spec(path, shape, mesh, mode),
                          JS.cache_spec(path, shape, mesh, mode),
                          (arch, mesh, mode, path, shape))
            for shape in ((batch, max_len), (batch,), (batch, 3, max_len)):
                seq = 1 if len(shape) > 1 else None
                if seq is not None and "data" not in mesh.axis_names:
                    seq = None       # the reference reads mesh.shape["data"]
                _same(TS.batch_spec(shape, mesh, seq_axis=seq),
                      JS.batch_spec(shape, mesh, seq_axis=seq),
                      (arch, mesh, shape))


def test_fit_spec_and_helpers_match_reference():
    shapes = [(32, 48), (30, 48), (32, 50), (64, 8), (48, 8), (4, 32, 48),
              (32,), (1, 2, 3)]
    specs = [("data", "model"), (("pod", "data"), None), ("model",),
             (None, "model"), ("clients",), (("pod", "missing"), None),
             (None, None, "data"), ()]
    for mesh in MESHES:
        for shape in shapes:
            for spec in specs:
                _same(TS.fit_spec(mesh, shape, spec),
                      JS.fit_spec(mesh, shape, JP(*spec)),
                      (mesh, shape, spec))
        assert TS.batch_axes(mesh) == JS.batch_axes(mesh)
        try:
            want = JS.round_mesh_axes(mesh)
        except ValueError:
            with pytest.raises(ValueError, match="round mesh"):
                TS.round_mesh_axes(mesh)
            continue
        assert TS.round_mesh_axes(mesh) == want
        for n in range(1, 10):
            assert cohort_pad(n, mesh) == j_cohort_pad(n, mesh), (mesh, n)
    assert cohort_pad(5, None) == j_cohort_pad(5, None) == 5


def test_shard_local_takes_the_rank_block():
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    pieces = {}
    for d in range(2):
        for m in range(2):
            mesh = FakeMesh((("data", 2), ("model", 2)),
                            at=(("data", d), ("model", m)))
            got = TS.shard_local(x, TS.P("data", None, "model"), mesh)
            assert got.is_contiguous()
            assert torch.equal(got, x[2 * d:2 * d + 2, :, 4 * m:4 * m + 4])
            pieces[d, m] = TS.shard_local(
                x, TS.P(None, None, ("data", "model")), mesh)
    # a tuple axis: row-major over its names, the first outermost
    whole = torch.cat([pieces[d, m] for d in range(2) for m in range(2)], 2)
    assert torch.equal(whole, x)
    assert torch.equal(TS.shard_local(x, TS.P(), mesh), x)
    np.testing.assert_array_equal(
        TS.shard_local(x, TS.P(None, "model"), mesh).numpy(), x[:, 3:].numpy())
