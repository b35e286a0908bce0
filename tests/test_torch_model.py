"""The port's decode stack against the JAX package on the CPU: weights
carried across by ``repro_torch.interop``, then ``decode_chunk`` on the
same params, adapter bank, cache contents and positions.  Tolerances: C=1
logits atol 1e-4 (f32, 2-4 layers, different summation order); caches
after a ragged C=4 chunk atol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_pytree  # noqa: E402
from repro.configs import get_reduced_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.interop import (adapters_from_numpy,  # noqa: E402
                                 params_from_numpy, to_torch)
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["fedbench-tiny", "qwen2-0.5b", "gemma3-12b"]


def _numpy_params(name, seed=0):
    """Reference init, with nonzero biases so the QKV-bias path counts."""
    cfg = get_reduced_config(name)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.startswith("b"):
                t[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    perturb(tree)
    return cfg, tree


def _bank(cfg, G, r, seed):
    """Scan-major bank {spec: {"A": [L, G, r, in], "B": [L, G, out, r]}}."""
    rng = np.random.default_rng(seed)
    return {s.name: {
        "A": (0.2 * rng.standard_normal((s.num_layers, G, r, s.in_dim))
              ).astype(np.float32),
        "B": (0.2 * rng.standard_normal((s.num_layers, G, s.out_dim, r))
              ).astype(np.float32)} for s in JT.lora_specs(cfg)}


def _cache(cfg, B, max_len, seed):
    rng = np.random.default_rng(seed)
    proto = jax.device_get(JT.init_cache(cfg, None, B, max_len))
    return {k: {p: rng.standard_normal(x.shape).astype(np.float32)
                for p, x in v.items()} for k, v in proto.items()}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_port(tree):
    return {k: _to_port(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_converter_round_trip(name, tmp_path):
    """Reference tree → port tensors → numpy is bit-exact, for in-memory
    trees, bf16 leaves and ``save_pytree`` files read by the port's
    numpy-only ``load_pytree``."""
    cfg, tree = _numpy_params(name)
    port = params_from_numpy(t_reduced(name), tree, device="cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_ref:
        node = port
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    path = str(tmp_path / "params.npz")
    save_pytree(path, tree)
    loaded = load_pytree(path)
    again = params_from_numpy(t_reduced(name), loaded, device="cpu")
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(port),
                              jax.tree_util.tree_leaves_with_path(again)):
        assert torch.equal(a, b)
    bf = np.asarray(jnp.asarray(tree["embed"], jnp.bfloat16))
    got = to_torch(bf)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), bf.astype(np.float32))
    ad = adapters_from_numpy({"s0.attn.wq": {"A": tree["final_ln"][None],
                                             "B": tree["final_ln"][:, None]}})
    assert ad["s0.attn.wq"]["A"].shape == (1, cfg.d_model)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("lora_kernel", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_chunk_matches_reference(name, lora_kernel, chunked):
    cfg, tree = _numpy_params(name, seed=1)
    tcfg = t_reduced(name)
    B, G, r, max_len = 3, 4, 8, 24
    bank = _bank(cfg, G, r, seed=2)
    cache = _cache(cfg, B, max_len, seed=3)
    rng = np.random.default_rng(4)
    idx = np.array([2, 0, 2], np.int32)
    jp, tp = _to_jax(tree), params_from_numpy(tcfg, tree, device="cpu")
    jbank = _to_jax(bank)
    tbank = {k: {p: torch.from_numpy(x) for p, x in v.items()}
             for k, v in bank.items()}
    kw = dict(lora_scale=0.5, lora_kernel=lora_kernel, chunked=chunked)

    # ---- C = 1: one-token decode at ragged per-row positions (past the
    # ring size for the local layers of gemma3, so the ring wraps)
    pos = np.array([3, 17, 22], np.int32)
    emb = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jl, jc = JT.decode_chunk(cfg, jp, _to_jax(cache), jnp.asarray(emb),
                             jnp.asarray(pos), adapters=jbank,
                             adapter_idx=jnp.asarray(idx), **kw)
    tc = _to_port(cache)
    tl, tc = TT.decode_chunk(tcfg, tp, tc, torch.from_numpy(emb),
                             torch.from_numpy(pos).long(), adapters=tbank,
                             adapter_idx=torch.from_numpy(idx).long(), **kw)
    assert tl.shape == (B, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for k in jc:
        for p in ("k", "v"):
            np.testing.assert_allclose(tc[k][p].numpy(), np.asarray(jc[k][p]),
                                       atol=1e-5, rtol=0)

    # ---- C = 4 with a ragged valid mask (chunked-prefill shape); row 2's
    # masked tail runs past the ring size of gemma3's local layers
    C = 4
    pos = np.array([0, 5, 14], np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], bool)
    emb = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    _, jc = JT.decode_chunk(cfg, jp, _to_jax(cache), jnp.asarray(emb),
                            jnp.asarray(pos), adapters=jbank,
                            adapter_idx=jnp.asarray(idx),
                            valid=jnp.asarray(valid), logits=False, **kw)
    tc = _to_port(cache)
    out, tc = TT.decode_chunk(tcfg, tp, tc, torch.from_numpy(emb),
                              torch.from_numpy(pos).long(), adapters=tbank,
                              adapter_idx=torch.from_numpy(idx).long(),
                              valid=torch.from_numpy(valid), logits=False,
                              **kw)
    assert out is None
    for k in jc:
        for p in ("k", "v"):
            np.testing.assert_allclose(tc[k][p].numpy(), np.asarray(jc[k][p]),
                                       atol=1e-5, rtol=0)
            # masked tails leave their cache rows untouched
            np.testing.assert_array_equal(tc[k][p][:, 2, 15:].numpy(),
                                          cache[k][p][:, 2, 15:])


def test_init_params_matches_reference_tree():
    """The port's own init: same names, shapes and dtypes as the reference
    tree; seeded draws are reproducible."""
    for name in ARCHS:
        cfg, tree = _numpy_params(name)
        a = TT.init_params(t_reduced(name), seed=5, device="cpu")
        b = TT.init_params(t_reduced(name), seed=5, device="cpu")
        ref = jax.tree_util.tree_leaves_with_path(tree)
        got = jax.tree_util.tree_leaves_with_path(a)
        assert [p for p, _ in ref] == [p for p, _ in got]
        for (_, x), (_, y), (_, z) in zip(ref, got,
                                          jax.tree_util.tree_leaves_with_path(b)):
            assert tuple(y.shape) == x.shape
            assert torch.equal(y, z)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(t_reduced("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(t_reduced("qwen2-0.5b"), {})
