"""The dry run's steps against the JAX package's on the CPU: the prefill
step on every family, the single-program federated round on
fedbench-tiny, and remat.

Tolerances (f32): prefill logits atol 1e-4.  The round's losses atol
1e-5; its adapters follow ``test_torch_fedround.py``'s AdamW bound (each
element within steps × lr, the mean difference under 1e-6): AdamW divides
each update by the gradient's own magnitude, so a last-bit difference in a
gradient as small as eps can move that element by up to a step.  Remat is
held bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, get_reduced_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.core.lora import mask_lora_params  # noqa: E402
from repro.launch import fedround as JF  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.core.editing import EditConfig as TEdit  # noqa: E402
from repro_torch.interop import lora_from_numpy  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import dim_agg as DK  # noqa: E402
from repro_torch.launch import fedround as TF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402

PREFILL = ["qwen2-0.5b", "gemma3-12b", "mamba2-130m", "jamba-v0.1-52b",
           "deepseek-v2-236b", "llama4-scout-17b-a16e",
           "llama-3.2-vision-11b", "seamless-m4t-medium"]
GATE = 0.5
B, S = 2, 40
LOGIT_TOL = dict(atol=1e-4, rtol=0)


def _lora(cfg, r, seed, scale=0.2, lead=()):
    rng = np.random.default_rng(seed)
    return {s.name: {
        "A": (scale * rng.standard_normal(lead + (s.num_layers, r, s.in_dim))
              ).astype(np.float32),
        "B": (scale * rng.standard_normal(lead + (s.num_layers, s.out_dim, r))
              ).astype(np.float32)} for s in JT.lora_specs(cfg)}


def _world(jc, tc, seed=0):
    tree = jax.device_get(jax.jit(JT.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jc))
    for sp in tree["blocks"].values():        # the reference's zero gate
        if "cross" in sp:                     # hides the cross path
            sp["cross"]["gate"] = np.full_like(sp["cross"]["gate"], GATE)
    return tree, params_from_numpy(tc, tree, device="cpu")


def _prefill_batch(cfg, seed, seq=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio"] = rng.standard_normal(
            (B, max(seq // 4, 8), cfg.audio_dim)).astype(np.float32)
    return batch


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_step_matches_reference(name):
    jc, tc = get_reduced_config(name), t_reduced(name)
    tree, port = _world(jc, tc)
    lora = _lora(jc, 4, 1)
    batch = _prefill_batch(jc, 2)
    want = jax.jit(JS.make_prefill_step(jc, lora_scale=2.0))(
        tree, lora, {k: jnp.asarray(v) for k, v in batch.items()})
    got = TS.make_prefill_step(tc, lora_scale=2.0)(
        port, lora_from_numpy(lora, device="cpu"), _torch(batch))
    assert got.dtype == torch.float32 and got.shape == (B, tc.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_prefill_step_on_the_chunked_path_matches_reference():
    """Above 2048 keys both sides take the online-softmax path."""
    jc, tc = get_reduced_config("qwen2-0.5b"), t_reduced("qwen2-0.5b")
    tree, port = _world(jc, tc)
    lora = _lora(jc, 4, 3)
    batch = _prefill_batch(jc, 4, seq=2304)
    want = jax.jit(JS.make_prefill_step(jc, lora_scale=2.0))(
        tree, lora, {k: jnp.asarray(v) for k, v in batch.items()})
    got = TS.make_prefill_step(tc, lora_scale=2.0)(
        port, lora_from_numpy(lora, device="cpu"), _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the single-program federated round
# ---------------------------------------------------------------------------

RANKS = np.array([2, 4, 8], np.int32)
R_G, STEPS, BATCH, SEQ, LR = 8, 2, 4, 16, 3e-3


def _round_inputs(seed=0):
    jc, tc = get_config("fedbench-tiny"), t_config("fedbench-tiny")
    tree, port = _world(jc, tc, seed)
    K = len(RANKS)
    stacked = _lora(jc, R_G, seed + 1, scale=0.05, lead=(K,))
    stacked = jax.device_get(jax.vmap(
        lambda lo, r: mask_lora_params(lo, r, R_G))(stacked,
                                                    jnp.asarray(RANKS)))
    prev = _lora(jc, R_G, seed + 2, scale=0.05)
    rng = np.random.default_rng(seed + 3)
    lead = (K, STEPS, BATCH)
    batches = {
        "tokens": rng.integers(0, jc.vocab_size, lead + (SEQ,)
                               ).astype(np.int32),
        "labels": rng.integers(0, jc.vocab_size, lead + (SEQ,)
                               ).astype(np.int32),
        "loss_mask": (rng.random(lead + (SEQ,)) < 0.8).astype(np.float32),
        "image": rng.standard_normal(lead + (jc.num_vision_tokens,
                                            jc.vision_dim)
                                     ).astype(np.float32),
        "image_mask": (rng.random(lead) < 0.7).astype(np.float32)}
    p = np.array([0.2, 0.3, 0.5], np.float32)
    return jc, tc, tree, port, stacked, prev, p, batches


def _port_args(port, stacked, prev, p, batches):
    return (port, {n: {m: torch.from_numpy(np.array(e[m])).clone()
                       for m in ("A", "B")} for n, e in stacked.items()},
            lora_from_numpy(prev, device="cpu"),
            torch.from_numpy(RANKS.copy()), torch.from_numpy(p),
            _torch(batches))


def _assert_close(port_tree, ref_tree, what):
    for n in ref_tree:
        for m in ("A", "B"):
            diff = np.abs(port_tree[n][m].numpy() - np.asarray(ref_tree[n][m]))
            assert diff.max() <= STEPS * LR, (what, n, m, diff.max())
            assert diff.mean() <= 1e-6, (what, n, m, diff.mean())


@pytest.mark.parametrize("edit", [False, True], ids=["edit_off", "edit_on"])
def test_fed_round_step_matches_reference(edit):
    jc, tc, tree, port, stacked, prev, p, batches = _round_inputs()
    opt = dict(peak_lr=LR, total_steps=20)
    ref = jax.jit(JF.make_fed_round_step(
        jc, OptimizerConfig(**opt), lora_scale=2.0, r_g=R_G,
        edit=EditConfig(enabled=edit)))
    g_ref, c_ref, l_ref = jax.device_get(ref(
        tree, stacked, prev, jnp.asarray(RANKS), jnp.asarray(p),
        {k: jnp.asarray(v) for k, v in batches.items()}))
    step = TF.make_fed_round_step(tc, TOpt(**opt), lora_scale=2.0, r_g=R_G,
                                  edit=TEdit(enabled=edit))
    g, c, loss = step(*_port_args(port, stacked, prev, p, batches))
    np.testing.assert_allclose(float(loss), float(l_ref), atol=1e-5)
    _assert_close(g, g_ref, "global")
    _assert_close(c, c_ref, "clients")
    # every client stays in its rank subspace
    for k, r in enumerate(RANKS):
        for n, e in c.items():
            assert not e["A"][k][:, r:].any(), (n, k)
            assert not e["B"][k][..., r:].any(), (n, k)


def test_fed_round_step_kernel_entry_equals_plain_and_refuses_flora():
    jc, tc, tree, port, stacked, prev, p, batches = _round_inputs(1)
    opt = TOpt(peak_lr=LR, total_steps=20)
    outs = {}
    for agg in ("fedilora", "fedilora_kernel"):
        DK.reset_launches()
        step = TF.make_fed_round_step(tc, opt, lora_scale=2.0, r_g=R_G,
                                      aggregator=agg)
        outs[agg] = step(*_port_args(port, stacked, prev, p, batches))
        assert DK.launches["dim_agg"] == 0   # CPU tensors: the plain version
    (g0, c0, l0), (g1, c1, l1) = outs["fedilora"], outs["fedilora_kernel"]
    assert float(l0) == float(l1)
    for n in g0:
        for m in ("A", "B"):
            torch.testing.assert_close(g1[n][m], g0[n][m], atol=1e-6,
                                       rtol=1e-5)
            assert torch.equal(c1[n][m], c0[n][m])
    with pytest.raises(ValueError, match="flora"):
        TF.make_fed_round_step(tc, opt, lora_scale=2.0, r_g=R_G,
                               aggregator="flora")


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-0.5b", "jamba-v0.1-52b"])
def test_train_step_remat_is_bit_for_bit(name):
    """Recomputing each block's activations in the backward changes no bit
    of the step (two microbatches; Jamba: Mamba and MoE blocks)."""
    tc = t_reduced(name)
    tc = dataclasses.replace(tc, num_layers=2 * tc.period)
    params = TS.T.init_params(tc, seed=0, device="cpu")
    lora = lora_from_numpy(_lora(tc, 4, 5), device="cpu")
    rng = np.random.default_rng(6)
    batch = _torch({
        "tokens": rng.integers(0, tc.vocab_size, (4, 24)).astype(np.int64),
        "labels": rng.integers(0, tc.vocab_size, (4, 24)).astype(np.int64),
        "loss_mask": (rng.random((4, 24)) < 0.8).astype(np.float32)})
    outs = []
    for remat in (True, False):
        step = TS.make_train_step(tc, TOpt(peak_lr=1e-3), lora_scale=2.0,
                                  num_microbatches=2, remat=remat)
        from repro_torch.optim import adamw_init
        outs.append(step(params, lora, adamw_init(lora), batch))
    (l1, o1, m1), (l0, o0, m0) = outs
    for n in l0:
        for m in ("A", "B"):
            assert torch.equal(l1[n][m], l0[n][m]), (n, m)
            assert torch.equal(o1.mu[n][m], o0.mu[n][m]), (n, m)
    for k in m0:
        assert torch.equal(m1[k], m0[k]), k
    assert TS.make_train_step.__kwdefaults__["remat"] is True
