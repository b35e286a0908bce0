"""The port's training pieces against the JAX package on the CPU: the
numpy data and metric copies (bit for bit), ``loss_fn`` and its adapter
gradients, the optimizers and schedules step by step, layer-wise editing,
the train step and KV-cached greedy generation.

Tolerances, all f32: loss atol 1e-5; gradients atol 1e-6 + rtol 1e-4 (a
sum over every token in another order); optimizer iterates atol 1e-6;
learning rates rtol 1e-6 (numpy's and XLA's f32 cos and exp differ in the
last bit); a train step's adapter: mean |diff| <= 1e-6 and every element
within 2·lr (AdamW divides by the gradient's own magnitude, so where a
gradient is as small as eps, last-bit differences can move that one
element by up to the whole step); editing selections exact; greedy tokens
equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as JD  # noqa: E402
from repro import metrics as JM  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.configs import get_config, get_reduced_config  # noqa: E402
from repro.core import editing as JE  # noqa: E402
from repro.data.partition import heterogeneous_sizes  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch import metrics as TM  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.core import editing as TE  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
MODELS = [("fedbench-tiny", get_config, t_config),
          ("fedbench-100m", get_reduced_config, t_reduced)]


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _lora(cfg, r, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return {s.name: {
        "A": (scale * rng.standard_normal((s.num_layers, r, s.in_dim))
              ).astype(np.float32),
        "B": (scale * rng.standard_normal((s.num_layers, s.out_dim, r))
              ).astype(np.float32)} for s in JT.lora_specs(cfg)}


def _batch(cfg, B, S, seed, image_mask=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)),
         "loss_mask": (rng.random((B, S)) < 0.6).astype(np.float32),
         "image": rng.standard_normal((B, cfg.num_vision_tokens,
                                       cfg.vision_dim)).astype(np.float32)}
    if image_mask:
        b["image_mask"] = (np.arange(B) % 2).astype(np.float32)
    return b


def _model(name, jget, tget, seed=0):
    cfg = jget(name)
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), cfg))
    return cfg, params, tget(name), params_from_numpy(tget(name), params,
                                                      device="cpu")


# ---------------------------------------------------------------------------
# numpy copies
# ---------------------------------------------------------------------------

def test_data_and_metrics_copies_are_bit_identical():
    task = JD.SyntheticTaskConfig(seed=1)
    sizes = heterogeneous_sizes(6, 300, seed=1)
    assert (TD.heterogeneous_sizes(6, 300, seed=1) == sizes).all()
    jc, jg = JD.make_federated_datasets(task, 6, sizes, seed=1)
    tc, tg = TD.make_federated_datasets(TD.SyntheticTaskConfig(seed=1), 6,
                                        sizes, seed=1)
    for a, b in list(zip(jc, tc)) + [(jg, tg)]:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    jm = JD.apply_missing_modality(jc[0], 0.6, task.prompt_len, seed=3)
    tm = TD.apply_missing_modality(tc[0], 0.6, task.prompt_len, seed=3)
    for k in jm:
        np.testing.assert_array_equal(jm[k], tm[k])
    labels = np.random.default_rng(0).integers(0, 5, 200)
    for a, b in zip(JD.dirichlet_partition(labels, 4, 0.5, seed=2),
                    TD.dirichlet_partition(labels, 4, 0.5, seed=2)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    hyps = [rng.integers(3, 9, rng.integers(0, 12)).tolist() for _ in range(20)]
    refs = [rng.integers(3, 9, rng.integers(1, 12)).tolist() for _ in range(20)]
    assert TM.corpus_scores(hyps, refs) == JM.corpus_scores(hyps, refs)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,jget,tget", MODELS, ids=[m[0] for m in MODELS])
@pytest.mark.parametrize("image_mask", [False, True])
def test_loss_and_lora_grads_match_reference(name, jget, tget, image_mask):
    cfg, params, tcfg, tparams = _model(name, jget, tget)
    lora = _lora(cfg, 8, 1)
    batch = _batch(cfg, 4, 24, 2, image_mask=image_mask)
    jbatch = _jax(batch)
    (jl, jm), jg = jax.value_and_grad(
        lambda lo: JT.loss_fn(cfg, params, lo, jbatch, 2.0),
        has_aux=True)(_jax(lora))
    tl, tm, tg = TS.loss_and_grad(tcfg, tparams, _torch(lora),
                                  _torch(batch), 2.0)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5)
    np.testing.assert_allclose(tm["acc"].item(), float(jm["acc"]), atol=1e-6)
    jg = jax.device_get(jg)
    for n in jg:
        for m in ("A", "B"):
            np.testing.assert_allclose(tg[n][m].numpy(), jg[n][m],
                                       **GRAD_TOL)


def test_image_mask_zeroes_the_vision_prefix():
    cfg, params, tcfg, tparams = _model("fedbench-tiny", get_config,
                                        t_config)
    batch = _torch(_batch(cfg, 4, 16, 3))
    lora = _torch(_lora(cfg, 4, 5))
    _, masked = TT.loss_fn(tcfg, tparams, lora, batch, 1.0)
    zeroed = dict(batch, image=batch["image"]
                  * batch["image_mask"][:, None, None])
    zeroed.pop("image_mask")
    _, explicit = TT.loss_fn(tcfg, tparams, lora, zeroed, 1.0)
    assert masked["loss"].item() == explicit["loss"].item()


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,schedule,wd,clip", [
    ("adamw", "constant", 0.0, 1.0), ("adamw", "cosine", 0.01, 0.05),
    ("adamw", "wsd", 0.1, 0.0), ("sgdm", "cosine", 0.0, 0.5)])
def test_optimizer_steps_match_reference(name, schedule, wd, clip):
    ocfg = dict(name=name, peak_lr=3e-3, schedule=schedule, total_steps=8,
                warmup_steps=2, weight_decay=wd, grad_clip=clip)
    j_init, j_upd = JO.make_optimizer(JO.OptimizerConfig(**ocfg))
    t_init, t_upd = TO.make_optimizer(TO.OptimizerConfig(**ocfg))
    rng = np.random.default_rng(6)
    params = {"s0": {"A": rng.standard_normal((2, 4, 6)).astype(np.float32),
                     "B": np.zeros((2, 5, 4), np.float32)}}
    jp, tp = _jax(params), _torch(params)
    js, ts = j_init(jp), t_init(tp)
    for step in range(8):
        g = {"s0": {m: (rng.standard_normal(v.shape) * 0.3).astype(
            np.float32) for m, v in params["s0"].items()}}
        g["s0"]["A"][:, 3] = 0.0            # a masked rank row stays zero
        jp, js = j_upd(jp, _jax(g), js)
        tp, ts = t_upd(tp, _torch(g), ts)
        for m in ("A", "B"):
            np.testing.assert_allclose(tp["s0"][m].numpy(),
                                       np.asarray(jp["s0"][m]), atol=1e-6)


def test_schedules_match_reference():
    for name in ("constant", "cosine", "wsd"):
        jf = JO.make_schedule(name, 1e-3, 100, 10)
        tf = TO.make_schedule(name, 1e-3, 100, 10)
        for step in range(0, 105):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                       atol=0, err_msg=f"{name} {step}")


def test_masked_rows_stay_zero_through_adamw():
    """Rank-masked entries (zero value, zero gradient) stay exactly zero
    through the moments and weight decay."""
    _, upd = TO.make_optimizer(TO.OptimizerConfig(weight_decay=0.1))
    p = {"s": {"A": torch.zeros(1, 4, 3), "B": torch.zeros(1, 3, 4)}}
    p["s"]["A"][:, :2] = 1.0
    state = TO.adamw_init(p)
    for _ in range(5):
        g = {"s": {"A": torch.randn(1, 4, 3), "B": torch.randn(1, 3, 4)}}
        g["s"]["A"][:, 2:] = 0.0
        g["s"]["B"][..., 2:] = 0.0
        p, state = upd(p, g, state)
    assert (p["s"]["A"][:, 2:] == 0).all() and (p["s"]["B"][..., 2:] == 0).all()


# ---------------------------------------------------------------------------
# layer-wise editing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("gamma_mode", ["similarity", "full", "half"])
@pytest.mark.parametrize("matrices", ["A", "B", "both", "none"])
def test_edit_lora_matches_reference(k, gamma_mode, matrices):
    cfg = get_config("fedbench-tiny")
    local, glob = _lora(cfg, 8, 7), _lora(cfg, 8, 8)
    # exact ties: modules 0 and 3 are the same pair (local = -global), so
    # their similarity is the same number, the lowest; modules 1 and 2
    # equal their global (similarity 1)
    name = sorted(local)[0]
    glob[name]["A"][3] = glob[name]["A"][0]
    local[name]["A"][0] = -glob[name]["A"][0]
    local[name]["A"][3] = -glob[name]["A"][3]
    local[name]["A"][1] = glob[name]["A"][1]
    local[name]["A"][2] = glob[name]["A"][2]
    ecfg = dict(k=k, gamma_mode=gamma_mode, matrices=matrices)
    je, jd = JE.edit_lora(_jax(local), _jax(glob), JE.EditConfig(**ecfg))
    te, td = TE.edit_lora(_torch(local), _torch(glob), TE.EditConfig(**ecfg))
    np.testing.assert_array_equal(td["selected"].numpy(),
                                  np.asarray(jd["selected"]))
    assert int(TE.edited_layer_index(td)) == int(JE.edited_layer_index(jd))
    np.testing.assert_allclose(td["sims"].numpy(), np.asarray(jd["sims"]),
                               atol=1e-6)
    je = jax.device_get(je)
    for n in je:
        for m in ("A", "B"):
            np.testing.assert_allclose(te[n][m].numpy(), je[n][m],
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    cfg, params, tcfg, tparams = _model("fedbench-tiny", get_config,
                                        t_config)
    ocfg = dict(peak_lr=1e-3, total_steps=10)
    lora = _lora(cfg, 4, 9)
    batch = _batch(cfg, 4, 16, 10)
    jstep = JS.make_train_step(cfg, JO.OptimizerConfig(**ocfg),
                               lora_scale=4.0, num_microbatches=micro,
                               remat=False)
    tstep = TS.make_train_step(tcfg, TO.OptimizerConfig(**ocfg),
                               lora_scale=4.0, num_microbatches=micro)
    jl, _, jm = jstep(_jax(params), _jax(lora), JO.adamw_init(_jax(lora)),
                      _jax(batch))
    tl, _, tm = tstep(tparams, _torch(lora), TO.adamw_init(_torch(lora)),
                      _torch(batch))
    np.testing.assert_allclose(tm["total_loss"].item(),
                               float(jm["total_loss"]), atol=1e-5)
    jl = jax.device_get(jl)
    for n in jl:
        for m in ("A", "B"):
            diff = np.abs(tl[n][m].numpy() - jl[n][m])
            assert diff.mean() <= 1e-6 and diff.max() <= 2 * 1e-3, (
                n, m, diff.mean(), diff.max())


def test_greedy_generate_tokens_match_reference():
    cfg, params, tcfg, tparams = _model("fedbench-tiny", get_config,
                                        t_config)
    lora = _lora(cfg, 8, 11, scale=0.3)
    batch = _batch(cfg, 5, 20, 12)
    cap_start, gen_len = 5, 9
    jgen = JS.make_greedy_generate(cfg, lora_scale=2.0, cap_start=cap_start,
                                   gen_len=gen_len)
    tgen = TS.make_greedy_generate(tcfg, lora_scale=2.0, cap_start=cap_start,
                                   gen_len=gen_len)
    for vision in (None, batch["image"]):
        jt = jax.jit(jgen)(_jax(params), _jax(lora),
                           jnp.asarray(batch["tokens"]),
                           None if vision is None else jnp.asarray(vision))
        tt = tgen(tparams, _torch(lora), torch.from_numpy(batch["tokens"]),
                  None if vision is None else torch.from_numpy(vision))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_population_generate_matches_reference():
    cfg, params, tcfg, tparams = _model("fedbench-tiny", get_config,
                                        t_config)
    loras = [_lora(cfg, 8, 20 + k, scale=0.3) for k in range(3)]
    stacked = {n: {m: np.stack([lo[n][m] for lo in loras])
                   for m in ("A", "B")} for n in loras[0]}
    batches = [_batch(cfg, 2, 16, 30 + k) for k in range(3)]
    tokens = np.stack([b["tokens"] for b in batches])
    vision = np.stack([b["image"] for b in batches])
    kw = dict(lora_scale=2.0, cap_start=4, gen_len=6)
    jt = jax.jit(JS.make_population_generate(cfg, **kw))(
        _jax(params), _jax(stacked), jnp.asarray(tokens), jnp.asarray(vision))
    tt = TS.make_population_generate(tcfg, **kw)(
        tparams, _torch(stacked), torch.from_numpy(tokens),
        torch.from_numpy(vision))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_lora_helpers_match_reference():
    from repro.core import lora as JL
    from repro_torch.core import lora as TL

    cfg = get_config("fedbench-tiny")
    specs, tspecs = JT.lora_specs(cfg), TT.lora_specs(t_config("fedbench-tiny"))
    assert [(s.name, s.in_dim, s.out_dim, s.num_layers) for s in specs] == [
        (s.name, s.in_dim, s.out_dim, s.num_layers) for s in tspecs]
    assert TL.num_lora_params(tspecs, 8) == JL.num_lora_params(specs, 8)
    j0 = jax.device_get(JL.init_lora_params(jax.random.PRNGKey(0), specs,
                                            JL.LoRAConfig(rank=8),
                                            client_rank=5))
    t0 = TL.init_lora_params(tspecs, TL.LoRAConfig(rank=8),
                             generator=torch.Generator().manual_seed(0),
                             client_rank=5)
    for n in j0:
        for m in ("A", "B"):
            assert t0[n][m].shape == j0[n][m].shape
            np.testing.assert_array_equal(t0[n][m].numpy() == 0,
                                          j0[n][m] == 0)
    lora = _lora(cfg, 8, 40)
    tl = _torch(lora)
    for n in lora:
        np.testing.assert_allclose(TL.lora_delta(tl[n], 2.0).numpy(),
                                   np.asarray(JL.lora_delta(_jax(lora)[n], 2.0)),
                                   atol=1e-6)
    np.testing.assert_allclose(TL.tree_l2_norm(tl).item(),
                               float(JL.tree_l2_norm(_jax(lora))), rtol=1e-6)
    assert [(n, l) for n, l, _ in TL.flatten_modules(tl)] == [
        (n, l) for n, l, _ in JL.flatten_modules(lora)]
    for r in (0, 3, 8):
        for n in lora:
            tm = TL.truncate_redistribute(tl, torch.tensor(r), 8)[n]
            jm = jax.device_get(JL.truncate_redistribute(_jax(lora), r, 8))[n]
            for m in ("A", "B"):
                np.testing.assert_array_equal(tm[m].numpy(), jm[m])
