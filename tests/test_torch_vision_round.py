"""Federated rounds on the cross-attention VLM (reduced llama-3.2-vision-11b:
one self-attention and one gated cross-attention layer, vision_dim 64
against d_model 256) in the port against the JAX package on the CPU: two
trainers built from the same numpy corpora, the port's started from the
reference's state through ``interop.load_reference_state``.

Both trainers get the reference's base weights with every vision gate
opened to 0.5.  The reference's init leaves the gates at 0 (tanh(0) = 0):
the cross layers then add nothing, their adapters take no gradient and
the round would hold nothing of the cross path.

The round tree mixes widths: ``s1.cross.wv``'s A leaf is [L, r, 64]
beside the 256-wide attention leaves, and editing walks the cross sites
too.  Held as ``test_torch_fedround.py`` holds them: ``sampled``,
``edited_layers`` and the ranks exactly; ``train_loss`` atol 1e-5; the
global and stacked adapters within 4 steps' worth (2 rounds × 2 local
steps × lr) and a mean difference under 1e-6.  The evaluation's greedy
tokens (cached and uncached, global and through the personalized sweep)
give the reference's uncached BLEU/RSUM."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.data.synthetic import (SyntheticTaskConfig,  # noqa: E402
                                  make_federated_datasets)
from repro.federated import FederatedConfig, FederatedTrainer  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.core.editing import EditConfig as TEdit  # noqa: E402
from repro_torch.federated import FederatedConfig as TFed  # noqa: E402
from repro_torch.federated import FederatedTrainer as TTrainer  # noqa: E402
from repro_torch.interop import load_reference_state  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402

NAME = "llama-3.2-vision-11b"
LR, STEPS, ROUNDS = 3e-3, 2, 2
SIZES = np.array([40, 50, 60])
GATE = 0.5


def _pair(aggregator, name=NAME, task_kw=None, open_gates=True, **kw):
    """(reference trainer, port trainer) on identical corpora and state."""
    jc, tc = get_reduced_config(name), t_reduced(name)
    task_kw = dict(task_kw or {})
    clients, gtest = make_federated_datasets(SyntheticTaskConfig(**task_kw),
                                             3, SIZES)
    t_clients, t_gtest = TD.make_federated_datasets(
        TD.SyntheticTaskConfig(**task_kw), 3, SIZES)
    fed = dict(num_clients=3, sample_rate=1.0, ranks=(4, 8, 16),
               local_steps=STEPS, batch_size=4, aggregator=aggregator, **kw)
    ref = FederatedTrainer(
        jc, FederatedConfig(edit=EditConfig(), **fed),
        OptimizerConfig(peak_lr=LR, total_steps=50), clients, clients, gtest,
        seed=0)
    base = jax.device_get(ref.base_params)
    if open_gates:
        for sp in base["blocks"].values():
            if "cross" in sp:
                sp["cross"]["gate"] = np.full_like(sp["cross"]["gate"], GATE)
        ref.base_params = jax.tree_util.tree_map(jnp.asarray, base)
    port = TTrainer(
        tc, TFed(edit=TEdit(), **fed), TOpt(peak_lr=LR, total_steps=50),
        t_clients, t_clients, t_gtest, seed=0, device="cpu")
    load_reference_state(
        port, base_params=base,
        global_lora=jax.device_get(ref.server.global_lora),
        prev_global=jax.device_get(ref.server.prev_global),
        stacked_lora=jax.device_get(ref.stacked_lora))
    return ref, port


def _assert_adapters_close(port_tree, ref_tree, what):
    ref_tree = jax.device_get(ref_tree)
    assert set(port_tree) == set(ref_tree)
    for n in ref_tree:
        for m in ("A", "B"):
            diff = np.abs(port_tree[n][m].numpy() - ref_tree[n][m])
            assert diff.max() <= ROUNDS * STEPS * LR, (what, n, m, diff.max())
            assert diff.mean() <= 1e-6, (what, n, m, diff.mean())


def hold_rounds(ref, port, runner="run_round"):
    """Run ROUNDS rounds on both trainers and hold every record."""
    for _ in range(ROUNDS):
        rr, rp = getattr(ref, runner)(), getattr(port, runner)()
        assert rp["round"] == rr["round"]
        assert rp["sampled"] == rr["sampled"]
        assert rp["edited_layers"] == rr["edited_layers"]
        np.testing.assert_allclose(rp["train_loss"], rr["train_loss"],
                                   atol=1e-5)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        _assert_adapters_close(port.server.global_lora,
                               ref.server.global_lora, "global")
        _assert_adapters_close(port.stacked_lora, ref.stacked_lora,
                               "stacked")


@pytest.mark.parametrize("aggregator", ["fedilora_kernel",
                                        "fedilora_trimmed_kernel"])
def test_vision_rounds_match_reference(aggregator):
    ref, port = _pair(aggregator, task_kw=dict(image_dim=64))
    spec = {s.name: s.in_dim for s in port.specs}
    assert spec["s1.cross.wv"] == 64 and spec["s0.attn.wv"] == 256
    hold_rounds(ref, port)
    assert port.dispatch_count["round_step"] == ROUNDS
    # the open gates let the cross sites learn
    for site in ("s1.cross.wq", "s1.cross.wv"):
        assert port.server.global_lora[site]["B"].abs().max() > 0, site


def test_vision_evaluation_matches_reference():
    """After two fedilora_kernel rounds: the port's cached and uncached
    greedy decodes give the reference's uncached BLEU/RSUM (its cached
    decode drops ``cross.wv``'s adapter from the vision K/V)."""
    ref, port = _pair("fedilora_kernel", task_kw=dict(image_dim=64))
    for _ in range(ROUNDS):
        ref.run_round()
        port.run_round()
    g = port.server.global_lora
    want = ref.generation_scores(ref.server.global_lora, ref.global_test,
                                 n=8, cached=False)
    for cached in (True, False):
        got = port.generation_scores(g, port.global_test, n=8, cached=cached)
        assert (got["bleu"], got["rsum"]) == (want["bleu"], want["rsum"]), \
            (cached, got, want)
    r, p = ref.evaluate_global(n=8, generate=False), \
        port.evaluate_global(n=8, generate=False)
    np.testing.assert_allclose(p["loss"], r["loss"], atol=1e-4)
    # the personalized sweep (each client's adapter and images through
    # the population evaluation) against the reference's uncached decode
    # client by client, weighted as the sweep weights them
    got = port.evaluate_personalized(n=8, loss_n=8)
    w = np.asarray([c.size for c in ref.clients], np.float64)
    w = w / w.sum()
    per = [ref.generation_scores(c.lora, c.eval_data, n=8, cached=False)
           for c in ref.clients]
    assert got["bleu"] == float(np.dot(w, [g["bleu"] for g in per]))
    assert got["rsum"] == float(np.dot(w, [g["rsum"] for g in per]))
    assert port.dispatch_count["population_eval"] == 1
