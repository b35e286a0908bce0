"""A whole federated run of the port against the JAX package on the CPU:
two ``FederatedTrainer``s on ``fedbench-tiny`` (3 clients, 2 local steps,
2 rounds) built from the same numpy corpora, the port's started from the
reference's initial state through ``repro_torch.interop``.

Held exactly: ``sampled``, ``edited_layers``, the post-pruning ranks and
the greedy tokens behind BLEU/RSUM.  Held within tolerance: ``train_loss``
(atol 1e-5) and the global and stacked adapters.  For the adapters the
tolerance follows AdamW: it divides each update by the gradient's own
magnitude, so where a gradient is as small as eps a last-bit difference
can move that one element by up to a whole step (lr = 3e-3).  So every
element must agree within 4 steps' worth (2 rounds × 2 local steps × lr)
and the mean difference must stay under 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.editing import EditConfig  # noqa: E402
from repro.data.synthetic import (SyntheticTaskConfig,  # noqa: E402
                                  make_federated_datasets)
from repro.federated import FederatedConfig, FederatedTrainer  # noqa: E402
from repro.optim import OptimizerConfig  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core.editing import EditConfig as TEdit  # noqa: E402
from repro_torch.federated import FederatedConfig as TFed  # noqa: E402
from repro_torch.federated import FederatedTrainer as TTrainer  # noqa: E402
from repro_torch.interop import load_reference_state  # noqa: E402
from repro_torch.optim import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.serving import AdapterStore  # noqa: E402
from repro_torch.telemetry import Telemetry, span  # noqa: E402
from repro_torch.telemetry.trace import _NULL_SPAN  # noqa: E402
from test_torch_serving import span_parents  # noqa: E402

LR, STEPS, ROUNDS = 3e-3, 2, 2
SIZES = np.array([40, 50, 60])


def _fed(aggregator, **kw):
    return dict(num_clients=3, sample_rate=1.0, ranks=(4, 8, 16),
                local_steps=STEPS, batch_size=4, aggregator=aggregator, **kw)


def _port(aggregator, telemetry=None, **kw):
    """The port's trainer on the synthetic corpus, at its own seed-0
    state."""
    t_clients, t_gtest = TD.make_federated_datasets(TD.SyntheticTaskConfig(),
                                                    3, SIZES)
    return TTrainer(
        t_config("fedbench-tiny"), TFed(edit=TEdit(), **_fed(aggregator, **kw)),
        TOpt(peak_lr=LR, total_steps=50), t_clients, t_clients, t_gtest,
        seed=0, device="cpu", telemetry=telemetry)


def _pair(aggregator, **kw):
    """(reference trainer, port trainer) on identical corpora and state."""
    clients, gtest = make_federated_datasets(SyntheticTaskConfig(), 3, SIZES)
    ref = FederatedTrainer(
        get_config("fedbench-tiny"),
        FederatedConfig(edit=EditConfig(), **_fed(aggregator, **kw)),
        OptimizerConfig(peak_lr=LR, total_steps=50), clients, clients, gtest,
        seed=0)
    port = _port(aggregator, **kw)
    load_reference_state(
        port, base_params=jax.device_get(ref.base_params),
        global_lora=jax.device_get(ref.server.global_lora),
        prev_global=jax.device_get(ref.server.prev_global),
        stacked_lora=jax.device_get(ref.stacked_lora))
    return ref, port


def _assert_adapters_close(port_tree, ref_tree, what):
    ref_tree = jax.device_get(ref_tree)
    for n in ref_tree:
        for m in ("A", "B"):
            diff = np.abs(port_tree[n][m].numpy() - ref_tree[n][m])
            assert diff.max() <= ROUNDS * STEPS * LR, (what, n, m, diff.max())
            assert diff.mean() <= 1e-6, (what, n, m, diff.mean())


@pytest.mark.parametrize("aggregator,kw", [
    ("fedavg", {}),
    ("hetlora", dict(hetlora_prune_gamma=0.9)),
    ("fedilora", {}),
    ("fedilora_kernel", {}),
], ids=["fedavg", "hetlora_prune", "fedilora", "fedilora_kernel"])
def test_rounds_match_reference(aggregator, kw):
    ref, port = _pair(aggregator, **kw)
    for _ in range(ROUNDS):
        rr, rp = ref.run_round(), port.run_round()
        assert rp["round"] == rr["round"]
        assert rp["sampled"] == rr["sampled"]
        assert rp["edited_layers"] == rr["edited_layers"]
        np.testing.assert_allclose(rp["train_loss"], rr["train_loss"],
                                   atol=1e-5)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        _assert_adapters_close(port.server.global_lora, ref.server.global_lora,
                               "global")
        _assert_adapters_close(port.stacked_lora, ref.stacked_lora, "stacked")
    assert port.dispatch_count["round_step"] == ROUNDS
    if aggregator == "hetlora":
        assert list(port.client_ranks) != [4, 8, 16]     # pruning happened


def test_evaluation_matches_reference():
    """Global and personalized evaluation after two fedilora_kernel rounds:
    the same greedy tokens, hence equal BLEU/RSUM; losses within 1e-4."""
    ref, port = _pair("fedilora_kernel")
    for _ in range(ROUNDS):
        ref.run_round()
        port.run_round()
    for ev in ("evaluate_global", "evaluate_personalized"):
        r = getattr(ref, ev)(n=8)
        p = getattr(port, ev)(n=8)
        assert p["bleu"] == r["bleu"] and p["rsum"] == r["rsum"], (ev, r, p)
        np.testing.assert_allclose(p["loss"], r["loss"], atol=1e-4)
        np.testing.assert_allclose(p["acc"], r["acc"], atol=1e-6)
    assert port.dispatch_count["population_eval"] == 1
    assert port.dispatch_count["generate"] == 1
    # train → serve: the exported personalized adapters register as-is
    exported = port.export_adapters()
    assert [exported[f"client{k}"][1] for k in range(3)] == [4, 8, 16]
    store = AdapterStore.from_trainer(port, device="cpu")
    assert store.ranks == {f"client{k}": r for k, r in enumerate((4, 8, 16))}


def test_unported_options_raise():
    """The options that raised until they were ported now run: the paged
    store and FLoRA's round; a round mesh must be a
    ``repro_torch.launch.mesh.Mesh`` (``tests/test_torch_mesh_round.py``
    runs the meshed rounds), anything else raises."""
    clients, gtest = TD.make_federated_datasets(TD.SyntheticTaskConfig(), 3,
                                                SIZES)
    args = (t_config("fedbench-tiny"),)
    rest = (TOpt(), clients, clients, gtest)
    fed = dict(num_clients=3, sample_rate=1.0, ranks=(4, 8, 16),
               local_steps=1, batch_size=4)
    paged = TTrainer(*args, TFed(paged=True, **fed), *rest, device="cpu")
    rec = paged.run_round()
    assert rec["sampled"] == [0, 1, 2] and paged.store.peak_resident == 3
    assert paged.dispatch_count["round_step"] == 1
    with pytest.raises(TypeError, match="Mesh"):
        TTrainer(*args, TFed(**fed), *rest, device="cpu", mesh=object())
    flora = TTrainer(*args, TFed(aggregator="flora", **fed), *rest,
                     device="cpu")
    wq = flora.base_params["blocks"]["s0"]["attn"]["wq"].clone()
    rec = flora.run_round()
    assert np.isfinite(rec["train_loss"]) and rec["edited_layers"] == []
    assert not torch.equal(flora.base_params["blocks"]["s0"]["attn"]["wq"],
                           wq)
    bogus = TTrainer(*args, TFed(aggregator="nope", **fed), *rest,
                     device="cpu")
    with pytest.raises(ValueError, match="unknown aggregator"):
        bogus.run_round()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TTrainer(*args, TFed(**fed), *rest)


def test_round_spans_off_change_nothing_and_record_nothing():
    """A fused ``fedilora_kernel`` round with tracing off and on: the same
    record, global and client adapters bit for bit and the same dispatch
    counts; the disabled tracer records nothing and no tracer stays
    current after the round."""
    runs = {}
    for on in (False, True):
        tel = Telemetry(enabled=on)
        port = _port("fedilora_kernel", telemetry=tel)
        rec = port.run_round()
        runs[on] = (rec, dict(port.dispatch_count), port.server.global_lora,
                    port.stacked_lora, tel.tracer)
    (rec0, disp0, glob0, stk0, off), (rec1, disp1, glob1, stk1, _) = (
        runs[False], runs[True])
    assert rec0 == rec1 and disp0 == disp1
    for a, b in ((glob0, glob1), (stk0, stk1)):
        for n in a:
            for m in ("A", "B"):
                assert torch.equal(a[n][m], b[n][m]), (n, m)
    assert off.n_recorded == 0 and not off.counts and not off.events()
    assert span("fwd_bwd") is _NULL_SPAN


def test_round_spans_nest_inside_round_step():
    """With tracing on, the round's phases record under ``round_step``:
    one ``batch_gather``, ``fwd_bwd`` and ``optimizer`` once per local
    step of each client, ``edit``, ``aggregate`` (holding ``dim_agg``)
    and ``scatter``."""
    tel = Telemetry(enabled=True)
    port = _port("fedilora_kernel", telemetry=tel)
    port.run_round()
    counts, parents = tel.tracer.counts, span_parents(tel.tracer.events())
    local = len(SIZES) * STEPS
    want = {"batch_gather": 1, "fwd_bwd": local, "optimizer": local,
            "edit": 1, "aggregate": 1, "dim_agg": 1, "scatter": 1}
    for name, n in want.items():
        assert counts[name] == n, name
        assert parents[name] == {"aggregate" if name == "dim_agg"
                                 else "round_step"}, name
    assert parents["round_step"] == {"round"}
