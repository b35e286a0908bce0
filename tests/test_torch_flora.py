"""FLoRA's round in the port against the JAX package on the CPU.

FLoRA restarts every sampled client, and the global adapter, from fresh
``jax.random`` draws each round; torch cannot reproduce them, so the test
injects the reference's draws, given as numpy, through the port's one
seam (``FederatedTrainer.flora_reinit``, built by
``interop.flora_reinit_from_numpy``).  Both trainers start from the
reference's state (``interop.load_reference_state``).

Exact: cohorts, ranks, and the new global adapter (the injected draw).
Within tolerance: the loss (atol 1e-5); the clients' adapters as
``tests/test_torch_fedround.py`` argues for AdamW, within one round's
local steps × lr per element (each round restarts from the draws) and
1e-6 in the mean; and the base weights, whose change is the dense delta
``Σ_k p_k·scale·B_k A_k`` of those adapters: every element within 1e-6
plus 1e-3 of the largest change (the adapters' own tolerance carried
through the product), checked against the delta recomputed in f64 from
the port's own adapters within 1e-5 relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core.lora import LoRAConfig, init_lora_params  # noqa: E402
from test_torch_faults import STEPS, LR, make_pair  # noqa: E402
from repro_torch.interop import flora_reinit_from_numpy  # noqa: E402
from repro_torch.launch.fedround import make_client_update_step  # noqa: E402

ROUNDS = 2


def _inject(ref, port, sampled_rounds):
    """The reference's FLoRA draws for ``rounds`` × every client, injected
    into ``port``."""
    lcfg = LoRAConfig(rank=ref.lcfg.rank)
    K = ref.fcfg.num_clients
    clients = {(r, k): jax.device_get(init_lora_params(
        jax.random.PRNGKey(1000 * r + k), ref.specs, lcfg))
        for r in range(sampled_rounds) for k in range(K)}
    globals_ = {r: jax.device_get(init_lora_params(
        jax.random.PRNGKey(r + 77), ref.specs, lcfg))
        for r in range(sampled_rounds)}
    port.flora_reinit = flora_reinit_from_numpy(clients, globals_,
                                                device="cpu")


def _sites(params):
    """The LoRA'd base weights: {spec name: [L, in, out]}."""
    return {f"s0.attn.{w}": params["blocks"]["s0"]["attn"][w]
            for w in ("wq", "wv")}


def _dense_delta_f64(port, sampled, scale):
    """Σ_k p_k·scale·B_k A_kᵀ from the port's client adapters, in f64."""
    sizes = np.asarray([port.clients[k].size for k in sampled], np.float64)
    p = sizes / sizes.sum()
    out = {}
    for name, e in port.stacked_lora.items():
        a = e["A"][sampled].double().numpy()
        b = e["B"][sampled].double().numpy()
        out[name] = scale * np.einsum("k,klor,klri->lio", p, b, a)
    return out


@pytest.mark.parametrize("driver", ["run_round", "run_round_reference"])
def test_flora_rounds_match_reference(driver):
    ref, port = make_pair("flora", edit=False, sample_rate=0.6)
    _inject(ref, port, ROUNDS)
    site = _sites(port.base_params)
    for t in range(ROUNDS):
        before = {n: w.clone() for n, w in site.items()}
        rr, rp = getattr(ref, driver)(), getattr(port, driver)()
        assert rp["sampled"] == [int(k) for k in rr["sampled"]]
        assert rp["edited_layers"] == rr["edited_layers"] == []
        np.testing.assert_allclose(rp["train_loss"], rr["train_loss"],
                                   atol=1e-5)
        np.testing.assert_array_equal(port.client_ranks, ref.client_ranks)
        # the global adapter is the round's fresh draw, bit for bit
        want = jax.device_get(init_lora_params(
            jax.random.PRNGKey(t + 77), ref.specs,
            LoRAConfig(rank=ref.lcfg.rank)))
        for n in want:
            for m in ("A", "B"):
                np.testing.assert_array_equal(
                    port.server.global_lora[n][m].numpy(), want[n][m])
        ref_sites = _sites(jax.device_get(ref.base_params))
        ref_stack = jax.device_get(ref.stacked_lora)
        for n in ref_stack:
            for m in ("A", "B"):
                d = np.abs(port.stacked_lora[n][m].numpy() - ref_stack[n][m])
                assert d.max() <= STEPS * LR, (n, m, d.max())
                assert d.mean() <= 1e-6, (n, m, d.mean())
        delta = _dense_delta_f64(port, rp["sampled"], port.lora_scale)
        for n, w in site.items():
            # the base weights were updated in place
            assert w is _sites(port.base_params)[n]
            moved = (w - before[n]).double().numpy()
            np.testing.assert_allclose(
                moved, delta[n], rtol=0,
                atol=1e-5 * np.abs(delta[n]).max() + 1e-7)
            d = np.abs(w.numpy() - np.asarray(ref_sites[n]))
            assert d.max() <= 1e-6 + 1e-3 * np.abs(delta[n]).max(), \
                (n, d.max())
    # the evaluation reads the folded base weights: the reference's tokens
    r, p = ref.evaluate_global(n=8), port.evaluate_global(n=8)
    assert p["bleu"] == r["bleu"] and p["rsum"] == r["rsum"]
    np.testing.assert_allclose(p["loss"], r["loss"], atol=1e-4)


def test_flora_has_no_async_timeline():
    """As in the reference: FLoRA rewrites the base weights synchronously,
    so the async tick and the client-update half refuse it."""
    _, port = make_pair("flora", edit=False)
    with pytest.raises(ValueError, match="fedbuff"):
        port.run_round_async()
    with pytest.raises(ValueError, match="flora"):
        make_client_update_step(port.mcfg, port.ocfg, lora_scale=1.0, r_g=16,
                                aggregator="flora")


def test_flora_default_draws_are_seeded_and_fresh():
    """Without injection the draws come from seeded torch generators: the
    same for one (seed, round, client), different across rounds, and
    masked to each client's rank by the round."""
    _, a = make_pair("flora", edit=False)
    _, b = make_pair("flora", edit=False)
    c0, g0 = a.flora_reinit(0, [0, 1])
    c0b, g0b = b.flora_reinit(0, [0, 1])
    c1, g1 = a.flora_reinit(1, [0, 1])
    for n in c0:
        assert torch.equal(c0[n]["A"], c0b[n]["A"])
        assert torch.equal(g0[n]["A"], g0b[n]["A"])
        assert not torch.equal(c0[n]["A"], c1[n]["A"])
        assert not torch.equal(g0[n]["A"], g1[n]["A"])
        assert not torch.equal(c0[n]["A"][0], c0[n]["A"][1])
        assert not c0[n]["B"].any()
    a.run_round()
    for c in a.clients:
        for e in c.lora.values():
            assert not e["A"][:, c.rank:].any() and not e["B"][..., c.rank:].any()
