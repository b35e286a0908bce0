"""The fused MoE's plain version (``repro_torch.kernels.moe.moe_fused_ref``)
against the port's plain dispatch (``layers.moe_forward``) and the JAX
package's ``moe_forward`` on the CPU, and the gate that keeps the plain
dispatch everywhere but inference on one card.  The kernels themselves run
on the card (``test_torch_moe_card.py``).

Tolerances, f32: the router's integer decisions (expert ids, capacity
positions, drops) bit for bit; ``y`` atol 1e-5, as the families' layer
outputs (each expert's rows are multiplied in another grouping, and the
combine sums in f32 where the dispatches sum in x's type); ``aux`` atol
1e-6."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import moe as MK  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from test_torch_families import (STATE_TOL, _cfgs,  # noqa: E402
                                 _reference_routing)

D, FF = 64, 32
# name -> (experts, top-k, shared experts, shared width each, capacity
# factor, tokens, router with equal columns)
CASES = {
    "granite": (8, 3, 1, 64, 8 / 3, 24, False),
    "deepseek": (8, 2, 2, 32, 1.25, 24, False),
    "t1": (8, 3, 1, 64, 8 / 3, 1, False),
    "drops": (8, 3, 1, 64, 0.5, 24, False),
    "ties": (8, 3, 0, 0, 8 / 3, 24, True),
}


def _case(name, seed=0):
    """(JAX config, port config, numpy params, x [T, d]) of one case."""
    E, K, ns, ffs, cf, T, ties = CASES[name]
    jc, tc = _cfgs("deepseek")
    moe = dict(num_experts=E, experts_per_token=K, d_ff_expert=FF,
               num_shared_experts=ns, d_ff_shared=ffs or None,
               capacity_factor=cf)
    jc = dataclasses.replace(jc, d_model=D,
                             moe=dataclasses.replace(jc.moe, **moe))
    tc = dataclasses.replace(tc, d_model=D,
                             moe=dataclasses.replace(tc.moe, **moe))
    rng = np.random.default_rng(seed)

    def nrm(*shape, fan):
        return (rng.standard_normal(shape) * fan ** -0.5).astype(np.float32)

    p = {"router": nrm(D, E, fan=D), "w1": nrm(E, D, FF, fan=D),
         "w3": nrm(E, D, FF, fan=D), "w2": nrm(E, FF, D, fan=FF)}
    if ties:                      # experts 1, 4 and 6 always score equal
        p["router"][:, 4] = p["router"][:, 6] = p["router"][:, 1]
    if ns:
        w = ns * ffs
        p["shared"] = {"w1": nrm(D, w, fan=D), "w3": nrm(D, w, fan=D),
                       "w2": nrm(w, D, fan=w)}
    x = rng.standard_normal((T, D)).astype(np.float32)
    if T > 4:
        x[3:] = np.where(np.arange(T - 3)[:, None] % 4 == 0, x[3], x[3:])
    return jc, tc, p, x


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("name", list(CASES))
def test_fused_ref_matches_both_dispatches(name):
    jc, tc, p, x = _case(name)
    tp = _torch(p)
    xf = torch.from_numpy(x)
    T, E, K = x.shape[0], tc.moe.num_experts, tc.moe.experts_per_token
    C = TL.moe_capacity(tc, T)
    y, aux, route = MK.moe_fused_ref(
        xf, xf.float() @ tp["router"], tp, top_k=K, capacity=C,
        aux_coef=tc.moe.aux_loss_coef, route=True)

    _, gates, ids, pos, kept = TL.moe_route(tp["router"], xf, tc)
    np.testing.assert_array_equal(route["ids"].numpy(), ids.numpy())
    np.testing.assert_array_equal(route["pos"].numpy(), pos.numpy())
    np.testing.assert_array_equal(route["kept"].numpy(), kept.numpy())
    np.testing.assert_allclose(route["gates"].numpy(), gates.numpy(),
                               atol=1e-7, rtol=0)
    jids, jpos, jkept = jax.jit(lambda r, xf: _reference_routing(r, xf, jc))(
        jnp.asarray(p["router"]), jnp.asarray(x))
    np.testing.assert_array_equal(route["ids"].numpy(), np.asarray(jids))
    np.testing.assert_array_equal(route["pos"].numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(route["kept"].numpy(), np.asarray(jkept))
    if name == "drops":
        assert not bool(kept.all())
    elif name != "deepseek":      # capacity factor E / K: nothing drops
        assert bool(kept.all())
    if name == "ties":            # 1 before 4 before 6 wherever they meet
        for row in route["ids"].tolist():
            tied = [e for e in row if e in (1, 4, 6)]
            assert tied == sorted(tied)

    ty, taux = TL.moe_forward(tp, xf[None], tc)
    jy, jaux = jax.jit(lambda p, x: JL.moe_forward(p, x, jc))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x[None]))
    np.testing.assert_allclose(y.numpy(), ty[0].numpy(), **STATE_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[0], **STATE_TOL)
    np.testing.assert_allclose(aux.item(), taux.item(), atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6)


@pytest.mark.parametrize("name", ["granite", "drops"])
def test_fused_ref_in_bf16_keeps_the_plain_dispatch_precision(name):
    """bf16 weights and x: the same decisions as the plain dispatch, and
    ``y`` within two bf16 steps (2^-7 of the largest output each) of it
    (the dispatch rounds each product,
    the gated terms and their running sum to bf16; the fused route rounds
    h, each pick's output and the sum once)."""
    _, tc, p, x = _case(name)
    tp = {k: (v.to(torch.bfloat16) if k != "router" else v)
          for k, v in _torch(p).items() if k != "shared"}
    tp["shared"] = {k: v.to(torch.bfloat16)
                    for k, v in _torch(p["shared"]).items()}
    xf = torch.from_numpy(x).to(torch.bfloat16)
    K = tc.moe.experts_per_token
    y, _, route = MK.moe_fused_ref(
        xf, xf.float() @ tp["router"], tp, top_k=K,
        capacity=TL.moe_capacity(tc, xf.shape[0]),
        aux_coef=tc.moe.aux_loss_coef, route=True)
    _, _, ids, pos, kept = TL.moe_route(tp["router"], xf, tc)
    assert torch.equal(route["ids"], ids) and torch.equal(route["pos"], pos)
    assert torch.equal(route["kept"], kept)
    ty, _ = TL.moe_forward(tp, xf[None], tc)
    assert y.dtype == torch.bfloat16
    scale = ty[0].float().abs().max().item()
    err = (y.float() - ty[0].float()).abs().max().item()
    assert err <= 2 * 2 ** -7 * scale


@pytest.mark.parametrize("where", ["cpu", "grad", "tp", "meta"])
def test_gate_keeps_the_plain_dispatch(where):
    """Only a bf16 CUDA input outside a mesh with gradients off takes the
    fused kernels; in f32, on the CPU, with gradients, with a ``tp`` and on
    ``meta`` tensors (the dry run, which still traces) the plain dispatch
    runs and ``kernels.moe.launches`` stays 0."""
    _, tc, p, x = _case("granite")
    cuda_x = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16,
                                   shape=(2, 4, D))
    cuda_f32 = types.SimpleNamespace(is_cuda=True, dtype=torch.float32,
                                     shape=(2, 4, D))
    with torch.no_grad():
        assert TL.moe_takes_fused(cuda_x, None, tc)
        assert not TL.moe_takes_fused(cuda_f32, None, tc)
        assert not TL.moe_takes_fused(cuda_x, object(), tc)
    with torch.enable_grad():
        assert not TL.moe_takes_fused(cuda_x, None, tc)

    tp, xf = _torch(p), torch.from_numpy(x)[None]
    MK.reset_launches()
    if where == "cpu":
        with torch.no_grad():
            y, _ = TL.moe_forward(tp, xf, tc)
        assert y.shape == xf.shape
    elif where == "grad":
        w = {k: v.requires_grad_() if k == "w1" else v for k, v in tp.items()}
        y, aux = TL.moe_forward(w, xf, tc)
        (y.sum() + aux).backward()
        assert w["w1"].grad is not None
    elif where == "tp":
        with torch.no_grad():
            assert not TL.moe_takes_fused(xf, object(), tc)
            y, _ = TL.moe_forward(tp, xf, tc)
    else:
        with torch.no_grad():
            t = dryrun.trace(lambda q, v: TL.moe_forward(q, v, tc),
                             dryrun.meta_copy(tp), dryrun.meta_copy(xf))
        assert t.flops > 0 and t.ops > 0
    assert MK.launches == 0 and MK.plain == 1


def test_tiling_follows_rows_per_expert():
    """Decode tiles up to ``DECODE_ROWS`` rows an expert, prefill tiles
    above; the Granite cell's decode (T 128, K 10, E 72: 17.8 rows an
    expert) takes the decode tiling, its 2048-token prefill not.  The
    kernels run at decode-sized batches and, above, for small experts
    (Granite's and DeepSeek-V2's prefill at any capacity) or where the plain
    dispatch's buffers would be padded ``PLAIN_PAD`` times or more (Jamba's
    at its E/K = 8, not at its 1.25).  The kernels' wrapper refuses f32
    operands and operands off a CUDA device before it builds anything."""
    assert MK.tile_rows(128, 10, 72) == 32
    assert MK.tile_rows(2048, 10, 72) == 128
    assert MK.tile_rows(1, 1, 16) == 32
    granite, deepseek, jamba = (4096, 768), (5120, 1536), (4096, 14336)
    assert MK.fused_is_faster(128, 10, 72, 128, *granite)
    assert MK.fused_is_faster(2048, 10, 72, 356, *granite)
    assert MK.fused_is_faster(2048, 6, 160, 97, *deepseek)
    assert MK.fused_is_faster(128, 2, 16, 20, *jamba)
    assert not MK.fused_is_faster(2048, 2, 16, 320, *jamba)
    assert MK.fused_is_faster(2048, 2, 16, 2048, *jamba)
    T, d, E, ff = 2, 8, 4, 8
    p = {"w1": torch.zeros(E, d, ff), "w3": torch.zeros(E, d, ff),
         "w2": torch.zeros(E, ff, d)}
    kw = dict(top_k=1, capacity=1, aux_coef=0.0)
    logits = torch.zeros(T, E)
    with pytest.raises(TypeError):
        MK.moe_fused_cuda(torch.zeros(T, d), logits, p, **kw)
    bf = {k: v.to(torch.bfloat16) for k, v in p.items()}
    with pytest.raises(ValueError):
        MK.moe_fused_cuda(torch.zeros(T, d, dtype=torch.bfloat16), logits,
                          bf, **kw)


def test_engine_steps_without_gradients(monkeypatch):
    """The serving engine steps with gradients off, so on a card its MoE
    layers take the fused kernels; on the CPU they keep the plain
    dispatch (``kernels.moe.plain`` counts every layer call)."""
    from repro_torch.interop import adapters_from_numpy
    from repro_torch.serving import AdapterStore, Request, ServingEngine
    from test_torch_families import _lora, _world

    jc, tc, _, port = _world("jamba")
    grads = []
    gate = TL.moe_takes_fused

    def recording(x, tp, cfg):
        grads.append(torch.is_grad_enabled())
        return gate(x, tp, cfg)

    monkeypatch.setattr(TL, "moe_takes_fused", recording)
    store = AdapterStore(slots=2, rank=8, device="cpu")
    store.register("t0", adapters_from_numpy(_lora(jc, 8, 1)), 8)
    eng = ServingEngine(tc, port, store, device="cpu", lora_scale=1.0,
                        max_slots=2, max_prompt=4, max_gen=3)
    MK.reset_launches()
    done = eng.run([Request("t0", np.array([5, 7, 9]), 3)])
    assert len(done) == 1 and len(done[0]["tokens"]) == 3
    assert grads and not any(grads)
    assert MK.launches == 0 and MK.plain == len(grads)
