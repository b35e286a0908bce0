"""The port's serving engine on the Mamba-2, hybrid Jamba, MoE and MLA
stacks against the JAX engine on the CPU (reduced configs): the same
params, adapters and requests give the same greedy tokens per request,
dispatch counts, prefill bursts, page-ins and evictions, through both LoRA
backends.  Mamba stacks prefill by streaming; DeepSeek also with chunked
prefill.  The adapter bank holds fewer slots than there are tenants of
ranks 4-16, so cold tenants page in and out, zero-rank-padded to the bank
rank.  The gate's refusals equal the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.serving import AdapterStore as JStore  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.interop import adapters_from_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import AdapterStore, Request, ServingEngine  # noqa: E402
from test_torch_families import _lora, _world  # noqa: E402

RANKS = (4, 8, 16, 8, 4)
BANK_SLOTS, RANK, SCALE = 2, 16, 2.0
ENGINE_KW = dict(lora_scale=SCALE, max_slots=3, max_prompt=8, max_gen=6)


def _setup(variant, seed=0):
    jc, tc, tree, port = _world(variant, seed=seed)
    adapters = {f"t{t}": (_lora(jc, r, seed + 10 + t), r)
                for t, r in enumerate(RANKS)}
    rng = np.random.default_rng(seed)
    reqs = [(f"t{int(rng.integers(0, len(RANKS)))}",
             rng.integers(0, jc.vocab_size, size=int(rng.integers(1, 9))),
             int(rng.integers(1, 7))) for _ in range(9)]
    return jc, tc, tree, port, adapters, reqs


def _engines(jc, tc, tree, port, adapters, **kw):
    js = JStore(slots=BANK_SLOTS, rank=RANK)
    ts = AdapterStore(slots=BANK_SLOTS, rank=RANK, device="cpu")
    for t, (a, r) in adapters.items():
        js.register(t, a, r)
        ts.register(t, adapters_from_numpy(a), r)
    je = JEngine(jc, jax.tree_util.tree_map(jnp.asarray, tree), js,
                 **ENGINE_KW, **kw)
    te = ServingEngine(tc, port, ts, device="cpu", **ENGINE_KW, **kw)
    return je, te


def _by_uid(done, reqs):
    by_uid = {d["uid"]: d for d in done}
    return [by_uid[q.uid] for q in reqs]


CASES = [("mamba2", dict(lora_backend="gather")),
         ("mamba2", dict(lora_backend="grouped", continuous=False)),
         ("jamba", dict(lora_backend="grouped")),
         ("deepseek", dict(lora_backend="gather", prefill_chunk=4)),
         ("deepseek", dict(lora_backend="grouped", prefill_chunk=4)),
         ("deepseek-wq", dict(lora_backend="grouped")),
         ("llama4", dict(lora_backend="grouped", prefill_chunk=3))]


@pytest.mark.parametrize("variant,kw", CASES, ids=[
    f"{v}-" + "-".join(str(x) for x in kw.values()) for v, kw in CASES])
def test_engine_matches_reference(variant, kw):
    jc, tc, tree, port, adapters, reqs = _setup(variant)
    je, te = _engines(jc, tc, tree, port, adapters, **kw)
    jreqs = [JRequest(a, p, g) for a, p, g in reqs]
    treqs = [Request(a, p, g) for a, p, g in reqs]
    jd = _by_uid(je.run(jreqs), jreqs)
    td = _by_uid(te.run(treqs), treqs)
    for j, t in zip(jd, td):
        assert t["status"] == j["status"] == "ok"
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert dict(te.dispatch_count) == dict(je.dispatch_count)
    assert te.steps == je.steps
    assert te.prefill_bursts == je.prefill_bursts
    assert (te.store.loads, te.store.evictions) == (je.store.loads,
                                                    je.store.evictions)
    assert te.store.loads > BANK_SLOTS
    assert te.store.paging_stats == je.store.paging_stats


@pytest.mark.parametrize("variant", ["mamba2", "jamba", "deepseek"])
def test_bank_pads_mamba_and_mla_specs_like_reference(variant):
    """Every LoRA spec of the stack (Mamba's in/out projections, MLA's
    ``wuq`` and ``wkv_b``, Jamba's attention q/v) is banked; a rank-4
    tenant in a rank-16 bank lands zero-padded, as in the reference's
    bank."""
    jc, tc, tree, port, adapters, _ = _setup(variant)
    je, te = _engines(jc, tc, tree, port, adapters)
    assert set(te.store.scan_stack) == {s.name for s in TT.lora_specs(tc)}
    js, ts = je.store.acquire("t0"), te.store.acquire("t0")
    assert js == ts
    bank = jax.device_get(je.store.scan_stack)
    a0 = adapters["t0"][0]
    for name, entry in te.store.scan_stack.items():
        for p in ("A", "B"):
            got = entry[p][:, ts].numpy()
            np.testing.assert_array_equal(got, bank[name][p][:, js])
            pad = got[:, 4:] if p == "A" else got[..., 4:]
            assert not pad.any()
            np.testing.assert_array_equal(
                got[:, :4] if p == "A" else got[..., :4], a0[name][p])


GATED = [("llama-3.2-vision-11b", {}), ("seamless-m4t-medium", {}),
         ("mamba2-130m", dict(prefill_chunk=2)),
         ("jamba-v0.1-52b", dict(prefill_chunk=1))]


@pytest.mark.parametrize("name,kw", GATED, ids=[g[0] for g in GATED])
def test_gate_refuses_like_reference(name, kw):
    """Cross-attention and enc-dec stacks, and chunked prefill over a
    Mamba state: the same exception type and message in both packages."""
    errs = []
    for cfg, store, engine, extra in [
            (get_reduced_config(name), JStore(slots=2, rank=4), JEngine, {}),
            (t_reduced(name), AdapterStore(slots=2, rank=4, device="cpu"),
             ServingEngine, dict(device="cpu"))]:
        with pytest.raises(NotImplementedError) as e:
            engine(cfg, {}, store, lora_scale=1.0, **kw, **extra)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    if "cross_attn" in get_reduced_config(name).pattern:
        with pytest.raises(NotImplementedError, match="cross"):
            TT.init_params(t_reduced(name), device="cpu")
        assert "cross_attn" in errs[1]


def test_mamba_requests_admitted_into_used_slots_start_fresh():
    """A Mamba slot reused by a later request starts from a zero state:
    the same request gives the same tokens in a fresh engine and after
    other requests ran through every slot."""
    jc, tc, tree, port, adapters, reqs = _setup("mamba2", seed=1)
    _, te = _engines(jc, tc, tree, port, adapters)
    a, p, g = reqs[0]
    alone = te.run([Request(a, p, g)])[0]["tokens"]
    te.run([Request(x, y, z) for x, y, z in reqs[1:]])
    again = te.run([Request(a, p, g)])[0]["tokens"]
    np.testing.assert_array_equal(alone, again)
