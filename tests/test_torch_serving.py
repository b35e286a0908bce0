"""The port's serving engine against the JAX package's on the CPU: the same
params, adapters and requests; greedy tokens must be identical per
request, and dispatch counts, page-ins, evictions and quarantine behaviour
equal.  The adapter bank holds fewer slots than there are tenants, so cold
tenants page in and out."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread beats oversubscribing the test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import AdapterQuarantinedError as JQuarantined  # noqa: E402
from repro.serving import AdapterStore as JStore  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.core.paging import AllSlotsPinnedError  # noqa: E402
from repro_torch.interop import (adapters_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.serving import (AdapterQuarantinedError,  # noqa: E402
                                 AdapterStore, Request, SamplingConfig,
                                 ServingEngine)
from repro_torch.telemetry import Telemetry, span  # noqa: E402
from repro_torch.telemetry.trace import _NULL_SPAN  # noqa: E402

RANKS = (4, 8, 16, 8, 4)
BANK_SLOTS, RANK, SCALE = 2, 16, 2.0
ENGINE_KW = dict(lora_scale=SCALE, max_slots=3, max_prompt=8, max_gen=6)


def _world(name, seed=0):
    cfg = get_reduced_config(name)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for p in tree["blocks"]["s0"]["attn"]:
        if p.startswith("b"):
            v = tree["blocks"]["s0"]["attn"][p]
            tree["blocks"]["s0"]["attn"][p] = (
                0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    adapters = {}
    for t, r in enumerate(RANKS):
        adapters[f"t{t}"] = ({s.name: {
            "A": (0.2 * rng.standard_normal((s.num_layers, r, s.in_dim))
                  ).astype(np.float32),
            "B": (0.2 * rng.standard_normal((s.num_layers, s.out_dim, r))
                  ).astype(np.float32)} for s in JT.lora_specs(cfg)}, r)
    reqs = []
    for i in range(9):
        vis = (rng.standard_normal((cfg.num_vision_tokens, cfg.vision_dim))
               .astype(np.float32) if cfg.vision_mode == "prefix"
               and cfg.num_vision_tokens else None)
        reqs.append((f"t{int(rng.integers(0, len(RANKS)))}",
                     rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(1, 9))),
                     int(rng.integers(1, 7)), vis))
    return cfg, tree, adapters, reqs


@pytest.fixture(scope="module", params=["fedbench-tiny", "qwen2-0.5b"])
def world(request):
    return (request.param,) + _world(request.param)


def _port_engine(name, tree, adapters, **kw):
    store = AdapterStore(slots=BANK_SLOTS, rank=RANK, device="cpu")
    for t, (a, r) in adapters.items():
        store.register(t, adapters_from_numpy(a), r)
    cfg = t_reduced(name)
    return ServingEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                         store, device="cpu", **ENGINE_KW, **kw)


def _jax_engine(cfg, tree, adapters, **kw):
    store = JStore(slots=BANK_SLOTS, rank=RANK)
    for t, (a, r) in adapters.items():
        store.register(t, a, r)
    return JEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree), store,
                   **ENGINE_KW, **kw)


def _tokens(done, reqs):
    """Completion records in submission order (uids rise with it)."""
    by_uid = {d["uid"]: d for d in done}
    return [by_uid[q.uid] for q in reqs]


# each prefill mode, batching mode and LoRA backend runs on both models,
# and chunked prefill once more through the online-softmax attention path
CONFIGS = [dict(prefill_chunk=None, continuous=True, lora_backend="gather"),
           dict(prefill_chunk=4, continuous=True, lora_backend="grouped"),
           dict(prefill_chunk=3, continuous=False, lora_backend="gather"),
           dict(prefill_chunk=None, continuous=False, lora_backend="grouped"),
           dict(prefill_chunk=4, continuous=True, lora_backend="gather",
                prefill_flash=True)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_engine_matches_reference(world, kw):
    name, cfg, tree, adapters, reqs = world
    je = _jax_engine(cfg, tree, adapters, **kw)
    te = _port_engine(name, tree, adapters, **kw)
    jreqs = [JRequest(a, p, g, vision=v) for a, p, g, v in reqs]
    treqs = [Request(a, p, g, vision=v) for a, p, g, v in reqs]
    jd = _tokens(je.run(jreqs), jreqs)
    td = _tokens(te.run(treqs), treqs)
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


def test_quarantine_and_fault_containment_match(world):
    """A non-finite adapter registered with validation is quarantined in
    both engines (same health counters, same admission error); one forced
    through without validation faults only its own requests."""
    name, cfg, tree, adapters, reqs = world
    je = _jax_engine(cfg, tree, adapters)
    te = _port_engine(name, tree, adapters)
    bad = {k: {"A": np.full_like(v["A"], np.nan), "B": v["B"]}
           for k, v in adapters["t1"][0].items()}
    je.store.register("bad", bad, 8)
    te.store.register("bad", adapters_from_numpy(bad), 8)
    assert set(te.store.quarantined) == set(je.store.quarantined) == {"bad"}
    assert te.store.health == je.store.health
    with pytest.raises(JQuarantined):
        je.submit(JRequest("bad", np.array([1, 2]), 2, vision=reqs[0][3]))
    with pytest.raises(AdapterQuarantinedError):
        te.submit(Request("bad", np.array([1, 2]), 2, vision=reqs[0][3]))
    je.store.register("nan", bad, 8, validate=False)
    te.store.register("nan", adapters_from_numpy(bad), 8, validate=False)
    mix = [("nan" if i % 3 == 0 else a, p, g, v)
           for i, (a, p, g, v) in enumerate(reqs)]
    jreqs = [JRequest(a, p, g, vision=v) for a, p, g, v in mix]
    treqs = [Request(a, p, g, vision=v) for a, p, g, v in mix]
    jd = _tokens(je.run(jreqs), jreqs)
    td = _tokens(te.run(treqs), treqs)
    assert [t["status"] for t in td] == [j["status"] for j in jd]
    assert [t["status"] for t in td].count("error") == 3
    for j, t in zip(jd, td):
        if j["status"] == "ok":
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert dict(te.dispatch_count) == dict(je.dispatch_count)


def test_sampling_top1_is_greedy_and_reproducible():
    name = "qwen2-0.5b"
    _, tree, adapters, reqs = _world(name, seed=3)

    def run(sampling, order, seed=0):
        eng = _port_engine(name, tree, adapters, sampling=sampling,
                           sample_seed=seed)
        rs = [Request(a, p, g, vision=v, uid=1000 + i)
              for i, (a, p, g, v) in enumerate(reqs)]
        done = eng.run([rs[i] for i in order])
        return {d["uid"]: d["tokens"].tolist() for d in done}

    fwd, rev = list(range(len(reqs))), list(reversed(range(len(reqs))))
    greedy = run(None, fwd)
    assert run(SamplingConfig(temperature=0.7, top_k=1), rev) == greedy
    s = SamplingConfig(temperature=1.5)
    a = run(s, fwd)
    assert run(s, rev) == a                # same (seed, uid): same tokens
    assert run(s, fwd, seed=1) != a        # another seed draws others
    assert a != greedy


def test_reset_cancel_and_telemetry():
    """Cancelling launches nothing; spans count exactly the dispatches;
    reset empties the engine."""
    name = "qwen2-0.5b"
    _, tree, adapters, reqs = _world(name)
    tel = Telemetry(enabled=True)
    eng = _port_engine(name, tree, adapters, prefill_chunk=4, telemetry=tel)
    rs = [Request(a, p, 6, vision=v) for a, p, _, v in reqs]
    for r in rs:
        eng.submit(r)
    eng.step()
    before = collections.Counter(eng.dispatch_count)
    eng.cancel(rs[0].uid)                  # in flight
    eng.cancel(rs[-1].uid)                 # queued
    assert eng.dispatch_count == before
    assert {d["status"] for d in eng.completed} == {"cancelled"}
    done = eng.run()
    assert len(done) == len(rs) - 2 and all(d["status"] == "ok" for d in done)
    for key, n in eng.dispatch_count.items():
        assert tel.tracer.counts[key] == n
    assert tel.snapshot()["counters"]["serving.generated_tokens"] == sum(
        r.gen_len for r in rs[1:-1])
    eng.reset()
    assert not eng.dispatch_count and not eng.busy_slots and not eng.queue
    assert int(eng._state["tlen"].abs().sum()) == 0


def span_parents(events) -> dict:
    """``{span name: the names of the spans it ran directly inside}``
    (``None`` for an outermost one) from a tracer's events."""
    stack, out = [], collections.defaultdict(set)
    for name, _, t0, t1, depth, _ in sorted(
            (e for e in events if e[3] is not None),
            key=lambda e: (e[2], e[4])):
        while stack and stack[-1][1] >= depth:
            stack.pop()
        out[name].add(stack[-1][0] if stack else None)
        stack.append((name, depth))
    return out


@pytest.fixture(scope="module")
def hybrid():
    from test_torch_families_serving import _setup
    return _setup("jamba")


def _hybrid_run(hybrid, telemetry):
    """The tiny hybrid stack (one Mamba sublayer with a SwiGLU, one
    attention sublayer with an MoE) served through BGMV."""
    _, tc, _, port, adapters, reqs = hybrid
    store = AdapterStore(slots=BANK_SLOTS, rank=RANK, device="cpu")
    for t, (a, r) in adapters.items():
        store.register(t, adapters_from_numpy(a), r)
    eng = ServingEngine(tc, port, store, device="cpu",
                        lora_backend="grouped", telemetry=telemetry,
                        **ENGINE_KW)
    done = eng.run([Request(a, p, g, uid=3000 + i)
                    for i, (a, p, g) in enumerate(reqs)])
    return eng, {d["uid"]: d["tokens"].tolist() for d in done}


def test_layer_spans_off_change_nothing_and_record_nothing(hybrid):
    """Serving with tracing off and on gives the same tokens, the same
    dispatch counts and the same cache bit for bit; the disabled tracer
    records nothing and no tracer stays current after a step."""
    off, on = Telemetry(enabled=False), Telemetry(enabled=True)
    e0, t0 = _hybrid_run(hybrid, off)
    e1, t1 = _hybrid_run(hybrid, on)
    assert t0 == t1 and dict(e0.dispatch_count) == dict(e1.dispatch_count)
    for pre, entry in e0._cache.items():
        for k, c in entry.items():
            assert torch.equal(c, e1._cache[pre][k]), (pre, k)
    assert off.tracer.n_recorded == 0 and not off.tracer.counts
    assert not off.tracer.events() and on.tracer.counts["bgmv"] > 0
    assert span("bgmv") is _NULL_SPAN


def test_layer_spans_nest_inside_the_step(hybrid):
    """Each engine step records its layers under ``serve_step``: the
    embedding, each sublayer's mixer and feed-forward, ``serve_head``
    twice (the model's unembed, the engine's sampling and emit) and BGMV
    at each banked site inside the mixer that calls it."""
    tel = Telemetry(enabled=True)
    eng, _ = _hybrid_run(hybrid, tel)
    counts, parents = tel.tracer.counts, span_parents(tel.tracer.events())
    assert counts["serve_step"] == eng.steps > 0
    per_step = {"serve_embed": 1, "mamba_mixer": 1, "attn_mixer": 1,
                "ffn": 1, "moe": 1, "serve_head": 2, "bgmv": 4}
    for name, n in per_step.items():
        assert counts[name] == n * eng.steps, name
        assert parents[name] == ({"mamba_mixer", "attn_mixer"}
                                 if name == "bgmv" else {"serve_step"}), name
    assert parents["serve_step"] == {None}


def test_failed_page_in_propagates_and_leaves_adapter_cold():
    """A page-in copy that fails (as a device error would) propagates out
    of ``step`` instead of being read as a full bank, and the adapter stays
    cold: a later clean page-in of it writes its rows."""
    name = "qwen2-0.5b"
    _, tree, adapters, reqs = _world(name)
    eng = _port_engine(name, tree, adapters)
    store = eng.store
    good = store._host["t1"]
    spec = next(iter(good))
    # a host copy the bank rows cannot take: the copy raises mid page-in
    store._host["t1"] = {k: dict(v) for k, v in good.items()}
    store._host["t1"][spec]["A"] = good[spec]["A"][..., :-1]
    eng.submit(Request("t1", reqs[0][1], 2))
    with pytest.raises(RuntimeError, match="size of tensor") as err:
        eng.step()
    assert not isinstance(err.value, AllSlotsPinnedError)
    assert store._pager.lookup("t1") is None and not store._pager.pinned("t1")
    assert store.loads == 0 and not store.dispatch_count["adapter_load"]
    store._host["t1"] = good
    slot = store.acquire("t1")
    assert store.loads == 1
    for name_, entry in store.scan_stack.items():
        for p, x in entry.items():
            torch.testing.assert_close(x[:, slot], good[name_][p], rtol=0,
                                       atol=0)


def test_no_cuda_no_mesh():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AdapterStore(slots=2, rank=4)
    store = AdapterStore(slots=2, rank=4, device="cpu")
    name = "qwen2-0.5b"
    cfg = t_reduced(name)
    _, tree, _, _ = _world(name)
    params = params_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, store, lora_scale=1.0)
    # a serving mesh is a repro_torch.launch.mesh.Mesh
    # (tests/test_torch_mesh_serving.py serves on one)
    with pytest.raises(TypeError, match="Mesh"):
        ServingEngine(cfg, params, store, lora_scale=1.0, device="cpu",
                      mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        AdapterStore(slots=2, rank=4, device="cpu", mesh=object())
