"""The port's SLO scheduler and engine against the JAX package's on the
CPU, under a ``ManualClock``.

Each scenario of ``tests/test_scheduler.py`` (and a fixed set of the
overload interleavings that ``tests/test_serving_slo_props.py`` draws)
runs once on each side, on the reduced qwen2-0.5b with the same weights,
adapters and prompts.  Everything each side observes must be equal bit
for bit: the completion records in order (request, status, attempts,
degradation, deadline, latency and TTFT on the manual clock, greedy
tokens), which request holds each slot, the pending and retry sets, the
``serving.*`` counters, the histogram counts, the per-class queue-depth
gauges, ``slo_report`` and the dispatch counts.  Requests are matched by
the order they were made (each package numbers uids on its own).

Sampled decoding draws from ``jax.random`` in the reference and from a
counter-based hash in the port, so the retry-preserves-sampling scenario
compares statuses and attempts across the packages and tokens within
each package."""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as JS  # noqa: E402
import repro_torch.serving as TS  # noqa: E402
from repro.configs import get_reduced_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.interop import (adapters_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.telemetry import Telemetry as TTelemetry  # noqa: E402

MODEL, RANKS, GEN = "qwen2-0.5b", (4, 8, 16), 6
COUNTERS = ("serving.shed", "serving.timeout", "serving.cancelled",
            "serving.request_errors", "serving.completed_requests",
            "serving.generated_tokens")
HISTOGRAMS = ("serving.latency_seconds", "serving.ttft_seconds",
              "serving.queue_wait_seconds")


def _world():
    cfg = get_reduced_config(MODEL)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    adapters = {f"client{k}": ({s.name: {
        "A": (0.2 * rng.standard_normal((s.num_layers, r, s.in_dim))
              ).astype(np.float32),
        "B": (0.2 * rng.standard_normal((s.num_layers, s.out_dim, r))
              ).astype(np.float32)} for s in JT.lora_specs(cfg)}, r)
        for k, r in enumerate(RANKS)}
    prompts = {(k, i): rng.integers(0, cfg.vocab_size, size=3 + (k + i) % 4)
               for k in range(len(RANKS)) for i in range(2)}
    return cfg, tree, adapters, prompts


class Side:
    """One package's engines (built once per shape, reset between
    scenarios) and request factory."""

    def __init__(self, pkg, world):
        self.pkg, self.world = pkg, world
        self.S = JS if pkg == "jax" else TS
        self._engines = {}
        self.made = []

    def engine(self, slots, bank=3, sampling=None):
        key = (slots, bank, sampling)
        if key not in self._engines:
            cfg, tree, adapters, _ = self.world
            kw = dict(lora_scale=2.0, max_slots=slots, max_prompt=8,
                      max_gen=GEN)
            if sampling:
                kw.update(sampling=self.S.SamplingConfig(*sampling),
                          sample_seed=7)
            if self.pkg == "jax":
                store = JS.AdapterStore(slots=bank, rank=max(RANKS))
                for t, (a, r) in adapters.items():
                    store.register(t, a, r)
                eng = JS.ServingEngine(
                    cfg, jax.tree_util.tree_map(jnp.asarray, tree), store,
                    telemetry=JTelemetry(enabled=False), **kw)
            else:
                store = TS.AdapterStore(slots=bank, rank=max(RANKS),
                                        device="cpu")
                for t, (a, r) in adapters.items():
                    store.register(t, adapters_from_numpy(a), r)
                tcfg = t_reduced(MODEL)
                eng = TS.ServingEngine(
                    tcfg, params_from_numpy(tcfg, tree, device="cpu"), store,
                    telemetry=TTelemetry(enabled=False), device="cpu", **kw)
            self._engines[key] = eng
        eng = self._engines[key]
        eng.reset()
        eng.clock = time.perf_counter
        m = eng.telemetry.metrics.snapshot()
        self._base = ({c: m["counters"].get(c, 0.0) for c in COUNTERS},
                      {h: m["histograms"].get(h, {}).get("count", 0)
                       for h in HISTOGRAMS})
        return eng

    def req(self, k=0, i=0, gen_len=GEN, **kw):
        r = self.S.Request(adapter_id=f"client{k}",
                           prompt_tokens=self.world[3][(k, i)],
                           gen_len=gen_len, **kw)
        self.made.append(r.uid)
        return r

    def sched(self, eng, cfg=None):
        clock = self.S.ManualClock()
        return self.S.SLOScheduler(eng, cfg, clock=clock), clock

    def ix(self, uid):
        return self.made.index(uid)

    def record(self, rec):
        out = {k: (np.asarray(v).tolist() if k == "tokens" else v)
               for k, v in rec.items() if k != "error"}
        out["uid"] = self.ix(rec["uid"])
        return out

    def state(self, sched):
        """Everything observable about a scheduler and its engine."""
        eng = sched.engine
        m = eng.telemetry.metrics.snapshot()
        base_c, base_h = self._base
        return {
            "results": [self.record(r) for r in sched.results],
            "pending": [self.ix(r.uid) for r in sched._pending],
            "retries": [(t, self.ix(r.uid)) for t, _, r in sched._retry],
            "slots": [None if r is None else self.ix(r.uid)
                      for r in eng._requests],
            "counters": {c: m["counters"].get(c, 0.0) - base_c[c]
                         for c in COUNTERS},
            "histograms": {h: m["histograms"].get(h, {}).get("count", 0)
                           - base_h[h] for h in HISTOGRAMS},
            "depth": {c: m["gauges"][f"serving.queue_depth.{c}"]
                      for c in ("interactive", "batch")},
            "dispatch": dict(eng.dispatch_count), "steps": eng.steps}


def drain(sched, clock, dt=1e-4, max_rounds=500):
    for _ in range(max_rounds):
        if not (sched.pending or sched.waiting_retries or sched.engine.queue
                or sched.engine.busy_slots):
            return
        if (sched.waiting_retries and not sched.pending
                and not sched.engine.busy_slots and not sched.engine.queue):
            clock.advance(sched._retry[0][0] - clock() + 1e-9)
        sched.step()
        clock.advance(dt)
    raise AssertionError("scheduler failed to drain")


# --------------------------------------------------------------- scenarios
# each returns the list of states it observed; both packages must agree

def interactive_ahead_of_batch(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng)
    sched.submit(side.req(0, slo="batch"))          # submitted first
    sched.submit(side.req(1, slo="interactive"))
    sched.step()
    obs = [side.state(sched)]
    drain(sched, clock)
    return obs + [side.state(sched)]


def edf_within_class(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng)
    sched.submit(side.req(0, slo="batch", deadline_s=50.0))
    sched.submit(side.req(1, slo="batch", deadline_s=20.0))
    sched.step()
    obs = [side.state(sched)]
    drain(sched, clock)
    return obs + [side.state(sched)]


def scheduled_tokens_match_unloaded(side):
    eng = side.engine(2)
    plain = [d["tokens"].tolist() for d in sorted(
        eng.run([side.req(k, i) for i in range(2) for k in range(3)]),
        key=lambda d: d["uid"])]
    eng = side.engine(2)
    sched, clock = side.sched(eng)
    for i in range(2):
        for k in range(3):
            sched.submit(side.req(k, i, slo="interactive" if (i + k) % 2
                                  else "batch"))
    drain(sched, clock)
    got = [d["tokens"].tolist() for d in sorted(sched.results,
                                                key=lambda d: d["uid"])]
    assert got == plain
    return [plain, side.state(sched)]


def reject_burst(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        queue_limit=0, shed_policy="reject"))
    for k in range(3):
        sched.submit(side.req(k))
    obs = [side.state(sched)]
    drain(sched, clock)
    return obs + [side.state(sched)]


def drop_lowest(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        queue_limit=1, shed_policy="drop_lowest"))
    sched.submit(side.req(0, slo="batch"))
    sched.step()
    obs = [side.state(sched)]
    for k, slo in ((1, "batch"), (2, "interactive"), (0, "interactive")):
        clock.advance(1e-3)
        sched.submit(side.req(k, slo=slo))
        obs.append(side.state(sched))
    drain(sched, clock)
    return obs + [side.state(sched)]


def degrade(side):
    eng = side.engine(1)
    full = eng.run([side.req(0)])[0]["tokens"].tolist()
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        queue_limit=0, shed_policy="degrade", degrade_gen_len=2))
    sched.submit(side.req(1))
    late = side.req(0)
    sched.submit(late)                  # over room: admitted degraded
    assert late.gen_len == 2 and late.degraded
    drain(sched, clock)
    rec = next(r for r in sched.results if r["uid"] == late.uid)
    assert rec["tokens"].tolist() == full[:2]   # a prefix of the full run
    return [full, side.state(sched)]


def timeout_cancels_in_flight(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        interactive_deadline_s=0.05, batch_deadline_s=100.0))
    sched.submit(side.req(0, slo="interactive"))
    sched.submit(side.req(1, slo="batch"))
    sched.step()
    obs = [side.state(sched)]
    steps = eng.dispatch_count["serve_step"]
    clock.advance(1.0)                  # blown mid-flight
    sched.step()                        # cancel + re-admit, one step
    assert eng.dispatch_count["serve_step"] == steps + 1
    obs.append(side.state(sched))
    drain(sched, clock)
    return obs + [side.state(sched)]


def pending_expiry(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        interactive_deadline_s=0.05))
    sched.submit(side.req(0, slo="interactive"))
    sched.submit(side.req(1, slo="interactive"))
    sched.step()
    clock.advance(1.0)
    sched.step()
    obs = [side.state(sched)]
    drain(sched, clock)
    return obs + [side.state(sched)]


def engine_cancel_by_uid(side):
    eng = side.engine(1)
    inflight, queued = side.req(0), side.req(1)
    eng.submit(inflight)
    eng.submit(queued)
    eng.step()
    recs = [eng.cancel(queued.uid), eng.cancel(inflight.uid,
                                               status="timeout")]
    with pytest.raises(KeyError):
        eng.cancel(inflight.uid)
    assert eng.busy_slots == [] and not eng.queue
    return [[side.record({**r, "latency_s": 0.0}) for r in recs],
            dict(eng.dispatch_count)]


def retry_backoff(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        queue_limit=0, shed_policy="reject",
        retry=side.S.RetryPolicy(max_attempts=3, backoff_s=0.5,
                                 multiplier=2.0)))
    sched.submit(side.req(0))
    sched.submit(side.req(1))           # shed, retry scheduled
    sched.step()                        # backoff not elapsed yet
    obs = [side.state(sched)]
    drain(sched, clock)
    return obs + [side.state(sched)]


def retry_exhaustion(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        queue_limit=0, shed_policy="reject",
        retry=side.S.RetryPolicy(max_attempts=2, backoff_s=1e6)))
    sched.submit(side.req(0, deadline_s=1e9))
    sched.submit(side.req(1))
    clock.advance(2e6)
    sched._ready_retries(clock())       # attempt 2, still no room
    obs = [side.state(sched)]
    drain(sched, clock)
    return obs + [side.state(sched)]


def per_class_queue_depth(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng)
    for k, slo in ((0, "interactive"), (1, "interactive"), (2, "batch")):
        sched.submit(side.req(k, slo=slo))
    obs = [side.state(sched)]
    assert obs[0]["depth"] == {"interactive": 2.0, "batch": 1.0}
    drain(sched, clock)
    return obs + [side.state(sched)]


def churn_never_evicts_pinned(side):
    eng = side.engine(2, bank=2)        # bank == slots: paging pressure
    store = eng.store
    orig = store._pager.assign

    def checked(adapter_id):
        pinned = {a for a, v in store._pager.pins.items() if v > 0}
        slot, evicted = orig(adapter_id)
        assert evicted not in pinned
        return slot, evicted

    store._pager.assign = checked
    try:
        sched, clock = side.sched(eng, side.S.SchedulerConfig(
            queue_limit=1, shed_policy="reject",
            interactive_deadline_s=0.02, batch_deadline_s=100.0,
            retry=side.S.RetryPolicy(max_attempts=2, backoff_s=0.01)))
        obs = []
        for i in range(4):
            for k in range(3):
                sched.submit(side.req(k, i % 2, slo="interactive" if k == 0
                                      else "batch"))
            sched.step()
            clock.advance(0.05)
            obs.append(side.state(sched))
        drain(sched, clock)
    finally:
        store._pager.assign = orig
    assert all(v == 0 for v in store._pager.pins.values())
    return obs + [side.state(sched), store.loads, store.evictions]


def slo_report(side):
    eng = side.engine(1)
    sched, clock = side.sched(eng, side.S.SchedulerConfig(
        queue_limit=1, shed_policy="reject",
        interactive_deadline_s=0.05, batch_deadline_s=100.0))
    sched.submit(side.req(0, slo="batch"))
    sched.step()
    sched.submit(side.req(1, slo="interactive"))     # expires
    sched.submit(side.req(2, slo="batch"))           # shed
    clock.advance(0.2)
    drain(sched, clock)
    rep = sched.slo_report()
    assert rep["goodput"] == 1 and rep["offered"] == 3
    return [side.state(sched), _nan_free(rep)]


def _nan_free(obj):
    if isinstance(obj, dict):
        return {k: _nan_free(v) for k, v in obj.items()}
    return "nan" if isinstance(obj, float) and math.isnan(obj) else obj


def interleaving(seed):
    """A fixed overload interleaving drawn as the property test draws
    them: submissions across classes, clock jumps that blow deadlines
    mid-flight, explicit in-flight cancellations and steps, on a 2-slot
    engine over a 2-slot adapter bank, then a drain."""
    rng = np.random.default_rng(seed)
    kinds = ("submit", "advance", "step", "cancel")
    events = [(kinds[int(rng.integers(4))], int(rng.integers(6)),
               int(rng.integers(1000)))
              for _ in range(int(rng.integers(12, 41)))]

    def run(side):
        eng = side.engine(2, bank=2)
        sched, clock = side.sched(eng, side.S.SchedulerConfig(
            queue_limit=2, shed_policy="reject",
            interactive_deadline_s=0.05, batch_deadline_s=10.0,
            retry=side.S.RetryPolicy(max_attempts=2, backoff_s=0.01)))
        obs, reqs = [], {}
        for kind, a, b in events:
            if kind == "submit":
                r = side.req(a % 3, b % 2,
                             slo="interactive" if (a + b) % 2 else "batch")
                reqs[r.uid] = r
                sched.submit(r)
            elif kind == "advance":
                clock.advance(0.002 + (b % 100) * 0.002)
            elif kind == "cancel":
                busy = eng.busy_slots
                if busy:
                    sched.results.append(eng.cancel_slot(
                        busy[a % len(busy)], status="cancelled"))
            else:
                sched.step()
            obs.append(side.state(sched))
        drain(sched, clock, max_rounds=2000)
        assert sorted(r["uid"] for r in sched.results) == sorted(reqs)
        for rec in sched.results:
            if rec["status"] == "shed":
                assert reqs[rec["uid"]].admitted_at is None
        return obs + [side.state(sched)]

    run.__name__ = f"interleaving_{seed}"
    return run


SCENARIOS = [interactive_ahead_of_batch, edf_within_class,
             scheduled_tokens_match_unloaded, reject_burst, drop_lowest,
             degrade, timeout_cancels_in_flight, pending_expiry,
             engine_cancel_by_uid, retry_backoff, retry_exhaustion,
             per_class_queue_depth, churn_never_evicts_pinned, slo_report,
             interleaving(0), interleaving(1), interleaving(2)]


@pytest.fixture(scope="module")
def sides():
    world = _world()
    return Side("jax", world), Side("torch", world)


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_scheduler_matches_reference(sides, scenario):
    js, ts = sides
    js.made.clear()
    ts.made.clear()
    want = scenario(js)
    got = scenario(ts)
    assert got and got == want


def test_retry_preserves_sampling_key(sides):
    """A shed-then-retried sampled request keeps its uid, so the port
    reproduces the tokens of its unloaded run; statuses and attempts
    agree with the reference's."""
    out = []
    for side in sides:
        side.made.clear()
        eng = side.engine(1, sampling=(0.8, 5))
        req = side.req(0)
        ref = eng.run([req])[0]["tokens"].tolist()
        eng = side.engine(1, sampling=(0.8, 5))
        sched, clock = side.sched(eng, side.S.SchedulerConfig(
            queue_limit=0, shed_policy="reject",
            retry=side.S.RetryPolicy(max_attempts=3, backoff_s=0.5)))
        sched.submit(side.req(1))
        sched.submit(req)
        assert sched.waiting_retries == 1
        drain(sched, clock)
        rec = next(r for r in sched.results if r["uid"] == req.uid)
        assert rec["tokens"].tolist() == ref
        out.append([(side.ix(r["uid"]), r["status"], r["attempts"])
                    for r in sched.results])
    assert out[0] == out[1] and out[1][-1][1:] == ("ok", 2)


def test_scheduler_validates_config(sides):
    eng = sides[1].engine(1)
    for bad in (dict(shed_policy="nope"), dict(queue_limit=-1),
                dict(degrade_gen_len=0)):
        with pytest.raises(ValueError):
            TS.SLOScheduler(eng, TS.SchedulerConfig(**bad))
    assert TS.RetryPolicy(backoff_s=0.5, multiplier=3.0).backoff(3) == \
        JS.RetryPolicy(backoff_s=0.5, multiplier=3.0).backoff(3)
