"""``serve_multitenant``, port against reference, on the CPU: both
examples' ``main`` run to their ends.  The reference's runs with its
``FederatedTrainer`` and ``ServingEngine`` recorded (arguments, the
trainer's initial state, each engine and its finished requests); the
port's with the same recorders, its trainer started from the reference's
initial state (``interop.load_reference_state``) as it is built.

Equal: the trainer's and every engine's configuration, and what each
prints, digits aside (TTFT is each run's own).  Within tolerance: the two
rounds' losses (atol 1e-5).  Exact, for the continuous and the static
runs: every request's greedy tokens, ``eng.steps``, the dispatch counts,
``store.loads`` and ``store.evictions``.  The sampled rerun draws from
each package's own generators (the reference's ``jax.random`` streams
cannot be reproduced), so only the count of finished requests and each
request's token count are compared; both examples hold their engines'
tokens against the single-tenant decode themselves."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.federated import FederatedTrainer as RefTrainer  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro_torch.federated import FederatedTrainer  # noqa: E402
from repro_torch.interop import load_reference_state  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from test_torch_examples import (assert_calls_equal, host,  # noqa: E402
                                 masked, port, reference, trainer_call)


def recorders(trainer_cls, engine_cls, seen: dict, init=None):
    """Subclasses of a package's trainer and engine that record into
    ``seen``; with ``init`` (the reference's initial state) the trainer
    starts from it."""
    class Trainer(trainer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["trainer"] = types.SimpleNamespace(args=args, kwargs=kwargs)
            if init is not None:
                load_reference_state(self, **init)
            seen["init"] = {
                "base_params": host(self.base_params),
                "global_lora": host(self.server.global_lora),
                "prev_global": host(self.server.prev_global),
                "stacked_lora": host(self.stacked_lora)}
            seen["rounds"] = []

        def run_round(self):
            rec = super().run_round()
            seen["rounds"].append(rec)
            return rec

    class Engine(engine_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.setdefault("engines", []).append(self)
            self.kwargs = kwargs

        def run(self, requests=None, max_steps=None):
            self.done = super().run(requests, max_steps)
            return self.done

    return Trainer, Engine


def engine_kwargs(eng) -> dict:
    kw = {k: v for k, v in eng.kwargs.items() if k != "device"}
    if kw.get("sampling") is not None:
        kw["sampling"] = dataclasses.asdict(kw["sampling"])
    return kw


def by_submission(done: list) -> list:
    return sorted(done, key=lambda d: d["uid"])


def test_serve_multitenant_matches_reference(monkeypatch, capsys):
    ref_mod, mine_mod = reference("serve_multitenant"), port(
        "serve_multitenant")
    ref, mine = {}, {}
    for k, v in zip(("FederatedTrainer", "ServingEngine"),
                    recorders(RefTrainer, RefEngine, ref)):
        monkeypatch.setattr(ref_mod, k, v)
    ref_mod.main()
    ref_out = capsys.readouterr().out
    for k, v in zip(("FederatedTrainer", "ServingEngine"),
                    recorders(FederatedTrainer, ServingEngine, mine,
                              init=ref["init"])):
        monkeypatch.setattr(mine_mod, k, v)
    out = mine_mod.main(["--device", "cpu"])
    mine_out = capsys.readouterr().out

    assert masked(mine_out) == masked(ref_out), (mine_out, ref_out)
    assert_calls_equal(trainer_call(ref["trainer"]),
                       trainer_call(mine["trainer"]))
    assert len(ref["rounds"]) == len(mine["rounds"]) == 2
    for rp, rr in zip(mine["rounds"], ref["rounds"]):
        assert rp["sampled"] == [int(c) for c in rr["sampled"]]
        np.testing.assert_allclose(rp["train_loss"], rr["train_loss"],
                                   atol=1e-5)
    assert out["train"] == mine["rounds"]

    assert len(ref["engines"]) == len(mine["engines"]) == 3
    for er, ep in zip(ref["engines"], mine["engines"]):
        assert engine_kwargs(ep) == engine_kwargs(er)
    for er, ep in zip(ref["engines"][:2], mine["engines"][:2]):
        # continuous, then static: greedy
        assert ep.steps == er.steps
        assert dict(ep.dispatch_count) == dict(er.dispatch_count)
        assert (ep.store.loads, ep.store.evictions) == (er.store.loads,
                                                        er.store.evictions)
        pd, rd = by_submission(ep.done), by_submission(er.done)
        assert len(pd) == len(rd) == 12
        for a, b in zip(pd, rd):
            assert a["adapter_id"] == b["adapter_id"]
            np.testing.assert_array_equal(a["tokens"], np.asarray(b["tokens"]))
    er, ep = ref["engines"][2], mine["engines"][2]     # sampled
    assert len(ep.done) == len(er.done) == 12
    assert [len(d["tokens"]) for d in by_submission(ep.done)] == [
        len(d["tokens"]) for d in by_submission(er.done)]
    assert out["continuous"][0] is mine["engines"][0]
