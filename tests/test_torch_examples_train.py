"""The training examples' outcomes, port against reference, on the CPU:
``quickstart`` and ``federated_finetune``.

Each port trainer is built by the port's example and started from the
state of the reference trainer that the reference's example builds (its
``FederatedTrainer`` call recorded by ``tests/test_torch_examples.py``'s
harness, or its own ``build``), through
``interop.load_reference_state``; the port's example functions then run
and print as its ``main`` does.  Exact: round ids, cohorts and edited
modules.  Within the tolerances of the existing round tests: losses atol
1e-5 (``tests/test_torch_timelines.py``), evaluation loss 1e-4 and
accuracy 1e-6 (``tests/test_torch_fedround.py``); BLEU/RSUM come from the
same greedy tokens, so they are equal.

``federated_finetune`` runs fedbench-100m by default; here both sides run
it on fedbench-tiny (the reference module's ``get_config`` patched, the
port's ``build(config=)``) with every other setting of its defaults but
the depth: 2 of its 8 rounds, each method."""

import argparse
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.federated import FederatedTrainer as RefTrainer  # noqa: E402
from repro_torch.interop import load_reference_state  # noqa: E402
from test_torch_examples import (fake_trainers, host, port,  # noqa: E402
                                 reference)

ROUNDS = 2


def start_from(mine, ref) -> None:
    """The port trainer ``mine`` from the reference trainer's state."""
    load_reference_state(mine, base_params=host(ref.base_params),
                         global_lora=host(ref.server.global_lora),
                         prev_global=host(ref.server.prev_global),
                         stacked_lora=host(ref.stacked_lora))


def assert_records_equal(rp, rr) -> None:
    assert (rp is None) == (rr is None)
    if rp is None:
        return
    assert rp.keys() == rr.keys(), (rp, rr)
    for k in rr:
        if k == "train_loss":
            np.testing.assert_allclose(rp[k], rr[k], atol=1e-5)
        elif k == "sampled":
            assert rp[k] == [int(c) for c in rr[k]]
        else:
            assert rp[k] == rr[k], (k, rp[k], rr[k])


def assert_eval_close(got: dict, want: dict) -> None:
    assert (got["bleu"], got["rsum"]) == (want["bleu"], want["rsum"]), (
        got, want)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-6)


def test_quickstart_outcome(monkeypatch, capsys):
    """Two of quickstart's eight rounds, then its global and personalized
    evaluations."""
    ref_mod, mine_mod = reference("quickstart"), port("quickstart")
    fake, made = fake_trainers()
    monkeypatch.setattr(ref_mod, "FederatedTrainer", fake)
    ref_mod.main()
    ref = RefTrainer(*made[0].args, **made[0].kwargs)
    mine = mine_mod.build(device="cpu")
    start_from(mine, ref)
    capsys.readouterr()
    recs = mine_mod.train(mine, rounds=ROUNDS)
    for rp in recs:
        assert_records_equal(rp, ref.run_round())
    g, p = mine_mod.evaluate(mine)
    assert_eval_close(g, ref.evaluate_global(n=32))
    assert_eval_close(p, ref.evaluate_personalized(n=8))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "round  train_loss  edited_layer_modules"
    assert [int(x.split()[0]) for x in lines[1:1 + ROUNDS]] == [1, 2]


@pytest.mark.parametrize("method", ["fedilora", "hetlora"])
def test_federated_finetune_outcome(method, monkeypatch, capsys):
    """Each method on its captured configuration, fedbench-tiny for
    fedbench-100m on both sides, 2 rounds and the evaluations."""
    ref_mod, mine_mod = reference("federated_finetune"), port(
        "federated_finetune")
    fake, made = fake_trainers()
    monkeypatch.setattr(ref_mod, "FederatedTrainer", fake)
    monkeypatch.setattr(ref_mod, "get_config",
                        lambda name: ref_config("fedbench-tiny"))
    ref_mod.build(method, argparse.Namespace(rounds=ROUNDS, local_steps=10,
                                             batch_size=8))
    ref = RefTrainer(*made[0].args, **made[0].kwargs)
    mine = mine_mod.build(method, rounds=ROUNDS, config="fedbench-tiny",
                          device="cpu")
    start_from(mine, ref)
    out = mine_mod.finetune(mine, method, ROUNDS, time.time())
    for rp in out["rounds"]:
        assert_records_equal(rp, ref.run_round())
    assert_eval_close(out["global"], ref.evaluate_global(n=32))
    assert_eval_close(out["personalized"], ref.evaluate_personalized(n=8))
    assert len(capsys.readouterr().out.splitlines()) == ROUNDS + 1
