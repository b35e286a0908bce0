"""``async_rounds``, port against reference, on the CPU: each of its
three trainers (blocking, pipelined, buffered async) is built by both
packages' ``build`` (the configurations are held equal by
``tests/test_torch_examples.py``), the port's started from the
reference's state; the port's example functions then run as its ``main``
does.  Exact: round ids, cohorts, edited modules, ticks, merges,
staleness and server versions; the pipelined records are the blocking
ones bit for bit.  Losses within atol 1e-5, the evaluation's loss within
1e-4 and accuracy within 1e-6 (the tolerances of
``tests/test_torch_timelines.py`` and ``tests/test_torch_fedround.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_examples import port, reference  # noqa: E402
from test_torch_examples_train import (assert_records_equal,  # noqa: E402
                                       start_from)


def test_async_rounds_outcome(capsys):
    """Blocking and pipelined rounds (a warm-up and six timed each) equal
    to each other and to the reference's; the twelve buffered-async ticks'
    merges, staleness and the server version equal to the reference's."""
    ref_mod, mine_mod = reference("async_rounds"), port("async_rounds")
    pairs = {}
    for what, agg, kw in (("blocking", "fedilora", {}),
                          ("pipelined", "fedilora", {}),
                          ("async", "fedbuff", mine_mod.ASYNC)):
        ref = ref_mod.build(agg, **kw)
        mine = mine_mod.build(agg, device="cpu", **kw)
        start_from(mine, ref)
        pairs[what] = (ref, mine)
    rounds = ref_mod.ROUNDS
    timeline = mine_mod.blocking_vs_pipelined(pairs["blocking"][1],
                                              pairs["pipelined"][1])
    ref_b, ref_p = pairs["blocking"][0], pairs["pipelined"][0]
    want_b = [ref_b.run_round() for _ in range(rounds + 1)]
    want_p = ([ref_p.run_round_pipelined() for _ in range(rounds + 1)]
              + [ref_p.flush_rounds()])
    for rp, rr in zip(timeline["blocking"], want_b, strict=True):
        assert_records_equal(rp, rr)
    for rp, rr in zip(timeline["pipelined"], want_p, strict=True):
        assert_records_equal(rp, rr)
    assert timeline["pipelined"][0] is None
    assert timeline["pipelined"][1:] == timeline["blocking"]

    ref_a, mine_a = pairs["async"]
    got = mine_mod.buffered(mine_a)
    want = [ref_a.run_round_async() for _ in range(2 * rounds)]
    for rp, rr in zip(got["ticks"], want, strict=True):
        assert_records_equal(rp, rr)
    assert got["versions"] == ref_a._global_version > 0
    ev = ref_a.evaluate_personalized(n=8)
    np.testing.assert_allclose(got["eval"]["loss"], ev["loss"], atol=1e-4)
    np.testing.assert_allclose(got["eval"]["acc"], ev["acc"], atol=1e-6)
    assert capsys.readouterr().out.count("merged") == sum(
        bool(r["merges"]) for r in want)
