"""The port's examples (``repro_torch.examples.*``) against the
reference's (``examples/*.py``) on the CPU.

Configuration capture: the reference example is loaded from its file, and
the library entry points in its namespace (``FederatedTrainer``,
``make_serve_step``, ``jax.jit``, the aggregation module) are replaced by
recorders; the port's example is run the same way.  What each builds —
model, federated, optimizer and task configs, the data shards (bit for
bit), the arguments' defaults — must be equal, and so must what each
prints when both run on the same recorded stand-ins.

Outcome parity here: ``heterogeneous_ranks`` (the weights and their
column sums within 1e-7, the row norms within 1e-6 on the reference's
draws) and ``serve_decode`` (the reference's params, adapter and prompt:
the same greedy tokens, decode-vs-prefill under 2e-3 on both sides, and
the same cache size, both caches having the same layout).  The other
examples' outcomes are in ``tests/test_torch_examples_train.py``
(``quickstart``, ``federated_finetune``),
``tests/test_torch_examples_async.py`` and
``tests/test_torch_examples_serving.py`` (``serve_multitenant``), which
import this file's harness.  Without CUDA every example's ``main([])``
raises."""

import dataclasses
import functools
import importlib
import importlib.util
import inspect
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro_torch.examples import EXAMPLES  # noqa: E402
from repro_torch.interop import (lora_from_numpy,  # noqa: E402
                                 params_from_numpy)

ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------- harness
@functools.lru_cache(maxsize=None)
def reference(name: str) -> types.ModuleType:
    """``examples/<name>.py`` loaded by path (``examples/`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name: str) -> types.ModuleType:
    return importlib.import_module(f"repro_torch.examples.{name}")


class Stop(Exception):
    """Raised by a recorder to end a run once it has what it needs."""


def fake_trainers():
    """``(FakeTrainer, made)``: a stand-in for ``FederatedTrainer`` that
    records its arguments in ``made`` and answers every call a training
    example makes with fixed records, so the example runs to its end in
    no time."""
    made = []
    metrics = {"loss": 0.0, "acc": 0.0, "bleu": 0.0, "rsum": 0.0}

    class FakeTrainer:
        _global_version = 0

        def __init__(self, *args, **kwargs):
            self.args, self.kwargs, self.n = args, kwargs, 0
            self.base_params = kwargs.get("base_params")
            made.append(self)

        def run_round(self):
            self.n += 1
            return {"round": self.n, "train_loss": 0.0, "edited_layers": []}

        run_round_pipelined = run_round

        def flush_rounds(self):
            return None

        def run_round_async(self):
            self.n += 1
            return {"tick": self.n, "merges": 0}

        def evaluate_global(self, **kw):
            return dict(metrics)

        evaluate_personalized = evaluate_global

    return FakeTrainer, made


def trainer_call(fake) -> dict:
    """A recorded ``FederatedTrainer(...)`` call, by argument."""
    cfg, fed, opt, train, evals, test = fake.args
    base = fake.kwargs.get("base_params")
    return {"model": dataclasses.asdict(cfg), "fed": dataclasses.asdict(fed),
            "opt": dataclasses.asdict(opt), "train": train, "eval": evals,
            "test": test, "seed": fake.kwargs.get("seed", 0),
            "base": None if base is None else shapes(base)}


def shapes(tree) -> dict:
    """Leaf shapes and dtypes of a JAX or torch tree."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def assert_shards_equal(a, b, what: str) -> None:
    """Data shards (dicts of arrays, or lists of them) equal bit for bit,
    dtypes included."""
    if isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_shards_equal(x, y, f"{what}[{i}]")
        return
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), (what, k)


def assert_calls_equal(ref: dict, mine: dict) -> None:
    for key in ("model", "fed", "opt", "seed", "base"):
        assert ref[key] == mine[key], (key, ref[key], mine[key])
    for key in ("train", "eval", "test"):
        assert_shards_equal(ref[key], mine[key], key)


def masked(text: str) -> str:
    """Printed lines with their digits masked (timings differ)."""
    return re.sub(r"\d+", "#", text)


def host(tree):
    """A JAX tree as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ------------------------------------------------------------ no fallback
@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_cuda_raises(name, monkeypatch):
    """Without CUDA ``main([])`` raises: the default device is ``cuda``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(name).main([])


# ------------------------------------------------------- heterogeneous_ranks
def _recording_aggregation(real, calls: dict):
    """A stand-in for the aggregation module that records each call's
    arguments and result."""
    def rec(fn):
        def call(*a, **kw):
            out = getattr(real, fn)(*a, **kw)
            calls[fn] = (a, kw, out)
            return out
        return call
    return types.SimpleNamespace(**{fn: rec(fn) for fn in (
        "dimension_wise_weights", "fedilora", "hetlora")})


def _heterogeneous(monkeypatch, capsys):
    ref, mine = reference("heterogeneous_ranks"), port("heterogeneous_ranks")
    got = {}
    for who, mod, argv in (("ref", ref, None), ("port", mine, ["--device",
                                                               "cpu"])):
        calls = {}
        monkeypatch.setattr(mod, "AG", _recording_aggregation(mod.AG, calls))
        out = mod.main() if argv is None else mod.main(argv)
        got[who] = (calls, out, capsys.readouterr().out)
    return got


def test_heterogeneous_ranks_configuration(monkeypatch, capsys):
    """The same ranks, data weights, global rank and HetLoRA beta, and
    the same lines but for the three norms (each side's own draws)."""
    got = _heterogeneous(monkeypatch, capsys)
    (rc, _, r_out), (pc, _, p_out) = got["ref"], got["port"]
    ra, pa = rc["dimension_wise_weights"][0], pc["dimension_wise_weights"][0]
    np.testing.assert_array_equal(np.asarray(ra[0]), pa[0].numpy())
    np.testing.assert_array_equal(np.asarray(ra[1]), pa[1].numpy())
    assert ra[2] == pa[2] == 8
    assert rc["hetlora"][1] == pc["hetlora"][1] == {"beta": 0.0}
    rl, pl = r_out.splitlines(), p_out.splitlines()
    assert len(rl) == len(pl)
    for a, b in zip(rl, pl):
        assert (masked(a) == masked(b)) if "‖" in a else a == b, (a, b)


def test_heterogeneous_ranks_outcome(monkeypatch, capsys):
    """On the reference's stacked draws the port's weights, column sums
    and row norms are the reference's."""
    got = _heterogeneous(monkeypatch, capsys)
    calls = got["ref"][0]
    stack, _, _ = calls["fedilora"][0]
    w_ref = np.asarray(calls["dimension_wise_weights"][2])
    rec = port("heterogeneous_ranks").run(
        stack=lora_from_numpy(host(stack), device="cpu"), device="cpu")
    np.testing.assert_allclose(rec["w"], w_ref, atol=1e-7, rtol=0)
    np.testing.assert_allclose(rec["col_sums"], w_ref.sum(0), atol=1e-7,
                               rtol=0)
    a = "layer0.wq"
    want = {"client": np.asarray(stack[a]["A"][3, 0, 4:, :]),
            "fedilora": np.asarray(calls["fedilora"][2][a]["A"][0, 4:, :]),
            "hetlora": np.asarray(calls["hetlora"][2][a]["A"][0, 4:, :])}
    for k, v in want.items():
        np.testing.assert_allclose(rec["norms"][k], np.linalg.norm(v),
                                   atol=1e-6, rtol=0)
    # FediLoRA keeps the rank-8 client's rows, HetLoRA divides them by K
    assert rec["norms"]["fedilora"] == pytest.approx(rec["norms"]["client"])
    assert rec["norms"]["hetlora"] == pytest.approx(
        rec["norms"]["client"] / 4)


# --------------------------------------------------------------- serve_decode
SERVE_ARCHS = ("qwen2-0.5b", "mamba2-130m", "deepseek-v2-236b")


def _recording_jit(calls: list):
    """A stand-in for ``jax`` whose ``jit`` records every call of the
    compiled function: its arguments and its outputs, as numpy."""
    def jit(fn):
        compiled = jax.jit(fn)

        def call(*args):
            out = compiled(*args)
            calls.append((host(args), host(out)))
            return out
        return call
    return types.SimpleNamespace(jit=jit, random=jax.random,
                                 tree_util=jax.tree_util)


def reference_decode(arch: str, monkeypatch, capsys) -> dict:
    """The reference's ``demo(arch)`` run to its end, recorded: its
    params, adapter and prompt, the generated tokens and its line."""
    ref = reference("serve_decode")
    calls = []
    monkeypatch.setattr(ref, "jax", _recording_jit(calls))
    ref.demo(arch)
    line = capsys.readouterr().out
    n_prompt = 8
    params, lora = calls[0][0][0], calls[0][0][1]
    prompt = np.stack([c[0][3] for c in calls[:n_prompt]], 1)
    gen = [c[0][3] for c in calls[n_prompt:]] + [calls[-1][1][0].argmax(-1)]
    return {"params": params, "lora": lora, "prompt": prompt,
            "gen": np.stack(gen, 1), "line": line}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_decode_configuration(arch, monkeypatch):
    """The step each side builds: the same reduced config (MoE capacity
    raised to 8.0) and LoRA scale; the same demo defaults."""
    seen = {}
    for who, mod in (("ref", reference("serve_decode")),
                     ("port", port("serve_decode"))):
        def stop(cfg, *, lora_scale, who=who):
            seen[who] = (dataclasses.asdict(cfg), lora_scale)
            raise Stop
        monkeypatch.setattr(mod, "make_serve_step", stop)
        with pytest.raises(Stop):
            mod.demo(arch, **({} if who == "ref" else {"device": "cpu"}))
    assert seen["ref"] == seen["port"]
    if seen["ref"][0]["moe"] is not None:
        assert seen["ref"][0]["moe"]["capacity_factor"] == 8.0
    ref_d = _defaults(reference("serve_decode").demo)
    port_d = _defaults(port("serve_decode").demo)
    assert {k: port_d[k] for k in ref_d} == ref_d


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_decode_outcome(arch, monkeypatch, capsys):
    """On the reference's params, adapter and prompt: the port's greedy
    tokens equal the reference's; the port's decode stays within 2e-3 of
    its forward at every prompt position (the reference's ``demo``
    asserted the same of its own); both caches have the same layout, so
    the printed line — cache MiB included — is the same."""
    want = reference_decode(arch, monkeypatch, capsys)
    mine = port("serve_decode")
    cfg = mine.config(arch)
    got = mine.demo(arch, params=params_from_numpy(cfg, want["params"],
                                                   device="cpu"),
                    lora=lora_from_numpy(want["lora"], device="cpu"),
                    prompt=want["prompt"], device="cpu")
    assert capsys.readouterr().out == want["line"]
    np.testing.assert_array_equal(got["gen"], want["gen"])
    assert max(got["errs"]) < mine.ATOL


# ----------------------------------------------- training examples' configs
def capture_trainers(name: str, monkeypatch, capsys, argv=()) -> dict:
    """Both mains, given ``argv``, run on ``FakeTrainer``s: the recorded
    trainer calls and what each printed."""
    out = {}
    for who, mod in (("ref", reference(name)), ("port", port(name))):
        fake, made = fake_trainers()
        monkeypatch.setattr(mod, "FederatedTrainer", fake)
        if who == "ref":
            monkeypatch.setattr(sys, "argv", [name] + list(argv))
            mod.main()
        else:
            mod.main(list(argv) + ["--device", "cpu"])
        out[who] = ([trainer_call(f) for f in made],
                    capsys.readouterr().out)
    return out


def test_quickstart_configuration(monkeypatch, capsys):
    """One trainer, built alike (default seed); 8 rounds and both
    evaluations print alike."""
    got = capture_trainers("quickstart", monkeypatch, capsys)
    (ref, r_out), (mine, p_out) = got["ref"], got["port"]
    assert len(ref) == len(mine) == 1
    assert_calls_equal(ref[0], mine[0])
    assert r_out == p_out and r_out.count("\n") == 12


def test_async_rounds_configuration(monkeypatch, capsys):
    """Three trainers (blocking, pipelined, buffered async), each built
    alike; the same lines, timings aside."""
    got = capture_trainers("async_rounds", monkeypatch, capsys)
    (ref, r_out), (mine, p_out) = got["ref"], got["port"]
    assert [c["fed"]["aggregator"] for c in ref] == ["fedilora",
                                                      "fedilora", "fedbuff"]
    assert len(mine) == len(ref)
    for a, b in zip(ref, mine):
        assert_calls_equal(a, b)
    assert masked(r_out) == masked(p_out)
    assert port("async_rounds").ROUNDS == reference("async_rounds").ROUNDS


@pytest.mark.parametrize("argv", [(), ("--rounds", "2", "--local-steps", "3",
                                       "--batch-size", "4", "--methods",
                                       "hetlora,fedilora")],
                         ids=["defaults", "flags"])
def test_federated_finetune_configuration(argv, monkeypatch, capsys):
    """Both methods' trainers built alike from the same flags (the
    defaults: 8 rounds, 10 local steps, batch 8, fedilora then hetlora),
    with the model swapped to fedbench-tiny on both sides through
    ``get_config``; the base weights of the same shapes (each drawn from
    its own seed 42); the same lines, the parameter count included."""
    from repro.configs import get_config as ref_config

    from repro_torch.configs import get_config as port_config
    for who, mod, get in (("ref", reference("federated_finetune"),
                           ref_config),
                          ("port", port("federated_finetune"), port_config)):
        monkeypatch.setattr(mod, "get_config",
                            lambda name, get=get: get("fedbench-tiny"))
    got = capture_trainers("federated_finetune", monkeypatch, capsys,
                           argv=argv)
    (ref, r_out), (mine, p_out) = got["ref"], got["port"]
    methods = (argv[-1] if argv else "fedilora,hetlora").split(",")
    assert [c["fed"]["aggregator"] for c in ref] == methods
    assert len(mine) == len(ref)
    for a, b in zip(ref, mine):
        assert a["base"] is not None
        assert_calls_equal(a, b)
    assert masked(r_out) == masked(p_out)
    assert r_out.splitlines()[0] == p_out.splitlines()[0]


def test_federated_finetune_counts_the_reference_parameters():
    """The printed count at full width: the port's count of fedbench-100m's
    base weights (its abstract tree) is the reference's."""
    from repro.configs import get_config as ref_config
    from repro.models import transformer as JT

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import abstract_params
    want = sum(x.size for x in jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0),
                               ref_config("fedbench-100m")))))
    got = port("federated_finetune").count_params(
        abstract_params(get_config("fedbench-100m")))
    assert got == want and round(got / 1e6) == 104


def test_federated_finetune_flag_defaults(monkeypatch):
    """The reference's parser defaults are the port's."""
    seen = {}
    ref, mine = reference("federated_finetune"), port("federated_finetune")

    def ref_build(method, args):
        seen["ref"] = vars(args)
        raise Stop

    def port_build(method, **kw):
        seen["port"] = kw
        raise Stop

    monkeypatch.setattr(ref, "build", ref_build)
    monkeypatch.setattr(ref, "T", types.SimpleNamespace(
        init_params=lambda key, cfg: {}))
    monkeypatch.setattr(mine, "build", port_build)
    monkeypatch.setattr(sys, "argv", ["federated_finetune"])
    with pytest.raises(Stop):
        ref.main()
    with pytest.raises(Stop):
        mine.main([])
    assert seen["port"].pop("device") == "cuda"
    assert {k: seen["ref"][k] for k in seen["port"]} == seen["port"]
    assert seen["ref"]["methods"] == "fedilora,hetlora"


__all__ = ["Stop", "assert_calls_equal", "capture_trainers", "fake_trainers",
           "host", "masked", "port", "reference", "trainer_call"]
