"""Federated rounds on the Mamba-2, hybrid Jamba (Mamba + attention + MoE)
and MLA + MoE (DeepSeek-V2) stacks, reduced configs, in the port against
the JAX package on the CPU: the fused round (``run_round``, aggregator
``fedilora_kernel``) and the host loop (``run_round_reference``), two
rounds each, from the reference's state.  Mamba's ``in_proj`` /
``out_proj`` and MLA's ``wuq`` / ``wkv_b`` sites go through ``dim_agg``
beside the attention sites, and the MoE aux loss rides the local loss.
Helpers and tolerances are ``test_torch_vision_round.py``'s (those of
``test_torch_fedround.py``)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_vision_round import _pair, hold_rounds  # noqa: E402

FAMILIES = ["mamba2-130m", "jamba-v0.1-52b", "deepseek-v2-236b"]


@pytest.mark.parametrize("runner", ["run_round", "run_round_reference"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_rounds_match_reference(name, runner):
    ref, port = _pair("fedilora_kernel", name=name, open_gates=False)
    hold_rounds(ref, port, runner)
    fused = 2 if runner == "run_round" else 0
    assert port.dispatch_count["round_step"] == fused
