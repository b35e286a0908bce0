"""The frozen work counts against what the port executes on the CPU at toy
widths: FLOPs against ``torch.utils.flop_counter.FlopCounterMode``, bytes
against the sizes of the tensors the operation reads and writes."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.tests.checkout import DATA
from perfbench import harness, inputs
from perfbench.reference import hybrid, prefix_vlm
from perfbench.work import bgmv, dim_agg, serve_step, train_step


def _cfg(name):
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("rank", [4, 8])
def test_local_step_flops_match_the_executed_step(rank):
    from repro_torch.launch.steps import loss_and_grad
    cfg = _cfg("tiny-vlm")
    m = cfg["model"]
    W = inputs.draw_params(prefix_vlm.param_specs(m), 3, "cpu",
                           torch.float32)
    lora = inputs.lora_init(prefix_vlm.lora_sites(m), rank, 4, "cpu")
    for e in lora.values():
        e["B"].normal_()
    task = {"vocab_size": m["vocab_size"], "seq_len": 12, "prompt_len": 3,
            "num_concepts": 6, "ambiguity": 3, "num_patches": 8,
            "image_dim": 32, "image_noise": 0.25, "alpha": 0.5}
    shard = inputs.captioning_corpus(task, [3], 5, 0.0)[0]
    batch = {k: torch.from_numpy(v) for k, v in shard.items()}
    got = _count(lambda: loss_and_grad(harness.model_config(cfg),
                                       inputs.nest(W), lora, batch, 0.5))
    want = train_step.local_step_flops(m, 3, 12, rank, causal=False)
    assert got == want


def test_causal_count_keeps_the_masked_half_out():
    m = _cfg("tiny-vlm")["model"]
    full = train_step.local_step_flops(m, 2, 16, 4, causal=False)
    causal = train_step.local_step_flops(m, 2, 16, 4, causal=True)
    # per pair 4·B·H·hd in each layer's forward, twice that in its
    # backward, half of that less in the first layer (no key gradient)
    S, per_pair, L = 8 + 16, 4 * 2 * 4 * 16, 2
    masked = S * S - S * (S + 1) // 2
    assert full - causal == (3 * L - 0.5) * per_pair * masked


def test_serve_token_flops_match_an_executed_decode_step():
    from repro_torch.models import transformer as T
    cfg = _cfg("tiny-hybrid")
    m = cfg["model"]
    mcfg = harness.model_config(cfg)
    W = inputs.nest(inputs.draw_params(hybrid.param_specs(m), 3, "cpu",
                                       torch.float32))
    sites = hybrid.lora_sites(m)
    G, r, M, S = 3, 8, 5, 16
    bank = {n: {"A": torch.randn(n_l, G, r, d_in),
                "B": torch.randn(n_l, G, d_out, r)}
            for n, (d_in, d_out, n_l) in sites.items()}
    cache = T.init_cache(mcfg, W, M, S)
    x = torch.randn(M, 1, m["d_model"])
    pos = torch.arange(M)
    idx = torch.tensor([0, 1, 2, 0, 1])
    got = _count(lambda: T.decode_chunk(mcfg, W, cache, x, pos,
                                        adapters=bank, adapter_idx=idx,
                                        lora_scale=0.5, lora_kernel=True))
    f, per_pos = serve_step.token_flops(m, r)
    # as executed: attention reads the whole cache, every expert runs its
    # capacity buffer (here C = M), and the state's rank-one update is
    # elementwise, which the counter does not see
    mo, s = m["moe"], m["ssm"]
    d_in = s["expand"] * m["d_model"]
    H = d_in // s["head_dim"]
    n_blocks = m["num_layers"] // len(m["pattern"])
    n_mamba = n_blocks * m["pattern"].count("mamba")
    n_moe = n_blocks * sum(1 for i in range(len(m["pattern"]))
                           if i % mo["layer_period"] == mo["layer_offset"])
    executed = (M * f + M * per_pos * S
                - M * n_mamba * 2 * H * s["head_dim"] * s["state_dim"]
                + n_moe * (mo["num_experts"] - mo["experts_per_token"]) * M
                * 6 * m["d_model"] * mo["d_ff_expert"])
    assert got == executed


def test_bgmv_work_matches_the_tensors():
    from repro_torch.kernels.ref import grouped_lora_matmul_ref
    M, K, N, G, r = 6, 32, 24, 4, 8
    x = torch.randn(M, K, dtype=torch.bfloat16)
    w = torch.randn(K, N, dtype=torch.bfloat16)
    a = torch.randn(G, r, K, dtype=torch.bfloat16)
    b = torch.randn(G, N, r, dtype=torch.bfloat16)
    idx = torch.tensor([0, 2, 2, 0, 3, 0])
    y = grouped_lora_matmul_ref(x, w, a, b, idx, scale=0.5)
    used = idx.unique().numel()
    f, nbytes = bgmv.call_work(M, K, N, r, used)
    assert nbytes == (x.nbytes + w.nbytes + y.nbytes
                      + used * (a[0].nbytes + b[0].nbytes))
    assert f == _count(lambda: grouped_lora_matmul_ref(x, w, a, b, idx,
                                                       scale=0.5))


def test_dim_agg_work_matches_the_tree():
    from repro_torch.core.aggregation import fedilora
    m = _cfg("tiny-vlm")["model"]
    sites = prefix_vlm.lora_sites(m)
    K, r = 3, 8
    stacked = {n: {"A": torch.randn(K, L, r, d_in),
                   "B": torch.randn(K, L, d_out, r)}
               for n, (d_in, d_out, L) in sites.items()}
    ranks, p = torch.tensor([2, 4, 8]), torch.tensor([0.2, 0.3, 0.5])
    out = fedilora(stacked, ranks, p)
    f, nbytes = dim_agg.tree_work(sites, K, r)
    leaves_in = sum(t.nbytes for e in stacked.values() for t in e.values())
    leaves_out = sum(t.nbytes for e in out.values() for t in e.values())
    assert nbytes == leaves_in + leaves_out + K * r * 4
    assert f == 2 * sum(t.numel() for e in stacked.values()
                        for t in e.values())
