"""Frozen count of the model FLOPs a decode step spends on one token of a
hybrid Mamba-2 / attention / mixture-of-experts stack with per-request
LoRA, at the token's position ``t`` (0-based; prompt tokens streamed one
a step count alike).

Per token: every linear layer ``2·in·out`` (a mixture of experts its
``experts_per_token`` experts, its shared experts and the router, not all
of the routed experts); each
adapted site ``2·r·(in + out)``; Mamba's scan ``4·H·P·N`` (the state's
rank-one update and its contraction with ``C``) and its convolution
``2·W·channels``; attention ``4·H·hd·(t + 1)`` (scores and values over
the ``t + 1`` positions a causal step reads); the head ``2·d·V``.
Norms and elementwise work are not counted.
"""

from __future__ import annotations


def token_flops(m: dict, rank: int) -> tuple[float, float]:
    """(FLOPs of one token apart from attention's reads of the cache, the
    FLOPs per cached position it reads)."""
    d, V = m["d_model"], m["vocab_size"]
    n = m["num_layers"] // len(m["pattern"])
    mo, s = m["moe"], m["ssm"]
    f = 2.0 * d * V
    per_pos = 0.0
    for i, kind in enumerate(m["pattern"]):
        if kind == "mamba":
            d_in = s["expand"] * d
            H, P, N = d_in // s["head_dim"], s["head_dim"], s["state_dim"]
            po = 2 * d_in + 2 * N + H
            f += n * (2 * d * po + 2 * d_in * d
                      + 2 * rank * (d + po) + 2 * rank * (d_in + d)
                      + 4 * H * P * N + 2 * s["conv_width"] * (d_in + 2 * N))
        else:
            H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
            f += n * (2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d
                      + 2 * rank * (d + H * hd) + 2 * rank * (d + KV * hd))
            per_pos += n * 4 * H * hd
        if i % mo["layer_period"] == mo["layer_offset"]:
            f += n * (2 * d * mo["num_experts"]
                      + mo["experts_per_token"] * 6 * d * mo["d_ff_expert"]
                      + mo.get("num_shared_experts", 0) * 6 * d
                      * (mo.get("d_ff_shared") or mo["d_ff_expert"]))
        elif m["d_ff"] > 0:
            f += n * 6 * d * m["d_ff"]
    return f, per_pos


def request_flops(m: dict, rank: int, positions: int) -> float:
    """FLOPs of streaming ``positions`` positions (0 .. positions-1) of one
    request."""
    f, per_pos = token_flops(m, rank)
    return positions * f + per_pos * positions * (positions + 1) / 2
