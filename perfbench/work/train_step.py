"""Frozen count of one local training step of a prefix vision-language
decoder with LoRA on the query and value (the adapter's leaves are the
only ones trained; the base is frozen).

Model FLOPs, by matrix product, at the step's shapes:

* forward: every linear layer ``2·T·in·out`` (``T`` the positions it
  sees: the vision prefix and the text in the decoder, the vision tokens
  in the projector, the text in the head); attention ``2·B·H·hd`` per
  query–key pair for the scores and as much for the values; each adapted
  site ``2·T·r·(in + out)``, ``r`` the adapter's computed rank;
* backward: the gradient of every activation that needs one, ``2·T·in·out``
  a linear layer and ``2·2·B·H·hd`` a pair, and of every adapter leaf.
  The first layer's input and its keys need none (no trained leaf lies
  before them), nor do the projector and the embedding; no frozen weight
  takes a gradient.

``causal=True`` counts the pairs a causal mask keeps, ``S(S+1)/2`` of a
sequence — the work the step needs; ``causal=False`` all ``S²``, which
the program computes and masks (the count ``FlopCounterMode`` sees).
Norms, softmax, rotary and elementwise work are not counted.
"""

from __future__ import annotations


def local_step_flops(m: dict, batch: int, text: int, rank: int,
                     causal: bool = True) -> float:
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    f, V, L = m["d_ff"], m["vocab_size"], m["num_layers"]
    P, Dv = m["num_vision_tokens"], m["vision_dim"]
    S = P + text
    T, Tt = batch * S, batch * text
    pairs = S * (S + 1) // 2 if causal else S * S
    q, kv = H * hd, KV * hd
    lin = d * q + 2 * d * kv + q * d + 3 * d * f     # one layer's products
    att = 4 * batch * H * hd * pairs                 # scores + values
    lora = 2 * T * rank * ((d + q) + (d + kv))       # forward of both sites
    fwd = L * (2 * T * lin + att + lora) + 2 * batch * P * Dv * d \
        + 2 * Tt * d * V
    # backward: activations (layer 0 has no input or key gradient)
    bwd = L * 2 * T * lin - 2 * T * (d * q + 2 * d * kv)    # layer 0 inputs
    bwd += L * 2 * att - (att // 2)                  # layer 0: no key grad
    # adapters: dxa and dB per site (2·T·out·r each), dA (2·T·r·in), and
    # the input gradient through A (2·T·r·in) except in layer 0
    bwd += L * (2 * T * rank * (2 * q + d) + 2 * T * rank * (2 * kv + d))
    bwd += (L - 1) * 2 * T * rank * 2 * d
    bwd += 2 * Tt * V * d                            # the head's input grad
    return float(fwd + bwd)


def round_flops(m: dict, fed: dict, text: int) -> float:
    """One round: every sampled client's local steps (its adapter computed
    at the global rank, as the program pads it)."""
    K = fed["num_clients"]
    n_s = max(int(round(fed["sample_rate"] * K)), 1)
    return n_s * fed["local_steps"] * local_step_flops(
        m, fed["batch_size"], text, max(fed["ranks"]))
