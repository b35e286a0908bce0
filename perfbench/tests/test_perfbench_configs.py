"""The configuration files: each loads into the port's ``ModelConfig``,
every published number it states is the one it runs (or is listed as cut,
assumed or departed from), and the reference's weights have the size the
file's deployment states.

A file states its published numbers either in a ``published`` group (in
the port's field names) or, for a model of the public catalog, as the
model's own ``config.json`` at its top level, each cut key at the value
it runs and under ``reduced`` as ``[published, run]``."""

from __future__ import annotations

import json

import pytest

from perfbench.tests.checkout import ROOT
from perfbench import harness
from perfbench.reference import hybrid, prefix_vlm

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in SPEC["configs"]}
#: the keys a configuration file has of its own, beside the model's
OWN = {"name", "source", "papers", "model", "published", "reduced",
       "assumed", "departures", "deployment"}
# published key -> how the model block holds it
HF = {"num_hidden_layers": lambda m: m["num_layers"],
      "hidden_size": lambda m: m["d_model"],
      "num_attention_heads": lambda m: m["num_heads"],
      "num_key_value_heads": lambda m: m["num_kv_heads"],
      "intermediate_size": lambda m: m["d_ff"],
      "vocab_size": lambda m: m["vocab_size"],
      "tie_word_embeddings": lambda m: m["tie_embeddings"],
      "rms_norm_eps": lambda m: m["norm_eps"],
      "rope_theta": lambda m: m["rope_theta"],
      "num_local_experts": lambda m: m["moe"]["num_experts"],
      "num_experts_per_tok": lambda m: m["moe"]["experts_per_token"],
      "shared_intermediate_size": lambda m: (m["moe"]["d_ff_shared"]
                                             * m["moe"]["num_shared_experts"]),
      "layer_types": lambda m: [{"attn": "attention"}.get(k, k)
                                for k in m["pattern"]]
      * (m["num_layers"] // len(m["pattern"])),
      "mamba_d_conv": lambda m: m["ssm"]["conv_width"],
      "mamba_expand": lambda m: m["ssm"]["expand"],
      "mamba_d_state": lambda m: m["ssm"]["state_dim"],
      "mamba_d_head": lambda m: m["ssm"]["head_dim"],
      "mamba_n_heads": lambda m: (m["ssm"]["expand"] * m["d_model"]
                                  // m["ssm"]["head_dim"]),
      "hidden_act": lambda m: "silu",
      "attention_bias": lambda m: m.get("qkv_bias", False),
      "mamba_conv_bias": lambda m: True,
      "mamba_proj_bias": lambda m: False,
      "normalization_function": lambda m: "rmsnorm"}
# published numbers of the language model (the port's field names)
PORT = {"num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "tie_embeddings", "vision_dim",
        "num_vision_tokens"}


def _published(c: dict) -> dict:
    """``key -> (published value, value run)``."""
    if "published" in c:
        return {k: (v, c["reduced"][k][1] if k in c["reduced"] else v)
                for k, v in c["published"].items()}
    return {k: (c["reduced"][k][0] if k in c["reduced"] else v, v)
            for k, v in c.items() if k not in OWN}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loads_into_the_ports_model_config(name):
    cfg = harness.model_config(CONFIGS[name])
    assert cfg.name == name and cfg.dtype == "bfloat16"
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert sorted(entry["reduced"]) == sorted(CONFIGS[name]["reduced"])
    assert CONFIGS[name]["source"] == entry["source"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_widths_are_the_published_numbers(name):
    c = CONFIGS[name]
    m = c["model"]
    norm = lambda t: t.lower().replace("_", "").replace("-", "").replace(
        " ", "")
    told = norm(" ".join(c["departures"])
                + " ".join(f"{k} {v}" for k, v in c["assumed"].items()))
    for key, (published, run) in _published(c).items():
        if key in c["reduced"]:
            assert c["reduced"][key] == [published, run]
        if key in PORT:
            got = m[key]
        elif key in HF:
            got = HF[key](m)
        else:
            got = None
        if got != run:
            assert norm(key.replace("mamba_", "")) in told, \
                f"{name}: {key} runs {got}, published {run}"


@pytest.mark.parametrize("name,billions", [("minicpm-v-2", 2.73),
                                           ("granite-h-small-10", 8.36)])
def test_the_weights_have_the_stated_size(name, billions):
    m = CONFIGS[name]["model"]
    ref = prefix_vlm if m["family"] == "vlm" else hybrid
    n = 0
    for shape, _, _ in ref.param_specs(m).values():
        k = 1
        for s in shape:
            k *= s
        n += k
    assert abs(n / 1e9 - billions) < 0.02, n
