"""Architecture registry: 10 assigned architectures + paper-proxy bench models.

Each ``<arch>.py`` module defines ``CONFIG`` (the exact assigned full-scale
configuration, exercised only via the dry-run) and ``REDUCED`` (the same
family at smoke-test scale: ≤2 layers, d_model ≤ 512, ≤4 experts)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "gemma3-12b",
    "minicpm-2b",
    "llama4-scout-17b-a16e",
    "llama-3.2-vision-11b",
    "mamba2-130m",
    "jamba-v0.1-52b",
    "seamless-m4t-medium",
    "qwen2-72b",
    "deepseek-v2-236b",
    "qwen2-0.5b",
    # paper-proxy federated bench models (LLaVA-style prefix VLM)
    "fedbench-100m",
    "fedbench-tiny",
]


def _module(name: str):
    return importlib.import_module("repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return _module(name).CONFIG


def get_reduced_config(name: str) -> ModelConfig:
    return _module(name).REDUCED


def list_archs(include_bench: bool = False) -> list[str]:
    return [a for a in ARCHS if include_bench or not a.startswith("fedbench")]
