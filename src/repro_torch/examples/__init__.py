"""The reference's six examples (``examples/*.py``) as the port's entry
points, one module each, run as ``python -m repro_torch.examples.<name>``:

* ``heterogeneous_ranks`` — Eq. 4's dimension-wise weights and the
  dilution FediLoRA avoids;
* ``quickstart`` — 10 fedbench-tiny clients, 8 FediLoRA rounds with Min-1
  A-only editing, global and personalized BLEU/RSUM;
* ``async_rounds`` — blocking, pipelined and FedBuff timelines;
* ``federated_finetune`` — FediLoRA against HetLoRA under 60 % missing
  modalities on fedbench-100m;
* ``serve_decode`` — per-family decode caches of qwen2, Mamba-2 and MLA;
* ``serve_multitenant`` — train, page the adapters into a smaller bank,
  then serve a mixed stream continuously.

Each prints its reference counterpart's lines in the same format, takes
``--device`` (default ``cuda``; without a CUDA device it raises unless
``--device cpu``), and runs nothing when imported.  The bodies are
functions with keyword arguments that return what they print."""

from __future__ import annotations

import argparse

EXAMPLES = ("heterogeneous_ranks", "quickstart", "async_rounds",
            "federated_finetune", "serve_decode", "serve_multitenant")


def device_parser(description: str | None = None) -> argparse.ArgumentParser:
    """An argument parser with the examples' one common flag."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the port on the CPU)")
    return ap


__all__ = ["EXAMPLES", "device_parser"]
