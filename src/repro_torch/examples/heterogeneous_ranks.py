"""Anatomy of dimension-wise aggregation (paper Sec. 3.1, Fig. 2).

Builds four clients with ranks (2, 4, 4, 8), shows the per-dimension weight
matrix p̃, and contrasts FediLoRA's aggregate with HetLoRA's zero-pad average
on the exact rows only the high-rank client populates — the information-
dilution effect of paper Fig. 5, in miniature.

Run:  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_ranks
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aggregation as AG
from repro_torch.core.lora import (LoRAConfig, LoRASpec, init_lora_params,
                                   mask_lora_params)
from repro_torch.examples import device_parser
from repro_torch.launch.fedround import stack_trees

RANKS = (2, 4, 4, 8)
SIZES = (100.0, 100.0, 100.0, 100.0)
SPEC = LoRASpec("layer0.wq", 16, 16, 1)


def client_stack(ranks, r_g: int, device) -> dict:
    """The clients' adapters stacked ``[K, ...]``: client ``i``'s A from a
    generator seeded ``i`` and its B ~ N(0, 1) from one seeded ``10 + i``,
    each masked to the client's rank."""
    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    loras = []
    for i, r in enumerate(ranks):
        lo = init_lora_params([SPEC], LoRAConfig(rank=r_g),
                              client_rank=int(r), generator=gen(i))
        b = torch.randn(lo[SPEC.name]["B"].shape, device=device,
                        generator=gen(10 + i))
        lo = {SPEC.name: {"A": lo[SPEC.name]["A"], "B": b}}
        loras.append(mask_lora_params(lo, int(r), r_g))
    return stack_trees(loras)


def run(*, stack=None, device=None) -> dict:
    """The weights p̃ [K, r_g], their column sums, and the norms of rows
    4..8 of A: the rank-8 client's, FediLoRA's and HetLoRA's (beta 0).
    ``stack``: the clients' adapters (default :func:`client_stack`)."""
    device = resolve_device(device)
    ranks = torch.tensor(RANKS, device=device)
    sizes = np.asarray(SIZES)
    p = torch.tensor(sizes / sizes.sum(), dtype=torch.float32, device=device)
    r_g = max(RANKS)
    w = AG.dimension_wise_weights(ranks, p, r_g)
    if stack is None:
        stack = client_stack(RANKS, r_g, device)
    fed = AG.fedilora(stack, ranks, p)
    het = AG.hetlora(stack, ranks, p, beta=0.0)
    a = SPEC.name
    rows = {"client": stack[a]["A"][3, 0, 4:, :],   # dims only client 3 has
            "fedilora": fed[a]["A"][0, 4:, :],
            "hetlora": het[a]["A"][0, 4:, :]}
    return {"ranks": list(RANKS), "r_g": r_g, "w": w.cpu().numpy(),
            "col_sums": w.sum(0).cpu().numpy(),
            "norms": {k: float(np.linalg.norm(v.cpu().numpy()))
                      for k, v in rows.items()}}


def main(argv=None) -> dict:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    rec = run(device=args.device)
    with np.printoptions(precision=3, suppress=True):
        print("client ranks:", rec["ranks"], "| global rank r_g =",
              rec["r_g"])
        print("\ndimension-wise weights p̃[k, d] (rows = clients, cols = "
              "rank dims):")
        print(rec["w"])
        print("column sums (each covered dim renormalises to 1):",
              rec["col_sums"])
    n = rec["norms"]
    print("\nrows 4..8 exist only in the rank-8 client:")
    print(f"  ‖client row‖      = {n['client']:.3f}")
    print(f"  ‖FediLoRA row‖    = {n['fedilora']:.3f}   (verbatim — no "
          "dilution)")
    print(f"  ‖HetLoRA row‖     = {n['hetlora']:.3f}   (divided by K=4)")
    return rec


if __name__ == "__main__":
    main()
