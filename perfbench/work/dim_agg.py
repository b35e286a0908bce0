"""Frozen count of one dimension-wise aggregation (FediLoRA Eq. 5) over a
cohort's stacked adapter tree: every client's leaf read once, the global
leaf written once (f32 by default), plus the ``[K, r]`` weights.  Two
FLOPs (a multiply and an add) per input element."""

from __future__ import annotations


def tree_work(sites: dict, clients: int, rank: int, itemsize: int = 4
              ) -> tuple[float, float]:
    """(FLOPs, bytes) of aggregating ``clients`` adapters at the padded
    ``rank`` over ``sites`` (``name -> (in, out, layers)``)."""
    elems = sum(n * rank * (d_in + d_out)
                for d_in, d_out, n in sites.values())
    bytes_moved = (clients + 1) * elems * itemsize + clients * rank * 4
    return float(2 * clients * elems), float(bytes_moved)
