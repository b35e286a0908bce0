"""Frozen count of one multi-adapter projection (BGMV), ``y[m] = x[m] W +
s·(x[m] A[i_m]ᵀ) B[i_m]ᵀ`` over ``M`` rows: ``x``, ``W``, the distinct
adapters' ``A`` and ``B`` each read once, ``y`` written once, and
``2·M·K·N + 2·M·r·(K + N)`` FLOPs (``r`` the bank's padded rank)."""

from __future__ import annotations


def call_work(M: int, K: int, N: int, rank: int, adapters: int,
              itemsize: int = 2, adapter_itemsize: int = 2
              ) -> tuple[float, float]:
    flops = 2 * M * K * N + 2 * M * rank * (K + N)
    bytes_moved = ((M * K + K * N + M * N) * itemsize
                   + adapters * rank * (K + N) * adapter_itemsize)
    return float(flops), float(bytes_moved)


def step_work(sites: dict, M: int, rank: int, adapters: int,
              itemsize: int = 2, adapter_itemsize: int = 2
              ) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode step's calls: one per site and
    layer (``sites``: ``name -> (in, out, layers)``)."""
    f = b = 0.0
    for d_in, d_out, n in sites.values():
        cf, cb = call_work(M, d_in, d_out, rank, adapters, itemsize,
                           adapter_itemsize)
        f += n * cf
        b += n * cb
    return f, b
