"""The yardstick's peaks: NVIDIA's data sheet for one H100 SXM (dense
rates, no sparsity), frozen here so that no change to the program moves
them.  Every run records the card's name and power limit beside them: the
rates assume the full 700 W, and a card set below it runs slower under
load."""

import subprocess

BF16_FLOPS = 989e12        # FLOP/s, bf16 / fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3


def roofline_seconds(flops: float, bytes_moved: float) -> float:
    """The least time the chip could take for this work: the larger of its
    bf16 operations over the peak rate and its bytes over the peak
    bandwidth."""
    return max(flops / BF16_FLOPS, bytes_moved / HBM_BYTES_PER_S)


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (``None`` where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None
