"""The fused round step's share of the chip's bf16 peak: the frozen model
FLOPs of the window's rounds (``work/train_step.py``) over the traced
window."""

from perfbench import peaks


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not rec["rounds"]:
        return None
    return (100.0 * rec["flops_per_round"] * rec["rounds"]
            / (tr["window_s"] * peaks.BF16_FLOPS))
