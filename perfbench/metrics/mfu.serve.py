"""The model step's share of the chip's bf16 peak: the frozen FLOPs of
every position the window's steps processed (``work/serve_step.py``;
streamed prompt tokens included, a mixture of experts its routed experts
only and its shared ones) over the traced window."""

from perfbench import peaks


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not rec["flops"]:
        return None
    return 100.0 * rec["flops"] / (tr["window_s"] * peaks.BF16_FLOPS)
