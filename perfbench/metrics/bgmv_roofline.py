"""The BGMV kernel's share of its roofline: the operation's work at each
step's shapes (``work/bgmv.py``: x, W, the distinct adapters' A and B
read once, y written once) at the data-sheet peaks, over the device time
of the kernels listed here.  Until the port has a profiler range around
the operation, its kernels are found by name; if none ran the metric
raises."""

from perfbench import peaks
from perfbench.tracing import kernel_seconds

KERNELS = ("shrink_kernel", "base_expand_kernel")


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not rec["steps"]:
        return None
    n, s = kernel_seconds(tr, KERNELS)
    if n == 0 or s <= 0:
        raise RuntimeError(f"none of {KERNELS} ran in the window")
    f, b = rec["bgmv_work"]
    return 100.0 * peaks.roofline_seconds(f, b) / s
