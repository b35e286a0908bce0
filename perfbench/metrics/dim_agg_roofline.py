"""The aggregation kernel's share of its roofline: the cohort tree's work
(``work/dim_agg.py``: every client leaf read once, the global written
once) at the data-sheet peaks, over the device time of the kernels
listed here.  Until the port has a profiler range around the
aggregation, the kernel is found by name; if it never ran the metric
raises."""

from perfbench import peaks
from perfbench.tracing import kernel_seconds

KERNELS = ("dim_agg_kernel",)


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not rec["rounds"]:
        return None
    n, s = kernel_seconds(tr, KERNELS)
    if n == 0 or s <= 0:
        raise RuntimeError(f"none of {KERNELS} ran in the window")
    f, b = rec["dim_agg_work_per_round"]
    return 100.0 * peaks.roofline_seconds(f * n, b * n) / s
