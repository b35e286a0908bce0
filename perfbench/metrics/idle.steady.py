"""The device's idle share of the traced window: 1 − the union of its
kernel, copy and memset intervals over the window."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
