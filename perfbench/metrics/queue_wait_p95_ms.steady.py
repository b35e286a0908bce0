"""Engine admission: the 95th percentile, over the requests due in the
window, of due → admitted (``Request.admitted_at``), in ms."""


def read(rec: dict):
    return rec.get("queue_wait_p95_ms")
