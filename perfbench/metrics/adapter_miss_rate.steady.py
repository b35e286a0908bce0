"""Adapter bank (``serving/adapter_store.py``): misses over acquires in
the window, from ``paging_stats``."""


def read(rec: dict):
    p = rec["pager"]
    n = p["hits"] + p["misses"]
    return 100.0 * p["misses"] / n if n else None
