"""Trainer layer (``federated/runtime.py``): the median wall of the
window's rounds, from the port's host ``round`` span, which ends in the
round's metrics fetch (a sync)."""

import statistics


def read(rec: dict):
    walls = rec.get("round_walls")
    return statistics.median(walls) if walls else None
