"""Read the flat-key npz layout of the reference's ``save_pytree``
(``repro/checkpoint/io.py``): keys are dict paths joined by "/", values
are arrays.  numpy only."""

from __future__ import annotations

from typing import Any

import numpy as np

_SEP = "/"


def load_pytree(path: str) -> dict[str, Any]:
    """Nested dict of numpy arrays from a ``save_pytree`` npz file."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = root
            parts = key.split(_SEP)
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = data[key]
    return root


__all__ = ["load_pytree"]
