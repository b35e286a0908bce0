"""Checkpoint reading (the npz layout the reference package writes)."""

from repro_torch.checkpoint.io import load_pytree

__all__ = ["load_pytree"]
