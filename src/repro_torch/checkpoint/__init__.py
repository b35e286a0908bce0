"""Checkpoints in the reference package's npz layout: trees and the
federated trainer's state, readable and writable by either package."""

from repro_torch.checkpoint.io import (load_federated, load_pytree,
                                       save_federated, save_pytree)

__all__ = ["load_federated", "load_pytree", "save_federated", "save_pytree"]
