"""Nested-dict trees of tensors — the port's stand-in for JAX pytrees.

Parameter, adapter and optimizer-state trees are plain ``dict``s whose
leaves are tensors; these helpers walk them in sorted key order, the order
``jax.tree_util`` flattens a dict in.
"""

from __future__ import annotations

from typing import Any, Callable

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


__all__ = ["Tree", "tree_leaves", "tree_map"]
