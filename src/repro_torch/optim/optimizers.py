"""AdamW and SGD with momentum over nested-dict trees (port of
``repro/optim/optimizers.py``), with global-norm gradient clipping.

Updates are functional: ``update(params, grads, state)`` returns new trees
and never writes into its arguments.  The step counter is a Python int,
so the bias corrections and the schedule are host scalars (numpy float32,
as the reference computes them) and an update never waits for the device.
Moments are f32 whatever the parameter dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim.schedules import make_schedule

Tree = Any
_F = np.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | sgdm
    peak_lr: float = 1e-3
    schedule: str = "constant"   # constant | cosine | wsd
    total_steps: int = 1000
    warmup_steps: int = 0
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9
    grad_clip: float = 1.0       # 0 disables


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


class SGDMState(NamedTuple):
    step: int
    mom: Tree


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    """Scale ``grads`` so their joint L2 norm is at most ``max_norm``;
    returns (clipped grads, norm as a 0-d f32 tensor)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.where(gnorm > max_norm,
                        max_norm / torch.clamp(gnorm, min=1e-12),
                        torch.ones_like(gnorm))
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def adamw_init(params: Tree) -> AdamWState:
    return AdamWState(0, tree_map(_zeros_f32, params),
                      tree_map(_zeros_f32, params))


def adamw_update(params: Tree, grads: Tree, state: AdamWState,
                 cfg: OptimizerConfig, lr_fn: Callable
                 ) -> tuple[Tree, AdamWState]:
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_fn(step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(_F(1) - _F(b1) ** _F(step))
    c2 = float(_F(1) - _F(b2) ** _F(step))

    def upd(p, g, m, v):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32.square()
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return _pick(out, 0), AdamWState(step, _pick(out, 1), _pick(out, 2))


def _pick(tree: Tree, i: int) -> Tree:
    """Component ``i`` of a tree whose leaves are tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def sgdm_init(params: Tree) -> SGDMState:
    return SGDMState(0, tree_map(_zeros_f32, params))


def sgdm_update(params: Tree, grads: Tree, state: SGDMState,
                cfg: OptimizerConfig, lr_fn: Callable
                ) -> tuple[Tree, SGDMState]:
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_fn(step)

    def upd(p, g, m):
        m = cfg.momentum * m + g.float()
        return (p.float() - lr * m).to(p.dtype), m

    out = tree_map(upd, params, grads, state.mom)
    return _pick(out, 0), SGDMState(step, _pick(out, 1))


def make_optimizer(cfg: OptimizerConfig):
    """Returns (init_fn, update_fn(params, grads, state) -> (params, state))."""
    lr_fn = make_schedule(cfg.schedule, cfg.peak_lr, cfg.total_steps,
                          cfg.warmup_steps)
    if cfg.name == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(p, g, s, cfg, lr_fn)
    if cfg.name == "sgdm":
        return sgdm_init, lambda p, g, s: sgdm_update(p, g, s, cfg, lr_fn)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


__all__ = ["AdamWState", "OptimizerConfig", "SGDMState", "adamw_init",
           "adamw_update", "clip_by_global_norm", "make_optimizer",
           "sgdm_init", "sgdm_update"]
