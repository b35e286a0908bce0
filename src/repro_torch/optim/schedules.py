"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

Each schedule maps an integer step to a Python float, computed in numpy
float32 as the reference computes it in jnp float32, so both packages use
the same learning rate to the bit.  The step counter lives on the host,
so reading the schedule never waits for the device.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def constant_schedule(peak_lr: float):
    def lr(step):
        return float(_F(peak_lr))
    return lr


def cosine_schedule(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1):
    """Linear warmup then cosine decay to ``final_frac * peak_lr``."""

    def lr(step):
        step = _F(step)
        warm = _F(peak_lr) * step / _F(max(warmup_steps, 1))
        t = (step - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1))
        t = np.clip(t, _F(0.0), _F(1.0))
        cos = _F(final_frac) + _F((1 - final_frac) * 0.5) * (
            _F(1) + np.cos(_F(np.pi) * t))
        return float(warm if step < warmup_steps else _F(peak_lr) * cos)

    return lr


def wsd_schedule(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay: linear warmup, a stable plateau at
    ``peak_lr``, then an exponential decay over the final ``decay_frac``."""
    decay_steps = max(int(total_steps * decay_frac), 1)
    stable_end = total_steps - decay_steps

    def lr(step):
        step = _F(step)
        warm = _F(peak_lr) * step / _F(max(warmup_steps, 1))
        t = np.clip((step - _F(stable_end)) / _F(decay_steps), _F(0.0),
                    _F(1.0))
        decay = _F(peak_lr) * np.exp(np.log(_F(final_frac)) * t)
        out = warm if step < warmup_steps else _F(peak_lr)
        return float(decay if step > stable_end else out)

    return lr


def make_schedule(name: str, peak_lr: float, total_steps: int,
                  warmup_steps: int = 0):
    if name == "constant":
        return constant_schedule(peak_lr)
    if name == "cosine":
        return cosine_schedule(peak_lr, total_steps, warmup_steps)
    if name == "wsd":
        return wsd_schedule(peak_lr, total_steps, warmup_steps)
    raise ValueError(f"unknown schedule {name!r}")


__all__ = ["constant_schedule", "cosine_schedule", "make_schedule",
           "wsd_schedule"]
