"""Optimizers and learning-rate schedules over adapter trees (port of
``repro/optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdamWState,
    OptimizerConfig,
    SGDMState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_optimizer,
    sgdm_init,
    sgdm_update,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    make_schedule,
    wsd_schedule,
)
