"""Optimizer, schedule and clipping — the port of :mod:`repro.optim`.

Trees are dicts of tensors keyed by the port's parameter names
(``dict(model.named_parameters())``); every function keeps the
reference's math and dtypes."""

from .adamw import AdamWConfig, adamw_init, adamw_update, opt_state_specs
from .schedules import cosine_warmup
from .clipping import (global_norm, clip_by_global_norm,
                       clip_by_global_norm_)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "opt_state_specs",
           "cosine_warmup", "global_norm", "clip_by_global_norm",
           "clip_by_global_norm_"]
