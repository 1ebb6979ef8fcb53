"""AdamW — the port of :mod:`repro.optim.adamw`.

The reference's math, leaf by leaf: the moments and the step in float32,
cast on store to ``state_dtype`` and to each parameter's dtype; weight
decay inside the step (``p − lr·(m̂/(√v̂+ε) + wd·p)``); bias corrections
``1 − b**count`` in float32.  ``torch.optim.AdamW`` is not used: on
bfloat16 parameters it does its math in bfloat16, decays before the
step and has no ``state_dtype``.  On one card there is nothing to shard,
so the reference's ``opt_state_specs`` has no counterpart.

The port stores in place (the parameters and the moments), which keeps
one copy of the state alive instead of the reference's two; the values
are those of the reference's functional update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"


def adamw_init(params: Mapping[str, torch.Tensor],
               cfg: AdamWConfig) -> dict:
    """``{"mu", "nu"}``: zeros in ``cfg.state_dtype`` beside each
    parameter; ``"count"``: an int32 scalar on the parameters' device."""
    dt = _DTYPES[cfg.state_dtype]
    device = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in params.items()}
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0
                 ) -> tuple[Mapping[str, torch.Tensor], dict]:
    """One step.  Returns (params, new state): ``params`` and the
    moments are updated in place, ``count`` is a new tensor."""
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    lr = cfg.lr * lr_scale
    for k, p in params.items():
        g32 = grads[k].float()
        m, v = state["mu"][k], state["nu"][k]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
        mhat = m32 / b1c
        vhat = v32 / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m32)
        v.copy_(v32)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}
