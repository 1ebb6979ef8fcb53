"""Gradient clipping by global norm — the port of
:mod:`repro.optim.clipping`."""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm), in float32, and cast
    back to the leaf's dtype.  Returns (new tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype)
            for k, x in tree.items()}, norm
