"""Gradient clipping by global norm — the port of
:mod:`repro.optim.clipping`."""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["global_norm", "clip_by_global_norm", "clip_by_global_norm_"]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _scale(tree: Mapping[str, torch.Tensor], max_norm: float
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global norm and min(1, max_norm / norm), in float32."""
    norm = global_norm(tree)
    return norm, torch.clamp(max_norm / torch.clamp(norm, min=1e-9),
                             max=1.0)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm), in float32, and cast
    back to the leaf's dtype.  Returns (new tree, norm)."""
    norm, scale = _scale(tree, max_norm)
    return {k: (x.float() * scale).to(x.dtype)
            for k, x in tree.items()}, norm


@torch.no_grad()
def clip_by_global_norm_(tree: Mapping[str, torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """:func:`clip_by_global_norm` in place: the same values, written
    into each leaf, so that no second copy of the tree is alive (a float32
    leaf is scaled with no temporary at all).  Returns the norm."""
    norm, scale = _scale(tree, max_norm)
    for x in tree.values():
        if x.dtype == torch.float32:
            x.mul_(scale)
        else:
            x.copy_(x.float() * scale)
    return norm
