"""Dispatch between each kernel and its plain version, by device.

A CPU tensor goes to the plain PyTorch version in :mod:`.ref` (the CPU
tests, and the truth the kernels are held against).  A CUDA tensor goes
to the hand-written kernel; if the kernel cannot be built or launched
the call raises — nothing falls back to the plain version on the card.
Mirrors :mod:`repro.kernels.ops`, whose ``impl=`` switch this replaces.
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import ref

__all__ = ["attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int | None = None,
              softcap: float | None = None) -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, H, D); k, v: (B, S, KV, D)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, window=window, softcap=softcap)
    return _fa.flash_attention(q, k, v, window=window, softcap=softcap)
