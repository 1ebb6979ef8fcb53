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
from . import rglru as _rglru
from . import wkv6 as _wkv6

__all__ = ["attention", "wkv", "rglru"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int | None = None,
              softcap: float | None = None) -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, H, D); k, v: (B, S, KV, D)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, window=window, softcap=softcap)
    return _fa.flash_attention(q, k, v, window=window, softcap=softcap)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None = None, *,
        chunk: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 WKV.  r, k, v, w: (B, H, S, N); u: (H, N); s0:
    (B, H, N, N) or None.  Returns (y (B, H, S, N), s_final (B, H, N, N)),
    fp32.  ``chunk`` is the kernel's chunk length; the plain version walks
    the recurrence step by step."""
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    return _wkv6.wkv6(r, k, v, w, u, s0, chunk=chunk)


def rglru(a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The linear scan h_t = a_t h_{t−1} + b_t.  a, b: (B, S, R); h0:
    (B, R) or None.  Returns (h (B, S, R), h_final (B, R)), fp32."""
    if a.device.type == "cpu":
        h = ref.rglru_ref(a, b, h0)
        return h, h[:, -1]
    return _rglru.rglru_scan(a, b, h0)
