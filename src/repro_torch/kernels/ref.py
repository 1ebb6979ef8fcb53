"""Plain PyTorch versions of the hand-written kernels.

Each function here computes the function of its kernel in the simplest
way (O(S²) attention with the full score matrix, fp32 throughout) and is
the truth the kernels are held against: on the CPU the wrappers in
:mod:`repro_torch.kernels.ops` call these, and ``chip_smoke.py``
compares each kernel with its plain version on the card.  Mirrors
:mod:`repro.kernels.ref`.  (The flash kernel also rounds its
probabilities to v's dtype before the PV product, as the reference model
does; in bf16 that is inside the kernel tests' tolerance.)
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """Causal GQA attention, full materialized scores.

    q: (B, S, H, D); k, v: (B, S, K, D).  fp32 math, returns q.dtype.
    """
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) / math.sqrt(D)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return o.reshape(B, S, H, D).to(q.dtype)
