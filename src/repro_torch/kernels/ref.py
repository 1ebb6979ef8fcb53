"""Plain PyTorch versions of the hand-written kernels.

Each function here computes the function of its kernel in the simplest
way (O(S²) attention with the full score matrix, decode attention over
every slot of the cache, the recurrence one step at a time, fp32
throughout) and is the truth the kernels are held
against: on the CPU the wrappers in
:mod:`repro_torch.kernels.ops` call these, and ``chip_smoke.py``
compares each kernel with its plain version on the card.  Mirrors
:mod:`repro.kernels.ref`.  (The flash kernel also rounds its
probabilities to v's dtype before the PV product, as the reference model
does; in bf16 that is inside the kernel tests' tolerance.)
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "decode_attention_ref", "wkv6_ref", "rglru_ref"]


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


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor, *,
                         softcap: float | None = None) -> torch.Tensor:
    """One-token GQA attention against a cache, the whole cache's scores.

    q: (B, 1, H, D); caches: (B, Sc, K, D); ``pos`` — the position of the
    current token, scalar or (B,).  The slots ``<= pos`` are valid, for a
    ring (slot = position mod Sc) as for a linear cache: slot s of a ring
    holds position pos − ((pos − s) mod Sc), which lies in [0, pos]
    exactly when s <= pos.  fp32 scores and softmax; the probabilities
    are rounded to the cache's dtype before the PV product, as the
    reference model does.  Returns (B, 1, H, D) in the cache's dtype.
    """
    B, _, H, D = q.shape
    Sc, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, 1, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)              # (B,K,G,1,Sc)
    slots = torch.arange(Sc, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    posb = pos if pos.dim() else pos.expand(B)
    posb = posb[:, None]                                   # (B, 1)
    valid = slots[None, :] <= posb
    s = s.masked_fill(~valid[:, None, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache)
    return o.reshape(B, 1, H, D)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             s0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV, step by step.  r, k, v, w: (B, H, S, N); u: (H, N); s0:
    (B, H, N, N) or None (zeros).  fp32 math; returns (y (B, H, S, N),
    s_final (B, H, N, N)), both fp32."""
    B, H, S, N = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    y = torch.empty((B, H, S, N), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        y[:, :, t] = torch.einsum("bhn,bhnm->bhm", r[:, :, t], s + u * kv)
        s = w[:, :, t, :, None] * s + kv
    return y, s


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t · h_{t−1} + b_t, step by step.  a, b: (B, S, R); h0:
    (B, R) or None (zeros).  fp32 math, returns all h, (B, S, R) fp32."""
    a = a.float()
    b = b.float()
    B, S, R = a.shape
    h = (torch.zeros((B, R), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs
