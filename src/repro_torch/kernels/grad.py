"""The formulas the kernel operators' gradients differentiate: torch ports
of the functions the reference's training path differentiates.

The JAX package has no backward kernel.  Its train step differentiates
the model code around each kernel's call site, and that code is not the
step-by-step oracle of :mod:`.ref` but a formula linear in S:

* K1 — :func:`chunked_attention`, the reference's ``gqa_attention``
  (``repro/models/layers.py``): queries in chunks of :data:`Q_CHUNK`,
  each chunk's scores against a key span of S on global layers and of
  ``window + Q_CHUNK`` (left-padded) on local ones, each chunk body
  checkpointed, so that one chunk's scores, probabilities and their
  gradients are alive at a time.  :func:`attention_grads` is its
  gradient taken chunk by chunk, which the operator runs: each chunk's
  scores recomputed and autograd's steps written out, the softmax's
  derivative applied in place, so that two of one chunk's score-sized
  tensors are alive at once and no output is formed;
* K2 — :func:`associative_scan`, the reference's ``rglru_scan``
  (``repro/models/rglru.py``): ``lax.associative_scan``'s odd/even
  recursion with the combine (a₁a₂, a₂b₁ + b₂), h0 folded into b₁.
  O(S) work in O(log S) levels, products only;
* K3 — :func:`chunked_wkv`, the reference's ``wkv6_chunked``
  (``repro/models/rwkv.py``): the intra-chunk terms of all chunks in one
  batched pass (pairwise decays, scores, the bonus, each chunk's
  k·decay·v sum), then the chunk-to-chunk state recursion, S/chunk
  steps of one (B, H, N, N) update, then the inter-chunk term batched.

Each computes in float32, as the plain version does, and returns what
the kernel returns; the results equal the plain version's within float32
rounding.  The clips are the reference's ``jnp.clip``: a maximum and a
minimum, whose gradient is split in half at a tie, as JAX splits it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["Q_CHUNK", "chunked_attention", "attention_grads",
           "attention_area", "associative_scan", "chunked_wkv"]

Tensor = torch.Tensor

#: the reference's ``gqa_attention`` default ``q_chunk``
Q_CHUNK = 512
#: the slices of a chunk's rows the softmax's derivative is applied in
_SOFTMAX_SLICES = 8
#: the reference's bound on the WKV's decay exponents (``rwkv._CLAMP``)
_CLAMP = 40.0


def _clip(x: Tensor, lo: float | None, hi: float | None) -> Tensor:
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


# -- K1 -------------------------------------------------------------------------


def _spans(S: int, window: int | None) -> list[tuple[int, int, int, int]]:
    """(q0, q1, k0, k1) a query chunk: its queries and its keys, the keys
    indexing k left-padded by ``window`` on local layers of more than
    one chunk."""
    if S <= Q_CHUNK:
        return [(0, S, 0, S)]
    out = []
    for q0 in range(0, S, Q_CHUNK):
        q1 = min(S, q0 + Q_CHUNK)
        out.append((q0, q1, q0, q1 + window) if window is not None
                   else (q0, q1, 0, S))
    return out


def attention_area(S: int, window: int | None) -> int:
    """Query-key pairs whose scores the chunks compute, masked ones
    included: Σ c·span over the query chunks."""
    return sum((q1 - q0) * (k1 - k0) for q0, q1, k0, k1 in _spans(S, window))


def _scores(qb: Tensor, kb: Tensor, G: int, q0: int, k0: int,
            window: int | None, softcap: float | None
            ) -> tuple[Tensor, Tensor | None]:
    """A chunk's masked float32 scores (B, K, c·G, span) and, with a
    softcap, its tanh.  qb: (B, K, c·G, D), G query heads a key head, at
    positions q0…; kb: (B, K, span, D) at positions k0… (below 0: the
    left padding)."""
    B, K, cG, D = qb.shape
    c, span = cG // G, kb.shape[2]
    s = torch.matmul(qb, kb.transpose(-1, -2)) / math.sqrt(D)
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qpos = q0 + torch.arange(c, device=qb.device)
    kpos = k0 + torch.arange(span, device=qb.device)
    mask = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] >= 0)
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.view(B, K, c, G, span).masked_fill(~mask[:, None], -math.inf)
    return s.view(B, K, cG, span), t


def _heads_first(qc: Tensor, kc: Tensor, vc: Tensor):
    """(B, c, K, G, D) → (B, K, c·G, D), so that each product contracts
    a key head's G query heads at once, in the order of the plain
    version's PV product; (B, span, K, D) → (B, K, span, D)."""
    B, c, K, G, D = qc.shape
    return (qc.transpose(1, 2).reshape(B, K, c * G, D),
            kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3))


def _attention_block(qc: Tensor, kc: Tensor, vc: Tensor, q0: int, k0: int,
                     window: int | None, softcap: float | None) -> Tensor:
    """One query chunk.  qc: (B, c, K, G, D) float32 at positions q0…;
    kc, vc: (B, span, K, D) float32 at positions k0….  Returns (B, c,
    K, G, D) float32."""
    B, c, K, G, D = qc.shape
    qb, kb, vb = _heads_first(qc, kc, vc)
    s, _ = _scores(qb, kb, G, q0, k0, window, softcap)
    o = torch.matmul(torch.softmax(s, dim=-1), vb)
    return o.view(B, K, c, G, D).transpose(1, 2)


def _attention_block_grads(qc: Tensor, kc: Tensor, vc: Tensor, go: Tensor,
                           q0: int, k0: int, window: int | None,
                           softcap: float | None
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """The gradients of :func:`_attention_block` for its output gradient
    ``go`` (B, c, K, G, D) float32, autograd's steps written out: the
    softmax's derivative applied in place, a slice of rows at a time, so
    that two of the chunk's score-sized tensors are alive at once (three
    with a softcap), and each product summing in the order of the plain
    version's.  Returns (dq (B, c, K, G, D), dk, dv (B, span, K, D))."""
    B, c, K, G, D = qc.shape
    qb, kb, vb = _heads_first(qc, kc, vc)
    gb = go.transpose(1, 2).reshape(B, K, c * G, D)
    s, t = _scores(qb, kb, G, q0, k0, window, softcap)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.matmul(p.transpose(-1, -2), gb)
    ds = torch.matmul(gb, vb.transpose(-1, -2))            # ∂p
    # contiguous slices of rows: the derivative copies no operand
    flat_ds, flat_p = ds.view(-1, ds.shape[-1]), p.view(-1, p.shape[-1])
    rows = -(-flat_ds.shape[0] // _SOFTMAX_SLICES)
    for r in range(0, flat_ds.shape[0], rows):
        flat_ds[r:r + rows] = torch.ops.aten._softmax_backward_data(
            flat_ds[r:r + rows], flat_p[r:r + rows], -1, torch.float32)
    del p, flat_p
    if t is not None:
        # s = softcap · tanh(s₀ / softcap)
        ds = torch.ops.aten.tanh_backward(ds.mul_(softcap), t)
        ds.div_(softcap)
        del t
    ds.div_(math.sqrt(D))
    dq = torch.matmul(ds, kb)
    # the key gradient sums over (head, query), as the plain version's
    # QK product orders its rows
    ds = ds.view(B, K, c, G, -1).transpose(2, 3).reshape(B, K, G * c, -1)
    qg = qb.view(B, K, c, G, D).transpose(2, 3).reshape(B, K, G * c, D)
    dk = torch.matmul(ds.transpose(-1, -2), qg)
    return (dq.view(B, K, c, G, D).transpose(1, 2),
            dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def _attention_operands(q, k, v, window):
    """q as (B, S, K, G, D) float32; k and v float32, left-padded by
    ``window`` where the chunks are local; the key offset of index 0."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, D)
    kf, vf = k.float(), v.float()
    if window is not None and S > Q_CHUNK:
        kf = F.pad(kf, (0, 0, 0, 0, window, 0))
        vf = F.pad(vf, (0, 0, 0, 0, window, 0))
        return qf, kf, vf, -window
    return qf, kf, vf, 0


def chunked_attention(q: Tensor, k: Tensor, v: Tensor,
                      window: int | None = None,
                      softcap: float | None = None) -> Tensor:
    """Causal GQA attention as the reference's ``gqa_attention`` trains
    it: over query chunks of :data:`Q_CHUNK`, each checkpointed.  q: (B,
    S, H, D); k, v: (B, S, K, D); any S (a last chunk may be short).
    Float32 arithmetic; returns q's dtype."""
    B, S, H, D = q.shape
    qf, kf, vf, off = _attention_operands(q, k, v, window)
    outs = [checkpoint(_attention_block, qf[:, q0:q1], kf[:, k0:k1],
                       vf[:, k0:k1], q0, k0 + off, window, softcap,
                       use_reentrant=False)
            for q0, q1, k0, k1 in _spans(S, window)]
    return torch.cat(outs, dim=1).reshape(B, S, H, D).to(q.dtype)


@torch.no_grad()
def attention_grads(q: Tensor, k: Tensor, v: Tensor, go: Tensor,
                    window: int | None = None,
                    softcap: float | None = None) -> list[Tensor]:
    """The gradients of :func:`chunked_attention` with respect to q, k
    and v for the output gradient ``go``, chunk by chunk: each chunk's
    scores recomputed and its backward written out, the key gradients
    summed over the chunks.  Returns them in their inputs' dtypes."""
    B, S, H, D = q.shape
    qf, kf, vf, off = _attention_operands(q, k, v, window)
    gof = go.float().reshape(qf.shape)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dq = []
    for q0, q1, k0, k1 in _spans(S, window):
        gq, gk, gv = _attention_block_grads(
            qf[:, q0:q1], kf[:, k0:k1], vf[:, k0:k1], gof[:, q0:q1], q0,
            k0 + off, window, softcap)
        dq.append(gq)
        dk[:, k0:k1] += gk
        dv[:, k0:k1] += gv
        del gq, gk, gv
    lo = dk.shape[1] - S
    return [torch.cat(dq, dim=1).reshape(B, S, H, D).to(q.dtype),
            dk[:, lo:].to(k.dtype), dv[:, lo:].to(v.dtype)]


# -- K2 -------------------------------------------------------------------------


def _combine(a1: Tensor, b1: Tensor, a2: Tensor, b2: Tensor
             ) -> tuple[Tensor, Tensor]:
    """The RG-LRU's monoid: step (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    """even[0], odd[0], even[1], … along dimension 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = F.pad(odd, (0, 0, 0, 1))
    both = torch.stack([even, odd], dim=2)
    return both.reshape(even.shape[0], -1, even.shape[2])[:, :n]


def _scan(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """``lax.associative_scan(combine, (a, b), axis=1)``, recursion for
    recursion."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan(*_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                   a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ev_a, ev_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2],
                              b[:, 2::2])
    else:
        ev_a, ev_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def associative_scan(a: Tensor, b: Tensor, h0: Tensor | None = None
                     ) -> tuple[Tensor, Tensor]:
    """h_t = a_t h_{t−1} + b_t as the reference's ``rglru_scan`` computes
    it: h0 folded into b₁, then the associative scan.  a, b: (B, S, R);
    h0: (B, R) or None.  Returns (h (B, S, R), h[:, −1]), float32."""
    a, b = a.float(), b.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    _, h = _scan(a, b)
    return h, h[:, -1]


# -- K3 -------------------------------------------------------------------------


def chunked_wkv(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                s0: Tensor | None = None, chunk: int = 16
                ) -> tuple[Tensor, Tensor]:
    """The RWKV-6 WKV as the reference's ``wkv6_chunked`` computes it,
    with the intra-chunk terms of every chunk batched.  r, k, v, w: (B,
    H, S, N); u: (H, N); s0: (B, H, N, N) or None.  Returns (y (B, H, S,
    N), s_final (B, H, N, N)), float32."""
    B, H, S, N = r.shape
    L = chunk
    r, k, v, w = (t.float() for t in (r, k, v, w))
    s = r.new_zeros((B, H, N, N)) if s0 is None else s0.float()
    pad = -S % L
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, pad), value=1.0)
    n = (S + pad) // L
    rc, kc, vc, wc = (t.reshape(B, H, n, L, N) for t in (r, k, v, w))
    lw = torch.log(_clip(wc, 1e-38, None))                 # ≤ 0
    cum = torch.cumsum(lw, dim=3)                          # lc_t
    cum_ex = cum - lw                                      # lc_{t−1}
    # D[t, s] = exp(lc_{t−1} − lc_s), exact for s < t
    decay = torch.exp(_clip(cum_ex[..., :, None, :] - cum[..., None, :, :],
                            -_CLAMP, 0.0))                 # (B,H,n,L,L,N)
    scores = (rc[..., :, None, :] * kc[..., None, :, :] * decay).sum(-1)
    mask = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(mask, scores, 0.0)                # (B,H,n,L,L)
    bonus = (rc * (u.float()[None, :, None, None, :] * kc)).sum(-1)
    y = torch.matmul(scores, vc) + bonus[..., None] * vc
    tail = cum[..., -1:, :]                                # lc_L
    k_tail = kc * torch.exp(_clip(tail - cum, -_CLAMP, 0.0))
    kv = torch.matmul(k_tail.transpose(-1, -2), vc)        # (B,H,n,N,N)
    carry = torch.exp(_clip(tail, -_CLAMP, 0.0)).transpose(-1, -2)
    states = []
    for carry_c, kv_c in zip(carry.unbind(2), kv.unbind(2)):
        states.append(s)
        s = carry_c * s + kv_c
    r_dec = rc * torch.exp(_clip(cum_ex, -_CLAMP, 0.0))
    y = y + torch.matmul(r_dec, torch.stack(states, dim=2))
    return y.reshape(B, H, n * L, N)[:, :, :S], s
