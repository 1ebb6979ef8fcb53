"""Core transformer layers: RMSNorm, RoPE, GQA attention, gated MLPs and
the KV-cache decode attention — the port of :mod:`repro.models.layers`;
and the attention block with a mixture of experts (:class:`MoELayer`,
the experts in :mod:`.moe`).

Layouts are the reference's: activations ``(B, S, d)``, q ``(B, S, H, D)``,
k and v ``(B, S, KV, D)``, caches ``(B, Sc, KV, D)``, weights ``(in, out)``
as used in ``x @ W``.  Full-sequence attention goes through
:func:`repro_torch.kernels.ops.attention`, which launches the flash
kernel on the card; one-token decode attention through
:func:`repro_torch.kernels.ops.decode_attention`, which launches the
split-KV decode kernel (K4) there, where the reference computes it in
plain ``jnp`` outside any kernel.

Mixed dtypes follow the reference's promotion: where JAX promotes a
bfloat16 operand against a float32 one, the port casts explicitly.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..trace import spans

__all__ = [
    "rmsnorm", "rope", "gqa_attention", "decode_gqa_attention",
    "mlp_apply", "MLP", "AttnLayer", "MoELayer", "init_mlp",
    "init_attn_layer", "fill_attn_layer", "fill_moe_layer", "ZERO_INIT",
]


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return ((1.0 + w.float()) * x).to(dt)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x: (..., S, H, D); pos:
    broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = pos.float()[..., None] * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """Causal grouped-query attention over a full sequence.

    q: (B, S, H, D); k, v: (B, S, K, D) with H = K·G.  The forward is
    the flash kernel, which never materializes scores; the gradient is
    the reference's: query chunks of 512, each chunk's scores recomputed
    and differentiated on its own, so that the backward holds one
    chunk's (B, K, G, 512, span) scores, not (B, H, S, S)
    (:mod:`repro_torch.kernels.grad`).
    """
    return ops.attention(q, k, v, window=window, softcap=softcap)


def decode_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor, *,
                         ring: bool,
                         softcap: float | None = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, D); caches: (B, Sc, K, D); ``pos`` — the position of the
    current token, scalar (homogeneous batch) or (B,) vector (continuous
    batching: every slot at its own depth).  ``ring=True`` means the
    cache is a ring buffer (slot = position mod Sc); the JAX reference's
    parameter, kept for parity: both layouts keep the slots ``<= pos``,
    so the operator takes no ``ring``.  Keys are stored post-RoPE.
    Returns (B, 1, H, D) in the cache's dtype.  On the card this is K4,
    which reads each valid slot of the cache once; on the CPU its plain
    version, :func:`repro_torch.kernels.ref.decode_attention_ref`.
    """
    pos = torch.as_tensor(pos, device=q.device)
    return ops.decode_attention(q, k_cache, v_cache, pos, softcap=softcap)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_apply(x: torch.Tensor, p: Mapping[str, torch.Tensor],
              kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w1"], approximate="tanh") * (x @ p["w3"])
    elif kind == "gelu":
        h = F.gelu(x @ p["w1"], approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ p["w2"]


def _param(shape: tuple[int, ...], dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: torch.Tensor, std: float,
             generator: torch.Generator) -> None:
    """Fill ``p`` with N(0, std²), drawn in float32 on the generator's
    device and cast to ``p``'s dtype and device."""
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    p.copy_(x * std)


class MLP(nn.Module):
    """Gated (swiglu / geglu) or plain (gelu) MLP, weights ``(in, out)``."""

    def __init__(self, d: int, ff: int, kind: str, *, dtype,
                 device) -> None:
        super().__init__()
        self.kind = kind
        self.w1 = _param((d, ff), dtype, device)
        self.w2 = _param((ff, d), dtype, device)
        if kind in ("swiglu", "geglu"):
            self.w3 = _param((d, ff), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(x, dict(self.named_parameters(recurse=False)),
                         self.kind)


def _fill_mlp(m: MLP, generator: torch.Generator) -> None:
    d, ff = m.w1.shape
    _normal_(m.w1, 1.0 / math.sqrt(d), generator)
    _normal_(m.w2, 1.0 / math.sqrt(ff), generator)
    if m.kind in ("swiglu", "geglu"):
        _normal_(m.w3, 1.0 / math.sqrt(d), generator)


@torch.no_grad()
def init_mlp(generator: torch.Generator, d: int, ff: int, kind: str, *,
             dtype, device) -> MLP:
    """A :class:`MLP` with the reference's init scales: N(0, 1/d) for the
    input projections, N(0, 1/ff) for the output one."""
    m = MLP(d, ff, kind, dtype=dtype, device=device)
    _fill_mlp(m, generator)
    return m


class AttnLayer(nn.Module):
    """One attention block: pre-norm GQA attention and pre-norm MLP, each
    with a residual.  Parameter names follow the reference's tree."""

    def __init__(self, cfg, *, dtype, device) -> None:
        super().__init__()
        d, H, K, D = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.cfg = cfg
        self.ln1 = _param((d,), dtype, device)
        self.wq = _param((d, H * D), dtype, device)
        self.wk = _param((d, K * D), dtype, device)
        self.wv = _param((d, K * D), dtype, device)
        self.wo = _param((H * D, d), dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self._make_ffn(cfg, dtype=dtype, device=device)
        if cfg.qkv_bias:
            self.bq = _param((H * D,), dtype, device)
            self.bk = _param((K * D,), dtype, device)
            self.bv = _param((K * D,), dtype, device)
        if cfg.post_norms:
            self.ln1_post = _param((d,), dtype, device)
            self.ln2_post = _param((d,), dtype, device)

    def _make_ffn(self, cfg, *, dtype, device) -> None:
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, dtype=dtype,
                       device=device)

    def qkv(self, h: torch.Tensor, positions: torch.Tensor):
        """Normed projections with RoPE: q (B,S,H,D), k and v (B,S,K,D)."""
        cfg = self.cfg
        B, S, _ = h.shape
        x = rmsnorm(h, self.ln1, cfg.norm_eps)
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.kv_heads, cfg.head_dim)
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta), v)

    def _attn_residual(self, h: torch.Tensor, o: torch.Tensor):
        """Output projection of the attention output ``o`` (B, S, H, D)
        added to the residual; returns the new residual and its norm, the
        input of the block's second half."""
        cfg = self.cfg
        B, S, _ = h.shape
        o = o.reshape(B, S, -1).to(h.dtype) @ self.wo
        if cfg.post_norms:
            o = rmsnorm(o, self.ln1_post, cfg.norm_eps)
        h = h + o
        return h, rmsnorm(h, self.ln2, cfg.norm_eps)

    def _ffn_residual(self, h: torch.Tensor, m: torch.Tensor):
        if self.cfg.post_norms:
            m = rmsnorm(m, self.ln2_post, self.cfg.norm_eps)
        return h + m

    def attend(self, q, k, v, local: bool) -> torch.Tensor:
        window = self.cfg.window if local else None
        return gqa_attention(q, k, v, window=window,
                             softcap=self.cfg.attn_softcap)

    def finish(self, h: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Output projection, residual, and the MLP half of the block.
        ``o`` is the attention output (B, S, H, D)."""
        h, x = self._attn_residual(h, o)
        return self._ffn_residual(h, self.mlp(x))

    def forward(self, h: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False):
        """Full-sequence block.  Returns (h, k, v) — the post-RoPE keys
        and the values."""
        with spans.span("model.attn"):
            q, k, v = self.qkv(h, positions)
            o = self.attend(q, k, v, local)
        with spans.span("model.ffn"):
            return self.finish(h, o), k, v


class MoELayer(AttnLayer):
    """An attention block with the mixture of experts (``moe``, a
    :class:`~.moe.MoE`) in place of the MLP, as the reference's MoE
    layer.  :meth:`finish` returns ``(h, aux)`` and :meth:`forward`
    ``(h, k, v, aux)``: aux is the layer's load-balancing loss term."""

    def _make_ffn(self, cfg, *, dtype, device) -> None:
        from .moe import MoE        # moe.py builds on this module
        self.moe = MoE(cfg, dtype=dtype, device=device)

    def finish(self, h: torch.Tensor, o: torch.Tensor):
        h, x = self._attn_residual(h, o)
        m, aux = self.moe(x)
        return self._ffn_residual(h, m), aux

    def forward(self, h: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False):
        with spans.span("model.attn"):
            q, k, v = self.qkv(h, positions)
            o = self.attend(q, k, v, local)
        with spans.span("model.ffn"):
            h, aux = self.finish(h, o)
        return h, k, v, aux


#: leaves that the init leaves at zero, in both packages: the norm
#: weights (each norm scales by 1 + w) and the qkv biases
ZERO_INIT = ("ln1", "ln2", "ln1_post", "ln2_post", "final_ln", "bq", "bk",
             "bv")


def _fill_attention(layer: AttnLayer, generator: torch.Generator) -> None:
    cfg = layer.cfg
    for p in layer.parameters(recurse=False):
        p.zero_()
    std = 1.0 / math.sqrt(cfg.d_model)
    _normal_(layer.wq, std, generator)
    _normal_(layer.wk, std, generator)
    _normal_(layer.wv, std, generator)
    _normal_(layer.wo, 1.0 / math.sqrt(cfg.n_heads * cfg.head_dim),
             generator)


@torch.no_grad()
def fill_attn_layer(layer: AttnLayer, generator: torch.Generator) -> None:
    """Initialize ``layer`` in place as the reference does: N(0, 1/d)
    for wq/wk/wv, N(0, 1/(H·D)) for wo, the MLP as :func:`init_mlp`,
    zeros for norms and biases (the norms scale by 1 + w)."""
    _fill_attention(layer, generator)
    _fill_mlp(layer.mlp, generator)


@torch.no_grad()
def fill_moe_layer(layer: MoELayer, generator: torch.Generator) -> None:
    """Initialize ``layer`` in place: its attention half as
    :func:`fill_attn_layer`, the experts as :func:`~.moe.fill_moe` (one
    expert at a time)."""
    from .moe import fill_moe
    _fill_attention(layer, generator)
    fill_moe(layer.moe, generator)


@torch.no_grad()
def init_attn_layer(generator: torch.Generator, cfg, *, dtype,
                    device) -> AttnLayer:
    """An :class:`AttnLayer` initialized by :func:`fill_attn_layer`."""
    layer = AttnLayer(cfg, dtype=dtype, device=device)
    fill_attn_layer(layer, generator)
    return layer
