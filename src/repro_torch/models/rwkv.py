"""RWKV-6 ("Finch") — attention-free time-mix with data-dependent decay;
the port of :mod:`repro.models.rwkv`.

Per head (head size N = 64, H = d_model / 64 heads, whatever
``cfg.n_heads`` says), the WKV state is an N×N matrix:

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)

with w_t = exp(-exp(w0 + LoRA_w(x̄_t))).  Token-shift mixing (ddlerp)
interpolates between x_t and x_{t-1} with LoRA-modulated coefficients for
each of r/k/v/w/g; a head-wise GroupNorm follows the WKV, and the
channel mix is the squared-ReLU MLP.

A sequence (prefill, or any call without a state) goes through
:func:`repro_torch.kernels.ops.wkv`, which launches kernel K3 (the
chunked WKV) on the card; the one-token decode step with a state is
plain PyTorch (:func:`wkv6_scan_ref`), as the reference computes it
outside any kernel.  The leaves ``u, w0, gn_w, gn_b`` are float32 in
every model; where JAX promotes a bfloat16 operand against them, the
port casts explicitly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .layers import _normal_, _param, rmsnorm

__all__ = ["HEAD_SIZE", "wkv6_scan_ref", "RWKVLayer", "fill_rwkv_layer"]

HEAD_SIZE = 64
_LORA, _LORA_W = 32, 64
_GN_EPS = 64e-5
_MIXES = ("r", "k", "v", "w", "g")


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV step by step, fp32.  r, k, v, w: (B, H, S, N); u: (H, N).
    Returns (y (B, H, S, N), s_final (B, H, N, N)).  The decode step's
    WKV (S = 1 with a state)."""
    B, H, S, N = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, :, t], s + u * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(ys, dim=2), s


def _ddlerp(x: torch.Tensor, xx: torch.Tensor, mu: torch.Tensor,
            lora_a: torch.Tensor, lora_b: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp: x + (x_prev − x) · (μ + tanh((x+Δ·μ)A)B)."""
    m = mu + torch.tanh((x + xx * mu) @ lora_a) @ lora_b
    return x + xx * m


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} for every t: the state's last row (zeros without one)
    before x[:, 0]."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last.to(x.dtype)[:, None, :], x[:, :-1]], dim=1)


class _TimeMix(nn.Module):
    def __init__(self, d: int, *, dtype, device) -> None:
        super().__init__()
        f32 = torch.float32
        self.u = _param((d // HEAD_SIZE, HEAD_SIZE), f32, device)
        self.w0 = _param((d,), f32, device)
        self.a_w2 = _param((d, _LORA_W), dtype, device)
        self.b_w2 = _param((_LORA_W, d), dtype, device)
        self.gn_w = _param((d,), f32, device)
        self.gn_b = _param((d,), f32, device)
        for nm in _MIXES:
            setattr(self, f"mu_{nm}", _param((d,), dtype, device))
            setattr(self, f"a_{nm}", _param((d, _LORA), dtype, device))
            setattr(self, f"b_{nm}", _param((_LORA, d), dtype, device))
        for nm in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, nm, _param((d, d), dtype, device))

    def mix(self, xt: torch.Tensor, xx: torch.Tensor, nm: str
            ) -> torch.Tensor:
        return _ddlerp(xt, xx, getattr(self, f"mu_{nm}"),
                       getattr(self, f"a_{nm}"), getattr(self, f"b_{nm}"))


class _ChannelMix(nn.Module):
    def __init__(self, d: int, ff: int, *, dtype, device) -> None:
        super().__init__()
        self.mu_k = _param((d,), dtype, device)
        self.mu_r = _param((d,), dtype, device)
        self.wk = _param((d, ff), dtype, device)
        self.wv = _param((ff, d), dtype, device)
        self.wr = _param((d, d), dtype, device)


class RWKVLayer(nn.Module):
    """One RWKV-6 block: time mix and channel mix, each with a residual.
    Parameter names and dtypes are the reference tree's leaves: ``ln1``,
    ``ln2``, ``tm.*`` and ``cm.*``, with ``tm.u``, ``tm.w0``, ``tm.gn_w``
    and ``tm.gn_b`` float32 in every model."""

    def __init__(self, cfg, *, dtype, device) -> None:
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln1 = _param((d,), dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self.tm = _TimeMix(d, dtype=dtype, device=device)
        self.cm = _ChannelMix(d, cfg.d_ff, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, state: dict | None = None
                ) -> tuple[torch.Tensor, dict | None]:
        """The block over x: (B, S, d), the semantics of the reference's
        ``rwkv_block``.  With ``state`` ({"shift_t", "shift_c": (B, d),
        "wkv": (B, H, N, N) fp32}) the block starts from it and returns
        the state after the last position — the shifts in x's dtype, as
        the reference returns them; without one it returns None."""
        cfg, tm, cm = self.cfg, self.tm, self.cm
        B, S, d = x.shape
        H = d // HEAD_SIZE

        def heads(t: torch.Tensor) -> torch.Tensor:   # (B,S,d) → (B,H,S,N)
            return t.reshape(B, S, H, HEAD_SIZE).transpose(1, 2)

        # ---- time mix -------------------------------------------------
        xt = rmsnorm(x, self.ln1, cfg.norm_eps)
        xx = _shift(xt, None if state is None else state["shift_t"]) - xt
        xr, xk, xv, xw, xg = (tm.mix(xt, xx, nm) for nm in _MIXES)
        r = heads(xr @ tm.wr)
        k = heads(xk @ tm.wk)
        v = heads(xv @ tm.wv)
        g = F.silu(xg @ tm.wg)
        # JAX promotes the bf16 LoRA term against the f32 w0
        logw = tm.w0 + (torch.tanh(xw @ tm.a_w2) @ tm.b_w2).float()
        w = heads(torch.exp(-torch.exp(logw)))
        s0 = None if state is None else state["wkv"]
        if S == 1 and state is not None:
            y, s_fin = wkv6_scan_ref(r, k, v, w, tm.u, s0)
        else:
            y, s_fin = ops.wkv(r, k, v, w, tm.u, s0, chunk=cfg.rwkv_chunk)
        # head-wise GroupNorm in f32 (population variance, as jnp.var)
        yh = y.transpose(1, 2)
        yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
            yh.var(-1, unbiased=False, keepdim=True) + _GN_EPS)
        y = (yh.reshape(B, S, d) * tm.gn_w + tm.gn_b).to(x.dtype)
        out = x + (y * g) @ tm.wo

        # ---- channel mix ----------------------------------------------
        xc = rmsnorm(out, self.ln2, cfg.norm_eps)
        xxc = _shift(xc, None if state is None else state["shift_c"]) - xc
        kk = torch.square(torch.relu((xc + xxc * cm.mu_k) @ cm.wk))
        out = out + torch.sigmoid((xc + xxc * cm.mu_r) @ cm.wr) \
            * (kk @ cm.wv)
        if state is None:
            return out, None
        return out, {"shift_t": xt[:, -1], "shift_c": xc[:, -1],
                     "wkv": s_fin}


@torch.no_grad()
def fill_rwkv_layer(layer: RWKVLayer, generator: torch.Generator) -> None:
    """Initialize ``layer`` in place with the scales of the reference's
    ``init_rwkv``: N(0, 1/d) for the projections and LoRA inputs, N(0,
    0.01²) for the LoRA outputs, N(0, 1/ff) for the channel mix's output,
    N(0, 0.1²) for u, w0 evenly from −6 to −0.5, μ = 0.5, GroupNorm
    weight 1 and bias 0, norms 0."""
    tm, cm = layer.tm, layer.cm
    d, ff = cm.wk.shape
    std = 1.0 / math.sqrt(d)
    layer.ln1.zero_()
    layer.ln2.zero_()
    _normal_(tm.u, 0.1, generator)
    tm.w0.copy_(torch.linspace(-6.0, -0.5, d, dtype=torch.float32))
    _normal_(tm.a_w2, std, generator)
    _normal_(tm.b_w2, 0.01, generator)
    tm.gn_w.fill_(1.0)
    tm.gn_b.zero_()
    for nm in _MIXES:
        getattr(tm, f"mu_{nm}").fill_(0.5)
        _normal_(getattr(tm, f"a_{nm}"), std, generator)
        _normal_(getattr(tm, f"b_{nm}"), 0.01, generator)
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        _normal_(getattr(tm, nm), std, generator)
    cm.mu_k.fill_(0.5)
    cm.mu_r.fill_(0.5)
    _normal_(cm.wk, std, generator)
    _normal_(cm.wv, 1.0 / math.sqrt(ff), generator)
    _normal_(cm.wr, std, generator)
