"""RG-LRU recurrent block (RecurrentGemma / Griffin) — the port of
:mod:`repro.models.rglru`.

Block structure (Griffin, arXiv:2402.19427):

    x ─ RMSNorm ─┬─ linear gate ── GeLU ──────────────┐
                 └─ linear y ── causal conv1d ── RG-LRU ⊙ ── linear out ─ +residual

RG-LRU recurrence (all elementwise over the recurrent width):

    r_t = σ(W_a x_t + b_a)          (recurrence gate, block-diagonal W_a)
    i_t = σ(W_x x_t + b_x)          (input gate,      block-diagonal W_x)
    a_t = exp(-c · softplus(Λ) · r_t)            c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The full-sequence scan goes through :func:`repro_torch.kernels.ops.rglru`,
which launches kernel K2 on the card; the one-token decode step is plain
PyTorch, as the reference computes it outside any kernel.  The gate
leaves ``wa, ba, wx, bx, lam`` are float32 in every model; where JAX
promotes a bfloat16 operand against them, the port casts explicitly.
The conv state is bfloat16 whatever the model's dtype, as in the
reference.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .layers import MLP, _fill_mlp, _normal_, _param, rmsnorm

__all__ = ["RGLRU_C", "conv1d_causal", "rglru_scan", "rglru_block",
           "RGLRULayer", "fill_rglru_layer"]

RGLRU_C = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), without F.softplus's threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(x: torch.Tensor, p: Mapping[str, torch.Tensor]
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections.  x: (B, S, R) → (a_t, gated
    input), both float32 (JAX promotes x against the float32 gates)."""
    B, S, R = x.shape
    H = p["wa"].shape[0]                       # gate heads
    xh = x.float().reshape(B, S, H, R // H)
    r = torch.sigmoid(
        torch.einsum("bshr,hrk->bshk", xh, p["wa"].float()) + p["ba"])
    i = torch.sigmoid(
        torch.einsum("bshr,hrk->bshk", xh, p["wx"].float()) + p["bx"])
    r = r.reshape(B, S, R)
    i = i.reshape(B, S, R)
    a = torch.exp(-RGLRU_C * _softplus(p["lam"].float()) * r)
    gated = i * x.float()
    return a, gated


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over the time axis, through kernel K2 on
    the card.  a, bx: (B, S, R); h0: (B, R) or None.  Returns h:
    (B, S, R) float32."""
    h, _ = ops.rglru(a.float().contiguous(), bx.float().contiguous(),
                     None if h0 is None else h0.float().contiguous())
    return h


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None) -> torch.Tensor:
    """Per-channel causal conv.  x: (B,S,R); w: (W,R); state: (B,W-1,R).
    A left-to-right sum of W shifted products in x's dtype, as the
    reference writes it (not ``F.conv1d``, which sums otherwise)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return out + b


def _in_proj(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg
             ) -> tuple[torch.Tensor, torch.Tensor]:
    h_in = rmsnorm(x, p["ln"], cfg.norm_eps)
    gate = F.gelu(h_in @ p["w_gate"], approximate="tanh")
    return gate, h_in @ p["w_y"]


def _input_scale(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(1.0 - a ** 2, min=0.0))


def _sequence(y: torch.Tensor, p: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """The conv and the scan over a whole sequence: h (B, S, R) fp32."""
    y = conv1d_causal(y, p["conv_w"], p["conv_b"])
    a, bx = _gates(y, p)
    return rglru_scan(a, _input_scale(a) * bx)


def _out(gate: torch.Tensor, hs: torch.Tensor,
         p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return (gate * hs.to(gate.dtype)) @ p["w_out"]


def rglru_block(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg,
                state: Mapping[str, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """The full recurrent block.  x: (B, S, d); returns (y, new_state).

    ``state`` (decode, S = 1): {"h": (B,R) fp32, "conv": (B,W-1,R)}; the
    step is the reference's elementwise formula in plain PyTorch.
    Without a state the sequence goes through :func:`rglru_scan`.
    """
    gate, y = _in_proj(x, p, cfg)
    if state is None:
        return _out(gate, _sequence(y, p), p), None
    conv_in = torch.cat([state["conv"].to(y.dtype), y], dim=1)
    y = conv1d_causal(y, p["conv_w"], p["conv_b"], state["conv"])
    a, bx = _gates(y, p)
    h = a[:, 0] * state["h"] + _input_scale(a[:, 0]) * bx[:, 0]
    new_state = {"h": h, "conv": conv_in[:, 1:].to(torch.bfloat16)}
    return _out(gate, h[:, None, :], p), new_state


class RGLRULayer(nn.Module):
    """One recurrent layer: the RG-LRU block and a pre-norm MLP, each with
    a residual.  Parameter names and dtypes follow the reference's tree:
    the gate leaves ``wa, ba, wx, bx, lam`` are float32 in every model."""

    def __init__(self, cfg, *, dtype, device) -> None:
        super().__init__()
        d = cfg.d_model
        R = cfg.rnn_width or d
        H = max(1, cfg.n_heads)
        k = R // H
        f32 = torch.float32
        self.cfg = cfg
        self.ln = _param((d,), dtype, device)
        self.w_gate = _param((d, R), dtype, device)
        self.w_y = _param((d, R), dtype, device)
        self.conv_w = _param((cfg.conv_width, R), dtype, device)
        self.conv_b = _param((R,), dtype, device)
        self.wa = _param((H, k, k), f32, device)
        self.ba = _param((H, k), f32, device)
        self.wx = _param((H, k, k), f32, device)
        self.bx = _param((H, k), f32, device)
        self.lam = _param((R,), f32, device)
        self.w_out = _param((R, d), dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, dtype=dtype, device=device)

    def leaves(self) -> dict[str, torch.Tensor]:
        """The block's own parameters by name, as the reference's dict."""
        return dict(self.named_parameters(recurse=False))

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.mlp(rmsnorm(h, self.ln2, self.cfg.norm_eps))

    def forward(self, h: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Full-sequence layer.  Returns (h, state): the decode state
        after the last position, ``{"h": (B,R) fp32, "conv": (B,W-1,R)
        bf16}``, which prefill stores in the cache.

        The conv state holds the last ``W−1`` inputs of the conv.  A
        prompt shorter than that is left-padded with zeros, the inputs
        the full-sequence conv saw before the first token, so that decode
        after prefill equals :func:`forward`.  (The reference keeps only
        the S rows it has, and its serving cache then holds a stale row.)
        """
        p = self.leaves()
        gate, y = _in_proj(h, p, self.cfg)
        W = self.cfg.conv_width
        tail = y[:, -(W - 1):].to(torch.bfloat16)
        if tail.shape[1] < W - 1:
            tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
        hs = _sequence(y, p)
        return self._mlp(h + _out(gate, hs, p)), {"h": hs[:, -1],
                                                  "conv": tail}

    def step(self, h: torch.Tensor, state: Mapping[str, torch.Tensor]
             ) -> tuple[torch.Tensor, dict]:
        """One decode step (h: (B, 1, d)).  Returns (h, new_state)."""
        o, new_state = rglru_block(h, self.leaves(), self.cfg, state)
        return self._mlp(h + o), new_state


@torch.no_grad()
def fill_rglru_layer(layer: RGLRULayer,
                     generator: torch.Generator) -> None:
    """Initialize ``layer`` in place with the scales of the reference's
    ``init_rglru``: N(0, 1/d) for w_gate and w_y, N(0, 1/W) for conv_w,
    N(0, 1/k) for the k×k gate blocks, N(0, 1/R) for w_out, Λ evenly
    from −2 to 1, zeros for norms and biases; the MLP as ``init_mlp``."""
    cfg = layer.cfg
    for p in layer.parameters(recurse=False):
        p.zero_()
    d = cfg.d_model
    R, k = layer.lam.shape[0], layer.wa.shape[1]
    std = 1.0 / math.sqrt(d)
    _normal_(layer.w_gate, std, generator)
    _normal_(layer.w_y, std, generator)
    _normal_(layer.conv_w, 1.0 / math.sqrt(cfg.conv_width), generator)
    _normal_(layer.wa, 1.0 / math.sqrt(k), generator)
    _normal_(layer.wx, 1.0 / math.sqrt(k), generator)
    layer.lam.copy_(torch.linspace(-2.0, 1.0, R, dtype=torch.float32))
    _normal_(layer.w_out, 1.0 / math.sqrt(R), generator)
    _fill_mlp(layer.mlp, generator)
