"""Plain PyTorch pieces the references share: float32 arithmetic, the
precision of the products (``"f32"``, or ``"fp8"`` for the control: both
operands of each weight product rounded to float8 e4m3 with a scale per
row of the activations and per output column of the weight), and the
gaps a served token's logit lies below the reference's best.

Imports neither ``jax`` nor the program."""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["f32_exact", "Linear", "rmsnorm", "rope", "logit_gaps",
           "control_gaps"]


@contextlib.contextmanager
def f32_exact():
    """Float32 products with TF32 off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(x: torch.Tensor, dim: int, forward_only: bool) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled so that the largest magnitude
    along ``dim`` maps to 448, and back in float32.  Autograd passes a
    gradient back through the same casts, so that it too is rounded to
    float8 e4m3 (unscaled) on its way; with ``forward_only`` the
    gradient passes unchanged, in float32."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x * scale).to(torch.float8_e4m3fn).float() / scale
    if forward_only and x.requires_grad:
        return x + (q - x).detach()
    return q


class Linear:
    """``x @ w`` in the reference's precision: ``"f32"``, ``"fp8"``
    (both operands of the product in float8 e4m3, and the gradients
    through them too) or ``"fp8_forward"`` (float8 operands, float32
    gradients)."""

    def __init__(self, precision: str = "f32") -> None:
        if precision not in ("f32", "fp8", "fp8_forward"):
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision != "f32":
            fwd = self.precision == "fp8_forward"
            return _fp8(x, -1, fwd) @ _fp8(w, -2, fwd)
        return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) · (1 + w)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the two halves of each head rotated together.
    x: (S, heads, D); pos: (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logit_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best
    at its position: (n,) ≥ 0."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[:, None])[:, 0]


def control_gaps(ref_logits: torch.Tensor, other_logits: torch.Tensor
                 ) -> torch.Tensor:
    """The gap of the token that ``other_logits`` puts first, read in
    the reference's logits."""
    return logit_gaps(ref_logits, other_logits.argmax(dim=-1))
