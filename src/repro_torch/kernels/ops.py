"""Dispatch between each kernel and its plain version, by device.

A CPU tensor goes to the plain PyTorch version in :mod:`.ref` (the CPU
tests, and the truth the kernels are held against).  A CUDA tensor goes
to the hand-written kernel; if the kernel cannot be built or launched
the call raises — nothing falls back to the plain version on the card.
Mirrors :mod:`repro.kernels.ops`, whose ``impl=`` switch this replaces.

Gradients.  Each kernel computes a forward only, as its TPU counterpart
does: the JAX package has no backward kernel, and its train step
differentiates the XLA formula.  So on the card every kernel call goes
through :class:`_KernelWithPlainGrad`, whose forward is the hand-written
kernel and whose backward recomputes the plain version from :mod:`.ref`
on the saved inputs and returns the gradients of that recomputation.
This is no fallback: the forward on the card is always the kernel (its
launch count shows it), and a gradient is a different function from
the kernel's, for which neither package has a kernel.  Without it the
kernels' outputs, written through ``ctypes`` into fresh tensors, would
leave autograd and a backward pass would silently give no gradient for
their inputs.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import flash_attention as _fa
from . import ref
from . import rglru as _rglru
from . import wkv6 as _wkv6

__all__ = ["attention", "wkv", "rglru"]


class _KernelWithPlainGrad(torch.autograd.Function):
    """``apply(kernel, plain, *inputs)``: the outputs of
    ``kernel(*inputs)``, with the gradients of ``plain(*inputs)``.
    ``inputs`` are tensors or ``None``; both functions return a tensor
    or a tuple of tensors of the same shapes."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            # an output that none of the inputs wanting a gradient reach
            # (WKV's final state from u) adds nothing
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wrt = [x for x, n in zip(xs, need) if n]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int | None = None,
              softcap: float | None = None) -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, H, D); k, v: (B, S, KV, D)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, window=window, softcap=softcap)
    return _KernelWithPlainGrad.apply(
        lambda q, k, v: _fa.flash_attention(q, k, v, window=window,
                                            softcap=softcap),
        lambda q, k, v: ref.attention_ref(q, k, v, window=window,
                                          softcap=softcap),
        q, k, v)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None = None, *,
        chunk: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 WKV.  r, k, v, w: (B, H, S, N); u: (H, N); s0:
    (B, H, N, N) or None.  Returns (y (B, H, S, N), s_final (B, H, N, N)),
    fp32.  ``chunk`` is the kernel's chunk length; the plain version walks
    the recurrence step by step."""
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    return _KernelWithPlainGrad.apply(
        lambda *xs: _wkv6.wkv6(*xs, chunk=chunk), ref.wkv6_ref,
        r, k, v, w, u, s0)


def _rglru_plain(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    h = ref.rglru_ref(a, b, h0)
    return h, h[:, -1]


def rglru(a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The linear scan h_t = a_t h_{t−1} + b_t.  a, b: (B, S, R); h0:
    (B, R) or None.  Returns (h (B, S, R), h_final (B, R)), fp32."""
    if a.device.type == "cpu":
        return _rglru_plain(a, b, h0)
    return _KernelWithPlainGrad.apply(_rglru.rglru_scan, _rglru_plain,
                                      a, b, h0)
