"""int8 gradient compression with error feedback — the port of
:mod:`repro.train.compression`.

Each leaf is quantized to int8 with a per-leaf float32 scale (floored at
1e-12) and dequantized; the quantization residual is carried in an
*error-feedback* buffer added to the next step's gradient (Karimireddy
et al. 2019).  On one card there is no all-reduce for it to shrink: the
train step applies it, as the reference's does, so that a run with
``compress`` computes what the reference's does.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import torch

__all__ = ["init_error_feedback", "compress_grads", "quantize_int8",
           "dequantize_int8"]


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127) \
        .to(torch.int8)


def _scale(xs) -> torch.Tensor:
    amax = torch.stack([torch.amax(torch.abs(x.float())) for x in xs]).max()
    return torch.clamp(amax / 127.0, min=1e-12)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _scale([x])
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Mapping[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compress_grads(grads: Mapping[str, torch.Tensor],
                   ef: Mapping[str, torch.Tensor],
                   groups: Iterable[Sequence[str]] | None = None
                   ) -> tuple[dict, dict]:
    """Returns (compressed-then-decompressed grads, new error feedback).

    ``groups``: the names that share one scale, each tensor alone by
    default.  The reference scales each of its leaves, and a leaf of its
    ``blocks`` stacks one weight of every layer at a pattern position, so
    the train step passes :func:`repro_torch.convert.reference_leaves`.
    """
    out, new_ef = {}, {}
    for names in ([k] for k in grads) if groups is None else groups:
        g32 = {k: grads[k].float() + ef[k] for k in names}
        scale = _scale(g32.values())
        for k, x in g32.items():
            deq = dequantize_int8(_quantize(x, scale), scale)
            out[k] = deq.to(grads[k].dtype)
            new_ef[k] = x - deq
    return out, new_ef
