"""Flash attention (causal GQA, sliding window, softcap) as a CUDA kernel
written by hand for Hopper — the port of the TPU kernel in
:mod:`repro.kernels.flash_attention`.

The source is ``csrc/flash_attention.cu``; its header states the bound
on the card and what the design does about it.  bfloat16 runs on the
tensor cores (``wgmma``, K/V tiles by TMA); float32 runs a scalar
kernel, chosen by dtype.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point
at first use, into ``build/`` at the repository root, and loaded with
``ctypes`` (:mod:`._build`).  The plain version of the same function is
:func:`repro_torch.kernels.ref.attention_ref`.

``launches`` counts the kernel launches made through
:func:`flash_attention`; callers reset it to 0 before a run they want to
account for.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _build

__all__ = ["flash_attention", "build", "smem_bytes"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)

#: kernel launches made through :func:`flash_attention`
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` (once per source content) and
    return the shared library's path (:func:`._build.build`)."""
    return _build.build(_SOURCE)


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of the kernel for head_dim ``D`` and
    ``dtype`` takes, as the library reports it."""
    fn = _build.function(_SOURCE, "repro_flash_attention_smem_bytes",
                         [ctypes.c_int, ctypes.c_int])
    return fn(D, _DTYPES[dtype])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) → (B, S, H, D), on the card.

    Causal; ``window`` keeps keys with ``q − k < window``; ``softcap``
    applies ``c·tanh(s/c)`` to the scores before the mask.  Raises on
    what the kernel does not take, and if the launch fails.
    """
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "the kernel runs on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} unsupported "
                         "(float32, bfloat16)")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads over {KV} KV heads")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 "aligned, which the bf16 kernel's TMA "
                                 "loads need")
    fn = _build.function(_SOURCE, "repro_flash_attention_fwd", _ARGTYPES)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, H, KV, D, _DTYPES[q.dtype],
                 window if window is not None else 0,
                 softcap if softcap is not None else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return o
