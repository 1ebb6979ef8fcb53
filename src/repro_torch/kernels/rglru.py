"""The RG-LRU linear scan ``h_t = a_t ⊙ h_{t−1} + b_t`` as a CUDA kernel
written by hand for Hopper — the port of the TPU kernel in
:mod:`repro.kernels.rglru`.

The source is ``csrc/rglru.cu``; its header states the bound on the card
and what the design does about it.  It is built like the flash-attention
kernel (:mod:`._build`).  The plain version of the same function is
:func:`repro_torch.kernels.ref.rglru_ref`.

``launches`` counts the calls of the kernel's entry point made through
:func:`rglru_scan` (one launch for S up to :func:`chunk`, the chunked
scan's three past it); callers reset it to 0 before a run they want to
account for.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _build

__all__ = ["rglru_scan", "build", "chunk"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

#: entry-point calls made through :func:`rglru_scan`
launches = 0


def build() -> Path:
    """Compile ``csrc/rglru.cu`` (once per source content) and return the
    shared library's path (:func:`._build.build`)."""
    return _build.build(_SOURCE)


def chunk() -> int:
    """Time steps a chunk of the kernel's chunked scan, from the library:
    a longer S takes three launches (summaries, carries, rescan), a
    shorter one the one-pass loop."""
    return _build.function(_SOURCE, "repro_rglru_chunk", [])()


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, S, R) float32 or bfloat16 (read as float32); h0: (B, R)
    float32 or None → (h (B, S, R), h_final (B, R)), both float32, on the
    card.  Raises on what the kernel does not take, and if the launch
    fails."""
    global launches
    named = [("a", a), ("b", b)] + ([("h0", h0)] if h0 is not None else [])
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, the "
                             "kernel runs on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} is not contiguous")
        if t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, a is "
                             f"on {a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: a is {a.dtype}, b is {b.dtype}; "
                         "both float32 or both bfloat16")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}; want two equal (B, S, R)")
    B, S, R = a.shape
    if h0 is not None and (h0.shape != (B, R) or h0.dtype != torch.float32):
        raise ValueError(f"rglru_scan: h0 is {h0.dtype} "
                         f"{tuple(h0.shape)}, want float32 {(B, R)}")
    fn = _build.function(_SOURCE, "repro_rglru_scan_fwd", _ARGTYPES)
    h = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    h_final = torch.empty((B, R), dtype=torch.float32, device=a.device)
    if h_final.numel() == 0:
        return h, h_final
    # past one chunk the scan runs chunked over time, through a scratch
    # of each chunk's product of a and local scan (csrc/rglru.cu)
    T = chunk()
    scratch = (torch.empty((2, B, -(-S // T), R), dtype=torch.float32,
                           device=a.device) if S > T else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 h0.data_ptr() if h0 is not None else None,
                 h.data_ptr(), h_final.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 B, S, R, _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan: launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return h, h_final
