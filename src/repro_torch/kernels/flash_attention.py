"""Flash attention (causal GQA, sliding window, softcap) as a CUDA kernel
written by hand for Hopper — the port of the TPU kernel in
:mod:`repro.kernels.flash_attention`.

The source is ``csrc/flash_attention.cu``; its header states the bound
on the card and what the design does about it.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry point
at first use, into ``build/`` at the repository root, and loaded with
``ctypes``.  The plain version of the same function is
:func:`repro_torch.kernels.ref.attention_ref`.

``launches`` counts the kernel launches made through
:func:`flash_attention`; callers reset it to 0 before a run they want to
account for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["flash_attention", "build"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

#: kernel launches made through :func:`flash_attention`
launches = 0

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the flash-attention kernel")
    return found


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` (once per source content) and
    return the shared library's path.

    Safe when several processes build at once: each compiles to its own
    temporary name and ``os.replace`` publishes the result atomically.
    """
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"flash_attention-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    fn = _load().repro_flash_attention_fwd
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
