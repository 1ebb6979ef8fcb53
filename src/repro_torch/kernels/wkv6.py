"""The chunked RWKV-6 WKV as a CUDA kernel written by hand for Hopper —
the port of the TPU kernel in :mod:`repro.kernels.rwkv6`.

The source is ``csrc/wkv6.cu``; its header states the bound on the card
and what the design does about it.  It is built like the other kernels
(:mod:`._build`).  The plain version of the same function is
:func:`repro_torch.kernels.ref.wkv6_ref`.

r, k, v and w keep the reference's ``(B, H, S, N)`` layout at this
boundary, but need not be contiguous: the kernel takes element strides
for the first three axes (the model passes the head-transposed views of
its ``(B, S, H, N)`` projections), shared by all four, with the last
axis contiguous.  The kernel reads them through TMA tensor maps, so the
four tensors must start on 16-byte boundaries and their strides keep
every row there.  Other layouts raise.

``launches`` counts the kernel launches made through :func:`wkv6`;
callers reset it to 0 before a run they want to account for.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _build

__all__ = ["wkv6", "build", "cluster_info"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
#: head size and longest chunk the kernel takes
N = 64
MAX_CHUNK = 32

#: kernel launches made through :func:`wkv6`
launches = 0


def build() -> Path:
    """Compile ``csrc/wkv6.cu`` (once per source content) and return the
    shared library's path (:func:`._build.build`)."""
    return _build.build(_SOURCE)


def cluster_info(dtype: torch.dtype) -> dict[str, int]:
    """What the runtime reports of the kernel for r/k/v in ``dtype``: the
    thread block cluster width it requires, how many such clusters fit on
    the card at once, and a block's dynamic shared memory in bytes."""
    fn = _build.function(_SOURCE, "repro_wkv6_cluster_info",
                         [ctypes.c_int] + [ctypes.c_void_p] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    err = fn(_DTYPES[dtype], *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"wkv6: cluster query failed with CUDA error "
                           f"{err}")
    return dict(zip(("cluster_width", "max_active_clusters", "smem_bytes"),
                    (x.value for x in out)))


def _strides(t: torch.Tensor) -> tuple[int, ...]:
    """``t``'s strides, with 0 for axes of size 1 (never stepped)."""
    return tuple(s if n > 1 else 0 for n, s in zip(t.shape, t.stride()))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None = None,
         *, chunk: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, H, S, 64) float32 or bfloat16 (read as float32); w:
    (B, H, S, 64) float32; u: (H, 64) float32; s0: (B, H, 64, 64) float32
    or None → (y (B, H, S, 64), s_final (B, H, 64, 64)), both float32, on
    the card.  Raises on what the kernel does not take, and if the launch
    fails."""
    global launches
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v are {r.dtype}, {k.dtype}, "
                         f"{v.dtype}; all float32 or all bfloat16")
    if r.dim() != 4 or r.shape[3] != N:
        raise ValueError(f"wkv6: r is {tuple(r.shape)}, want (B, H, S, "
                         f"{N})")
    B, H, S, _ = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} is {tuple(t.shape)}, r is "
                             f"{tuple(r.shape)}")
        if _strides(t) != _strides(r):
            raise ValueError(f"wkv6: {name} has strides {t.stride()}, r "
                             f"{r.stride()}; r, k, v and w must share "
                             "one layout")
    if r.stride(3) != 1:
        raise ValueError(f"wkv6: r has strides {r.stride()}; the last "
                         "axis must be contiguous")
    if w.dtype != torch.float32:
        raise ValueError(f"wkv6: w is {w.dtype}, want float32")
    if u.shape != (H, N) or u.dtype != torch.float32 \
            or not u.is_contiguous():
        raise ValueError(f"wkv6: u is {u.dtype} {tuple(u.shape)}, want a "
                         f"contiguous float32 {(H, N)}")
    if s0 is not None and (s0.shape != (B, H, N, N)
                           or s0.dtype != torch.float32
                           or not s0.is_contiguous()):
        raise ValueError(f"wkv6: s0 is {s0.dtype} {tuple(s0.shape)}, want "
                         f"a contiguous float32 {(B, H, N, N)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk}, want 1..{MAX_CHUNK}")
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)] \
        + ([("s0", s0)] if s0 is not None else [])
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"wkv6: {name} is on {t.device}, the kernel "
                             "runs on a CUDA device")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r is on "
                             f"{r.device}")
    align = 16 // r.element_size()
    if any(t.data_ptr() % 16 for t in (r, k, v, w)) \
            or any(st % align for st in _strides(r)[:3]):
        raise ValueError(f"wkv6: r, k, v and w must start on 16-byte "
                         f"boundaries with strides that are multiples of "
                         f"{align} elements; r has strides {r.stride()}")
    fn = _build.function(_SOURCE, "repro_wkv6_fwd", _ARGTYPES)
    y = torch.empty((B, H, S, N), dtype=torch.float32, device=r.device)
    s_final = torch.empty((B, H, N, N), dtype=torch.float32,
                          device=r.device)
    if s_final.numel() == 0:
        return y, s_final
    sb, sh, ss, _ = r.stride()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr() if s0 is not None else None,
                 y.data_ptr(), s_final.data_ptr(), B, H, S, N, chunk,
                 sb, sh, ss, _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6: launch failed with CUDA error {err}")
    launches += 1
    return y, s_final
