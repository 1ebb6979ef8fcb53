"""One-token attention against a KV cache (decode) as a CUDA kernel
written by hand for Hopper: K4, split-KV ("flash-decoding").

It replaces no TPU kernel: the JAX package computes decode attention in
plain ``jnp`` (``repro.models.layers.decode_gqa_attention``, under its
``pallas:flash_decode`` profiling scope).  The source is
``csrc/flash_decode.cu``; its header states the bound on the card (the
bytes of the valid cache positions) and what the design does about it.
It is built like the flash-attention kernel (:mod:`._build`).  The plain
version of the same function is
:func:`repro_torch.kernels.ref.decode_attention_ref`.

``launches`` counts the calls of the kernel's entry point made through
:func:`flash_decode` (two launches each for bf16 — the splits, then
their merge — one for float32 q); callers reset it to 0 before a run
they want to account for.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _build

__all__ = ["flash_decode", "build", "splits"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])
#: blocks a streaming multiprocessor is given to work through, over all
#: splits: enough that slots of unequal length even out
_BLOCKS_PER_SM = 8

#: cudaErrorInvalidValue: the entry point's answer to what it does not take
_INVALID_VALUE = 1

#: entry-point calls made through :func:`flash_decode`
launches = 0

_sms: dict[int, int] = {}


def build() -> Path:
    """Compile ``csrc/flash_decode.cu`` (once per source content) and
    return the shared library's path (:func:`._build.build`)."""
    return _build.build(_SOURCE)


def splits(B: int, KV: int, Sc: int, T: int, sms: int) -> tuple[int, int]:
    """(splits, slots a split) for B slots of KV heads over Sc cache
    slots in tiles of T: enough (slot, KV head, split) blocks for
    ``_BLOCKS_PER_SM`` × ``sms``, at most one split a tile, every split
    a whole number of tiles."""
    tiles = -(-Sc // T)
    want = min(tiles, max(1, -(-_BLOCKS_PER_SM * sms // (B * KV))))
    per = -(-tiles // want)
    return -(-tiles // per), per * T


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor, *,
                 softcap: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, Sc, KV, D); ``pos``: int64 or int32
    on the card, a scalar or (B,) — the current token's position, whose
    key and value the caches already hold at slot ``pos % Sc`` →
    (B, 1, H, D) in the caches' dtype, on the card.

    bf16 q with a bf16 cache runs on the tensor cores; float32 q (the
    float32 models, with a bf16 or float32 cache) on the CUDA cores, in
    the plain version's rounding; a bf16 q with a float32 cache is taken
    as float32 (exact).  Raises on
    what the kernel does not take, and if a launch fails.
    """
    global launches
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if not t.is_cuda:
            raise ValueError(f"flash_decode: {name} is on {t.device}, the "
                             "kernel runs on a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, q "
                             f"is on {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} is not contiguous")
        if t.dim() != 4:
            raise ValueError(f"flash_decode: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"flash_decode: {name} is {t.dtype} "
                             "(float32, bfloat16)")
    B, one, H, D = q.shape
    Sc, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, Sc, KV, D) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)}")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"flash_decode: k_cache is {k_cache.dtype}, "
                         f"v_cache {v_cache.dtype}")
    if KV == 0 or H % KV or H // KV > 16:
        raise ValueError(f"flash_decode: {H} heads over {KV} KV heads "
                         "(at most 16 a group)")
    if Sc == 0:
        raise ValueError("flash_decode: the cache holds no slot")
    if pos.dtype not in (torch.int32, torch.int64) or pos.dim() > 1 \
            or pos.numel() not in (1, B):
        raise ValueError(f"flash_decode: pos is {pos.dtype} "
                         f"{tuple(pos.shape)}, want integers () or ({B},)")
    pos = pos.long()
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_decode: softcap {softcap} <= 0")
    if q.dtype == torch.bfloat16 and k_cache.dtype == torch.float32:
        q = q.float()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} is not 16-byte aligned")
    o = torch.empty((B, 1, H, D), dtype=v_cache.dtype, device=q.device)
    if o.numel() == 0:
        return o
    # the tensor cores split the cache's slots and merge the splits'
    # partial results; the float32 kernel takes each slot whole
    n_splits, chunk, part_o, part_ml = 1, Sc, None, None
    if q.dtype == torch.bfloat16:
        dev = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        # the tensor-core kernel's tiles hold 8192 // D positions; the
        # library refuses a head_dim it has no kernel for
        n_splits, chunk = splits(B, KV, Sc, max(1, 8192 // D), _sms[dev])
        G = H // KV
        part_o = torch.empty((B, KV, n_splits, G, D), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((2, B, KV, n_splits, G), dtype=torch.float32,
                              device=q.device)
    fn = _build.function(_SOURCE, "repro_flash_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 pos.data_ptr(), pos.stride(0) if pos.numel() > 1 else 0,
                 None if part_o is None else part_o.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 o.data_ptr(),
                 B, Sc, H, KV, D, _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
                 n_splits, chunk, softcap if softcap is not None else 0.0,
                 stream)
    if err == _INVALID_VALUE:
        raise ValueError(f"flash_decode: the kernel takes no head_dim {D} "
                         f"with q {q.dtype} and a {k_cache.dtype} cache "
                         "(cudaErrorInvalidValue)")
    if err != 0:
        raise RuntimeError(f"flash_decode: launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return o
