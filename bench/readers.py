"""Arithmetic the metric readers (``bench/metrics/*.py``) share: model
FLOPs by the frozen formulas, and kernels' rooflines from the traced
operators' shapes."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .frozen.roofline import (HW, attention_bound, attention_flops,
                              model_flops, wkv_bound, wkv_flops)

__all__ = ["serve_model_flops", "roofline", "kernel_seconds", "DTYPES"]

#: the profiler's names of the dtypes the kernels take
DTYPES = {"float": torch.float32, "c10::BFloat16": torch.bfloat16,
          "c10::Half": torch.float16, "double": torch.float64}


def _tokens(n: float):
    return SimpleNamespace(global_batch=1, seq_len=n)


def serve_model_flops(rec: dict) -> float:
    """The model FLOPs of the window's prefills and decode ticks: 2 ×
    active parameters × tokens (frozen ``model_flops``), plus each
    layer's attention over its query-key pairs (frozen
    ``attention_flops``) or, for RWKV, its WKV (frozen ``wkv_flops``)."""
    d = rec["dims"]
    total = 0.0
    for name, _, cost, _ in rec["events"]:
        n = int(cost)
        total += model_flops(d, _tokens(n), "prefill")
        if d.kind == "moe":
            if name == "prefill":
                total += d.n_layers * attention_flops(
                    1, n, d.n_heads, d.head_dim, d.window)
        elif d.kind == "rwkv":
            total += d.n_layers * wkv_flops(1, d.d_model // 64, n, 64)
    if d.kind == "moe":
        # decode: 4·D a query-key pair and head, per layer
        total += 4 * d.head_dim * d.n_heads * d.n_layers \
            * rec.get("decode_pairs", 0)
    return total


def kernel_seconds(trace, names: tuple[str, ...]) -> float:
    """Device seconds of the kernels whose names hold one of ``names``,
    in the traced window."""
    return sum(b - a for n, a, b in trace.in_window(trace.kernels)
               if any(x in n for x in names)) / 1e6


def _meta(shape, dtype):
    return torch.empty(shape, dtype=DTYPES.get(dtype, torch.float32),
                       device="meta")


def roofline(rec: dict, op: str, kernels: tuple[str, ...]) -> float | None:
    """Σ of the frozen least times of the traced window's calls of the
    program's operator ``op`` over Σ device time of ``kernels``, in %;
    None where the window holds no call or no kernel time."""
    tr = rec.get("trace")
    if tr is None:
        return None
    d = rec["dims"]
    bound_ms = 0.0
    for name, a, b, shapes, dtypes in tr.in_window(tr.ops):
        if name != f"repro_torch::{op}":
            continue
        if op == "flash_attention":
            (B, S, H, D), (_, _, KV, _) = shapes[0], shapes[1]
            bound_ms += attention_bound(B, S, H, KV, D, d.window)[0]
        elif op == "wkv6":
            ins = [_meta(s, t) for s, t in zip(shapes[:6], dtypes[:6]) if s]
            B, H, S, N = shapes[0]
            outs = [_meta((B, H, S, N), "float"), _meta((B, H, N, N), "float")]
            bound_ms += wkv_bound(ins, outs)[0]
    device_s = kernel_seconds(tr, kernels)
    if bound_ms == 0.0 or device_s == 0.0:
        return None
    return 100.0 * bound_ms / 1e3 / device_s


PEAK_FLOPS = HW.PEAK_FLOPS
