"""Frozen copies of the program's roofline arithmetic, so that the
benchmark's yardstick does not move when the program's formulas do.

Copied at commit e3255417b9b9e53c6324b1f22731d5fa440e6b48 from:

* ``src/repro_torch/launch/mesh.py``: the card's figures (``HW``);
* ``src/repro_torch/kernels/ops.py``: ``attention_pairs``,
  ``attention_flops``, ``wkv_flops``;
* ``src/repro_torch/launch/roofline.py``: ``attention_bound``,
  ``wkv_bound``, ``model_flops``.

The bodies are unchanged.  ``model_flops`` takes any configuration with
a ``param_count()``: the benchmark's :class:`bench.model.Dims` counts
the weights it draws (the program's ``ModelConfig.param_count`` leaves
out two of each RWKV layer's projections).  The kernels' bound functions
are given tensors on the meta device where only shapes and dtypes are
known.
"""

from __future__ import annotations

__all__ = ["HW", "attention_pairs", "attention_flops", "wkv_flops",
           "attention_bound", "wkv_bound", "model_flops"]


class HW:
    """NVIDIA H100 SXM (per card; NVIDIA's data sheet, dense) for the
    roofline terms."""

    PEAK_FLOPS = 989e12        # bf16 on the tensor cores
    PEAK_TF32_FLOPS = 495e12   # TF32 on the tensor cores
    PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
    HBM_BW = 3.35e12           # bytes/s
    ICI_BW = 450e9             # NVLink bytes/s a direction (unused on one card)
    HBM_BYTES = 80e9


def attention_pairs(S: int, window: int | None = None) -> int:
    """Query-key pairs causal attention over S positions computes: each
    query sees itself and the ``window − 1`` keys before it (all before
    it without a window)."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def attention_flops(B: int, S: int, H: int, D: int,
                    window: int | None = None) -> int:
    """K1's products: QKᵀ and PV, 2·D each per unmasked query-key pair
    and head."""
    return 4 * B * H * attention_pairs(S, window) * D


def wkv_flops(B: int, H: int, S: int, N: int) -> int:
    """K3's work a token and head: y_t = r_t S + (r_t·(u⊙k_t)) v_t and
    S = w_t⊙S + k_tᵀv_t, 5·N² + 5·N."""
    return B * H * S * (5 * N * N + 5 * N)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def attention_bound(B, S, H, KV, D, window=None,
                    softcap=None) -> tuple[float, str]:
    """Least time on the card for causal bf16 attention, ms: its
    operations (:func:`attention_flops`, 4·D per unmasked query-key
    pair, at the tensor-core peak, and with a softcap 3 more a pair —
    divide, tanh, multiply — at the float32 peak), or the bytes of q, k,
    v and o once each at the memory rate, whichever is larger."""
    ops_s = attention_flops(B, S, H, D, window) / HW.PEAK_FLOPS
    if softcap is not None:
        ops_s += 3 * B * H * attention_pairs(S, window) / HW.PEAK_F32_FLOPS
    bytes_s = (2 * B * S * H * D + 2 * B * S * KV * D) * 2 / HW.HBM_BW
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def wkv_bound(inputs, outputs) -> tuple[float, str]:
    """Least time on the card for the WKV, ms: the bytes of its inputs
    (r, k, v, w, u and s0 where one is passed) read once and its outputs
    (y, s_final) written once at the memory rate, or the recurrence's
    operations (:func:`wkv_flops`, 5·N² + 5·N a token and head), of
    which the two products r_t S and k_tᵀv_t (4·N²) at the TF32
    tensor-core peak and the rest (N² + 5·N) at the float32 peak
    outside the tensor cores — whichever is larger."""
    B, H, S, N = inputs[0].shape
    bytes_s = sum(map(_nbytes, list(inputs) + list(outputs))) / HW.HBM_BW
    on_tc = 4 * B * H * S * N * N
    ops_s = (on_tc / HW.PEAK_TF32_FLOPS
             + (wkv_flops(B, H, S, N) - on_tc) / HW.PEAK_F32_FLOPS)
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def model_flops(cfg, shape, kind: str) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active."""
    _, active = cfg.param_count()
    if kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch
