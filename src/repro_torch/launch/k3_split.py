"""K3's products in TF32, emulated on the CPU: why the kernel splits its
operands (3xTF32) and what that costs in error.

    PYTHONPATH=src python -m repro_torch.launch.k3_split

``csrc/wkv6.cu`` computes its three products — r̃·S, K̃ᵀ·V and the
scores·V — with ``mma.sync`` on TF32 operands (10 bits of mantissa) and
fp32 sums.  This script runs the same chunked algorithm in PyTorch with
each product's operands rounded as the card rounds them (``cvt.rna``:
to nearest, ties away from zero), in three modes:

- ``f32``: no rounding (the products in float64, then float32);
- ``1x``: one TF32 pass, a_hi · b_hi;
- ``3x``: a = a_hi + a_lo, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,

and prints each mode's largest error against the step-by-step plain
version (:func:`repro_torch.kernels.ref.wkv6_ref`) at ``chip_smoke.py``'s
input distributions, beside the kernel's tolerance 1e-4.  It needs no
card: the numbers describe the rounding, not the kernel's run.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.kernels import ref

__all__ = ["tf32", "chunked_wkv", "main"]

#: the kernel's tolerance against its plain version (chip_smoke.WKV_TOL)
WKV_TOL = 1e-4
MODES = ("f32", "1x", "3x")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: the low
    13 bits of the mantissa dropped, to nearest, ties away from zero."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with the operands rounded per ``mode``; the products exact
    and summed in float64, then rounded to float32."""
    if mode == "f32":
        return (a.double() @ b.double()).float()
    ah, bh = tf32(a), tf32(b)
    out = ah.double() @ bh.double()
    if mode == "3x":
        al, bl = tf32(a - ah), tf32(b - bh)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def _decay(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -40.0, 0.0))


def chunked_wkv(r, k, v, w, u, s0=None, *, chunk: int = 16,
                mode: str = "3x") -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunked WKV (csrc/wkv6.cu's header) with its three
    products in ``mode``.  r, k, v, w: (B, H, S, N); u: (H, N); s0:
    (B, H, N, N) or None.  Returns (y, s_final), float32."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}, want one of {MODES}")
    B, H, S, N = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    state = (torch.zeros(B, H, N, N) if s0 is None else s0.float().clone())
    y = torch.empty(B, H, S, N)
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        rr, kk, vv = (x[:, :, t0:t0 + n] for x in (r, k, v))
        lw = torch.log(torch.clamp(w[:, :, t0:t0 + n], min=1e-38))
        lc = torch.cumsum(lw, 2)
        lce = lc - lw
        last = lc[:, :, -1:]                  # the padding has w = 1
        scores = torch.einsum(
            "bhtn,bhsn,bhtsn->bhts", rr, kk,
            _decay(lce[:, :, :, None] - lc[:, :, None]))
        scores = torch.tril(scores, -1) + torch.diag_embed(
            (rr * u.float()[None, :, None] * kk).sum(-1))
        rt = rr * _decay(lce)
        kt = kk * _decay(last - lc)
        y[:, :, t0:t0 + n] = _mm(rt, state, mode) + _mm(scores, vv, mode)
        state = (_decay(last)[:, :, 0, :, None] * state
                 + _mm(kt.transpose(-1, -2), vv, mode))
    return y, state


def _inputs(B, H, S, *, bf16: bool, seed: int):
    """chip_smoke.wkv_inputs' distributions, on the CPU."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    r, k, v = (randn(B, H, S, 64) * 0.5 for _ in range(3))
    if bf16:
        r, k, v = (t.bfloat16() for t in (r, k, v))
    w = torch.exp(-torch.exp(randn(B, H, S, 64) - 1.0))
    return r, k, v, w, randn(H, 64) * 0.1, randn(B, H, 64, 64) * 0.5


def errors(B, H, S, *, bf16: bool, with_s0: bool, chunk: int,
           seed: int = 0) -> dict[str, float]:
    """Each mode's max |err| of y and s_final against the plain version."""
    r, k, v, w, u, s0 = _inputs(B, H, S, bf16=bf16, seed=seed)
    s0 = s0 if with_s0 else None
    y_ref, s_ref = ref.wkv6_ref(r, k, v, w, u, s0)
    out = {}
    for mode in MODES:
        y, s = chunked_wkv(r, k, v, w, u, s0, chunk=chunk, mode=mode)
        out[mode] = max((y - y_ref).abs().max().item(),
                        (s - s_ref).abs().max().item())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    cases = [  # B, H, S, bf16 r/k/v, s0, chunk
        (1, 64, 23, True, False, 16),      # the serving prefill
        (1, 64, 2048, True, False, 16),    # chip_smoke's timed shape
        (2, 4, 100, False, True, 16),      # ragged, random s0
        (2, 4, 128, False, False, 32),
    ]
    for B, H, S, bf16, with_s0, chunk in cases:
        errs = errors(B, H, S, bf16=bf16, with_s0=with_s0, chunk=chunk)
        print(f"B={B} H={H} S={S} {'bf16' if bf16 else 'f32'} r/k/v, "
              f"{'random' if with_s0 else 'no'} s0, chunk {chunk}: max|err| "
              + ", ".join(f"{m} {e:.3e}" for m, e in errs.items())
              + f" (tolerance {WKV_TOL:g})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
