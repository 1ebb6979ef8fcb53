#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero
and no result line is printed):

1. build — print the card's name and power limit, compile the three
   kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, started together), print the
   build seconds and what ``ptxas -v`` says of registers and spills,
   K1's dynamic shared memory a block, the ``HGMMA`` (tensor-core
   ``wgmma``) instructions ``cuobjdump -sass`` finds in each K1 kernel
   and the ``HMMA`` (``mma.sync``) ones in each K3 kernel, and K3's
   thread block cluster as the runtime reports it (width, clusters that
   fit at once, shared memory a block); K1's bf16 kernels and both K3
   kernels must hold their tensor-core instructions, and K3 must run in
   clusters;
2. kernels against their plain versions on the card —
   K1 (flash attention) against ``ref.attention_ref`` at the serving
   paths' shapes (llama3.2-1b D=64, recurrentgemma-2b MQA D=256 with its
   window), at prefill, MQA/f32, window, softcap and ragged shapes, and
   at the bf16 kernel's tile edges (S from 1 to 2048 around its 64- and
   128-row tiles at D=64, 128 and 256; windows of 64 and 100; softcap;
   B=2; G=1, 4 and 10), at the dense configs' serving and train shapes
   (at both of the engine's prompt buckets, S=16 and 32, for every
   served config: gemma2-9b G=2 D=256 with softcap 50, on its local
   layers with their 4096 window and on its global ones, also where
   window and softcap bite; deepseek-coder-33b G=7 and qwen1.5-110b G=8
   at D=128; musicgen-medium MHA; internvl2-1b G=7 D=64 after its
   256-row prefix, S = 272, 288 and its train step's B=8 S=384; G=7 and
   D=256 with softcap in f32; and the MoE configs' G = 5 and 6 at
   D=128: llama4-maverick H=40 KV=8 and mixtral-8x22b H=48 KV=8 with its
   4096 window, at S=16 and 32 in bf16 and f32, and at S=300 with a
   window that bites), within ``tests/test_kernels.py``'s tolerance
   (bf16 2e-2, f32 2e-5);
   K2 (the RG-LRU scan) against ``ref.rglru_ref`` at 1e-5 over
   ``tests/test_kernels.py``'s sweep, the serving shapes, S = 1, T−1, T,
   T+1 and 2048 around its chunk T (the one-pass loop and the chunked
   scan) with and without ``h0`` in float32 and bfloat16, and an ``h0``
   continuation across a chunk;
   K3 (the chunked RWKV-6 WKV) against ``ref.wkv6_ref`` at 1e-4 over
   ``tests/test_kernels.py``'s sweep, the serving shapes (64 heads, bf16
   r/k/v, a zero initial state), and in float32 and bfloat16: S = 1, 15,
   16, 17, 31, 32, 33 and 2048, chunks 1, 16 and 32, B=2, the model's
   strided layout, w = 1e-38, w = 1, half the channels at 1e-6 and half
   at 0.999, a random s0 and a continuation (two halves against the
   whole);
3. times — each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (a yardstick only: the port
   never calls it; ``scaled_dot_product_attention`` takes no softcap, so
   gemma2-9b's shape has none), beside the kernel's bound, at the serving
   shapes (K1 also at S=2048, at the full-width train step's B=8, S=128,
   at gemma2-9b's, deepseek-coder-33b's, llama4-maverick's and
   mixtral-8x22b's serving shapes and at internvl2-1b's prefix prefill
   and train step; K2 and K3 at S=2048);
   for K1 also its achieved
   TFLOP/s and its share of the bound; for K2 and K3 also the device
   time a launch from a replayed CUDA graph, since back-to-back calls at
   the serving shape time the Python wrapper;
4. serve llama3.2-1b — full width (bf16, seeded random weights) through
   ``repro_torch.launch.serve``: 8 requests, max batch 4, 16 new tokens,
   policy ``prediction``; K1 must have launched 16 × prefills;
5. serve recurrentgemma-2b — the same at its full width; K2 must have
   launched 18 × prefills and K1 8 × prefills;
6. serve rwkv6-7b — the same at its full width (7.58 B parameters); K3
   must have launched 32 × prefills.  For each model a small float32 one
   must give the same logits and greedy tokens on the card as the plain
   path on the CPU; for llama3.2-1b and recurrentgemma-2b a small bf16
   one (K1 on the tensor cores) must give logits within 2e-2 of the
   logits' scale of the CPU's;
7. gradients through the kernels — each kernel's gradient on the card
   (its forward, with the plain version's backward: ``kernels/ops.py``)
   against the fully plain autograd gradient on the card, for a random
   linear functional of the outputs: K1 at D=64, 128 and 256, with a
   window and a softcap, in float32 (1e-5) and bfloat16 (2e-2 of the
   gradient's scale); K2 (1e-5) and K3 (1e-4) at S = 1, 17 and 65 with
   and without h0 / s0; each kernel must have launched in its forward;
8. one train step of a small llama3.2-1b (d_model 256, head_dim 64, so
   that K1 runs; remat "full") on the card and on the CPU from the same
   weights: in float32, loss and grad norm within 1e-5 / 1e-4 and the
   parameters within one AdamW step everywhere and 1e-6 at all but 0.1 %
   of the elements (tests/test_torch_train.py's tolerances); in bfloat16
   the loss within 2e-2 of itself;
9. train llama3.2-1b at full width (16 layers, d_model 2048, bf16
   parameters, f32 AdamW state and gradient accumulation, remat "full")
   through ``repro_torch.train.trainer.Trainer``: global batch 8, 128
   tokens, accum 1, warmup 2, 6 steps; every loss and grad norm finite,
   the mean of the last two losses below the first two, and K1 launched
   exactly 32 times a step (16 layers, forward and the remat recompute;
   the backward recomputes the plain version).  Prints ms a step
   (synchronised), tokens/s, model TFLOP/s (6·N·B·S) and peak memory;
10. serve gemma2-9b at full width and depth (42 layers, alternating
    local/global attention, softcaps, 9.24 B parameters) as phase 4; K1
    must have launched 42 × prefills; a small float32 gemma2 (head_dim
    256, untied, nonzero norm and post-norm weights) must give the same
    logits and greedy tokens on the card as on the CPU, and a small bf16
    one logits within 2e-2 of their scale;
11. serve deepseek-coder-33b at full width and depth (62 layers, 62.1
    GiB of weights), alone on the card after every earlier model is
    freed; K1 62 × prefills;
12. serve qwen1.5-110b at full width but 8 of its 80 layers (13.36 B
    parameters, 24.9 GiB: the full depth's 207 GiB fits no single card;
    the cut is printed); K1 8 × prefills; a small float32 qwen (head_dim
    128, nonzero qkv biases) on the card against the CPU;
13. serve musicgen-medium at full width (48 layers), with no prefix, as
    the reference's engine serves it; K1 48 × prefills;
14. internvl2-1b at full width with a frontend prefix: ``prefill`` of a
    seeded (1, 256, 896) prefix and 16 tokens, 16 ``decode_step``s (the
    prefill and the decode steps timed apart), held
    teacher-forced against ``forward`` with the same prefix (the
    prefill's logits within 2e-2 of their scale, the argmax agreement
    printed), K1 exactly 24 launches (the prefill's); a small float32
    internvl2 with a prefix on the card against the CPU; then its
    ``Trainer`` with the SyntheticLM prefix: global batch 8, 384
    positions (256 + 128 tokens), 4 steps, every loss finite and K1
    exactly 48 launches a step (24 layers, forward and remat recompute);
15. serve llama4-maverick-400b-a17b at full width but 4 of its 48
    layers (2 dense and 2 MoE layers of 128 experts, top-1 and a shared
    expert; 35.04 B parameters, 65.26 GiB: the full depth's 741 GiB fits
    no card), alone on the card; the peak memory of its init (each
    expert stack filled one expert at a time) and of its serving run are
    printed; K1 4 × prefills; a small llama4 with all 128 experts (d_model
    64, head_dim 128, G=5) on the card against the CPU: float32 logits
    and greedy tokens, and bf16 logits within 2e-2 of their scale at the
    tokens that route alike on both devices (the ones routed apart are
    counted and held apart, with every later position of their row);
16. serve mixtral-8x22b at full width but 8 of its 56 layers (every
    layer MoE, 8 experts, top-2, window 4096; 20.44 B parameters, 38.06
    GiB); K1 8 × prefills; a small mixtral (head_dim 128, G=6, window
    16) on the card against the CPU as in phase 15;
17. one train step of a small llama4-maverick (d_model 256, head_dim 64,
    8 experts and the shared one, remat "full") on the card against the
    CPU in float32, at phase 8's tolerances; K1 2 × its layers.

The launch counts of each serving path and of each full-width train run
are set to 0 just before it and read just after; a kernel that the path
does not run must show 0.  No kernel of the MoE layer: the reference
computes the experts with ``jnp.einsum`` outside any kernel, and the port
with ``torch.bmm``.  The last two lines are the kernels' JSON
record and the result line ``{"ok": true, "device": {...}}``.  Needs one
CUDA device; fails without.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core FLOP/s
#: and device-memory bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: float32 FLOP/s outside the tensor cores, and TF32 FLOP/s on them (the
#: same data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SCAN_TOL = 1e-5
WKV_TOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def attention_inputs(torch, B, S, H, KV, D, dtype, *, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)
    return (randn(B, S, H, D, s=scale), randn(B, S, KV, D, s=scale),
            randn(B, S, KV, D))


def scan_inputs(torch, B, S, R, *, seed):
    """a in (0, 1) and b small, as the model's gates make them; h0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, R), generator=g, device="cuda"))
    b = torch.randn((B, S, R), generator=g, device="cuda") * 0.1
    h0 = torch.randn((B, R), generator=g, device="cuda")
    return a, b, h0


def wkv_inputs(torch, B, H, S, *, seed, rkv_dtype=None):
    """As tests/test_kernels.py makes them: r, k, v × 0.5 (in
    ``rkv_dtype``), w = exp(−exp(n − 1)), u × 0.1; and an initial state
    × 0.5."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (randn(B, H, S, 64) * 0.5 for _ in range(3))
    if rkv_dtype is not None:
        r, k, v = (t.to(rkv_dtype) for t in (r, k, v))
    w = torch.exp(-torch.exp(randn(B, H, S, 64) - 1.0))
    return r, k, v, w, randn(H, 64) * 0.1, randn(B, H, 64, 64) * 0.5


def attention_bound(B, S, H, KV, D, window=None,
                    softcap=None) -> tuple[float, str]:
    """Least time on the card for causal bf16 attention, ms: its
    operations (4·D per unmasked query-key pair at the tensor-core peak,
    and with a softcap 3 more a pair — divide, tanh, multiply — at the
    float32 peak), or the bytes of q, k, v and o once each at the memory
    rate, whichever is larger."""
    w = S if window is None else min(window, S)
    pairs = sum(min(i + 1, w) for i in range(S))
    ops_s = 4 * B * H * pairs * D / PEAK_BF16_FLOPS
    if softcap is not None:
        ops_s += 3 * B * H * pairs / PEAK_F32_FLOPS
    bytes_s = (2 * B * S * H * D + 2 * B * S * KV * D) * 2 / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def scan_bound(*tensors) -> tuple[float, str]:
    """Least time on the card for the scan, ms: the bytes of its inputs
    (a, b, h0) read once and its outputs (h, h_final) written once, at
    the memory rate.  Two flops a step: the bytes bound it."""
    return sum(t.numel() * t.element_size() for t in tensors) \
        / PEAK_BYTES * 1e3, "bytes"


def wkv_bound(inputs, outputs) -> tuple[float, str]:
    """Least time on the card for the WKV, ms: the bytes of its inputs
    (r, k, v, w, u and s0 where one is passed) read once and its outputs
    (y, s_final) written once at the memory rate, or the recurrence's
    operations — y_t = r_t S + (r_t·(u⊙k_t)) v_t and S = w_t⊙S + k_tᵀv_t,
    5·N² + 5·N a token and head, of which the two products r_t S and
    k_tᵀv_t (4·N²) at the TF32 tensor-core peak and the rest (N² + 5·N)
    at the float32 peak outside the tensor cores — whichever is
    larger."""
    r = inputs[0]
    B, H, S, N = r.shape
    bytes_s = sum(t.numel() * t.element_size()
                  for t in list(inputs) + list(outputs)) / PEAK_BYTES
    ops_s = B * H * S * (4 * N * N / PEAK_TF32_FLOPS
                         + (N * N + 5 * N) / PEAK_F32_FLOPS)
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def device_ms(torch, fn, calls: int = 50, replays: int = 5) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the wrapper's host
    time drops out and only the launches' device time is left."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def time_ms(torch, fn, iters: int) -> float:
    """Device ms per call: CUDA events around ``iters`` calls after a
    warm-up.  Inputs stay in L2 where they fit, as the serving path's
    prefill finds them right after the projections wrote them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- 1. build ------------------------------------------------------------------


def build(torch, kernels, fa, k3) -> None:
    from repro_torch.kernels import _build

    def timed(mod):
        t0 = time.perf_counter()
        lib = mod.build()
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(kernels)) as pool:
        built = list(pool.map(timed, kernels))
    for mod, (lib, secs) in zip(kernels, built):
        print(f"[build] {lib.name} in {secs:.1f} s")
        for line in _build.ptxas_report(mod._SOURCE):
            print(f"[ptxas] {line}")
    for D in (64, 128, 256):
        print(f"[smem] K1 D={D}: "
              + ", ".join(f"{dt}: {fa.smem_bytes(D, dt)} B"
                          for dt in (torch.bfloat16, torch.float32))
              + " of dynamic shared memory a block")
    hgmma = _build.sass_counts(fa._SOURCE, "HGMMA")
    for name, n in hgmma.items():
        print(f"[sass] {name}: {n} HGMMA")
    tc = [n for name, n in hgmma.items() if "flash_attention_tc" in name]
    check(len(tc) == 3 and all(n > 0 for n in tc),
          f"K1's bf16 kernels hold no HGMMA instruction: {hgmma}")
    # K3's products are mma.sync (SASS HMMA) in both instantiations, and
    # it runs in thread block clusters of a head's 4 CTAs
    hmma = {name: n for name, n in _build.sass_counts(k3._SOURCE,
                                                      "HMMA").items()
            if "wkv6_kernel" in name}
    for name, n in hmma.items():
        print(f"[sass] {name}: {n} HMMA")
    check(len(hmma) == 2 and all(n > 0 for n in hmma.values()),
          f"K3's kernels hold no HMMA instruction: {hmma}")
    for dt in (torch.float32, torch.bfloat16):
        info = k3.cluster_info(dt)
        print(f"[cluster] K3 {dt}: cluster width {info['cluster_width']}, "
              f"{info['max_active_clusters']} clusters fit on the card at "
              f"once, {info['smem_bytes']} B of dynamic shared memory a "
              "block")
        check(info["cluster_width"] > 1 and info["max_active_clusters"] > 0,
              f"K3 {dt}: cluster launch shape {info}")


# -- 2. kernels against their plain versions -------------------------------------


def check_attention(torch, fa, ref) -> float:
    """K1 against its plain version; returns the largest error at the
    serving and train paths' shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, S, H, KV, D, dtype, window, softcap, input scale
        ("serve S=16", 1, 16, 32, 8, 64, bf16, None, None, 1.0),
        ("serve S=32", 1, 32, 32, 8, 64, bf16, None, None, 1.0),
        ("prefill S=2048", 1, 2048, 32, 8, 64, bf16, None, None, 1.0),
        ("MQA D=128 f32", 2, 256, 8, 1, 128, f32, None, None, 1.0),
        ("window 128", 1, 512, 32, 8, 64, bf16, 128, None, 1.0),
        ("softcap 20", 1, 256, 32, 8, 64, bf16, None, 20.0, 3.0),
        ("ragged S=200", 2, 200, 32, 8, 64, bf16, None, None, 1.0),
        ("serve D=256 S=4", 1, 4, 10, 1, 256, bf16, 2048, None, 1.0),
        ("serve D=256 S=23", 1, 23, 10, 1, 256, bf16, 2048, None, 1.0),
        ("train B=8 S=128", 8, 128, 32, 8, 64, bf16, None, None, 1.0),
        ("D=256 S=2048", 1, 2048, 10, 1, 256, bf16, 2048, None, 1.0),
        ("D=256 window 128", 1, 512, 10, 1, 256, bf16, 128, None, 1.0),
    ]
    # the bf16 kernel's tile edges: 64-row warpgroups, 128-row blocks at
    # D=64 and 128, 64- and 128-key tiles
    for D, H, KV in ((64, 32, 8), (128, 8, 2), (256, 10, 1)):
        cases += [(f"edge D={D} S={S}", 1, S, H, KV, D, bf16, None, None, 1.0)
                  for S in (1, 63, 64, 65, 127, 128, 129, 2048)]
    cases += [
        ("window 64 D=64", 1, 300, 32, 8, 64, bf16, 64, None, 1.0),
        ("window 100 D=64", 1, 300, 32, 8, 64, bf16, 100, None, 1.0),
        ("window 64 D=256", 1, 300, 10, 1, 256, bf16, 64, None, 1.0),
        ("window 100 D=256", 1, 300, 10, 1, 256, bf16, 100, None, 1.0),
        ("softcap 20 D=128", 1, 300, 8, 2, 128, bf16, None, 20.0, 3.0),
        ("B=2 D=64", 2, 129, 32, 8, 64, bf16, None, None, 1.0),
        ("B=2 D=256", 2, 200, 10, 1, 256, bf16, 2048, None, 1.0),
        ("G=1 D=64", 1, 200, 8, 8, 64, bf16, None, None, 1.0),
        ("G=4 D=128", 1, 200, 8, 2, 128, bf16, None, None, 1.0),
        ("G=10 D=128", 1, 200, 20, 2, 128, bf16, None, None, 1.0),
    ]
    # the dense configs' serving and train shapes: gemma2-9b (G=2, D=256,
    # softcap 50 on every layer, window 4096 on the local ones: longer
    # than the prompt, so every key is kept), deepseek-coder-33b (G=7,
    # D=128), qwen1.5-110b (G=8, D=128), musicgen-medium (MHA, D=64) and
    # internvl2-1b (G=7, D=64) with its 256-row prefix before a 16- or
    # 32-token bucket, a ragged last 64-row block; then the same
    # options where they bite: a window shorter than S, softcap on
    # scores large enough to saturate, G=7 and D=256 with softcap in f32
    cases += [
        ("serve gemma2 S=16 local", 1, 16, 16, 8, 256, bf16, 4096, 50.0,
         1.0),
        ("serve gemma2 S=32 local", 1, 32, 16, 8, 256, bf16, 4096, 50.0,
         1.0),
        ("serve gemma2 S=32 global", 1, 32, 16, 8, 256, bf16, None, 50.0,
         1.0),
        ("gemma2 S=2048 window 1024", 1, 2048, 16, 8, 256, bf16, 1024, 50.0,
         3.0),
        ("gemma2 softcap 50 saturated", 2, 300, 16, 8, 256, bf16, 4096,
         50.0, 6.0),
        ("serve deepseek S=16", 1, 16, 56, 8, 128, bf16, None, None, 1.0),
        ("serve deepseek S=32", 1, 32, 56, 8, 128, bf16, None, None, 1.0),
        ("deepseek G=7 S=300", 2, 300, 56, 8, 128, bf16, None, None, 1.0),
        ("serve gemma2 S=16 global", 1, 16, 16, 8, 256, bf16, None, 50.0,
         1.0),
        ("serve qwen S=16", 1, 16, 64, 8, 128, bf16, None, None, 1.0),
        ("serve qwen S=32", 1, 32, 64, 8, 128, bf16, None, None, 1.0),
        ("serve musicgen S=16", 1, 16, 24, 24, 64, bf16, None, None, 1.0),
        ("serve musicgen S=32", 1, 32, 24, 24, 64, bf16, None, None, 1.0),
        ("serve internvl2 S=272", 1, 272, 14, 2, 64, bf16, None, None, 1.0),
        ("serve internvl2 S=288", 1, 288, 14, 2, 64, bf16, None, None, 1.0),
        ("train internvl2 B=8 S=384", 8, 384, 14, 2, 64, bf16, None, None,
         1.0),
        ("G=7 D=64 f32", 1, 272, 14, 2, 64, f32, None, None, 1.0),
        ("G=7 D=128 f32", 1, 100, 56, 8, 128, f32, None, None, 1.0),
        ("G=2 D=256 softcap f32", 1, 40, 16, 8, 256, f32, 16, 50.0, 6.0),
    ]
    # the MoE configs: llama4-maverick (G=5, D=128, no window) and
    # mixtral-8x22b (G=6, D=128, window 4096 on every layer) at both
    # prompt buckets, in bf16 and f32; and at S=300 (a ragged last tile)
    # with a window of 100 that bites
    for name, H, window in (("llama4", 40, None), ("mixtral", 48, 4096)):
        for S in (16, 32):
            cases += [(f"serve {name} S={S}", 1, S, H, 8, 128, bf16, window,
                       None, 1.0),
                      (f"{name} S={S} f32", 1, S, H, 8, 128, f32, window,
                       None, 1.0)]
        cases += [(f"{name} S=300 window 100", 1, 300, H, 8, 128, bf16, 100,
                   None, 1.0),
                  (f"{name} S=300", 2, 300, H, 8, 128, bf16, window, None,
                   1.0)]
    main_err = 0.0
    for i, (name, B, S, H, KV, D, dt, window, softcap, sc) in \
            enumerate(cases):
        q, k, v = attention_inputs(torch, B, S, H, KV, D, dt, seed=i,
                                   scale=sc)
        o = fa.flash_attention(q, k, v, window=window, softcap=softcap)
        torch.cuda.synchronize()
        o_ref = ref.attention_ref(q, k, v, window=window, softcap=softcap)
        check(o.shape == o_ref.shape and o.dtype == o_ref.dtype,
              f"{name}: kernel gave {o.dtype} {tuple(o.shape)}")
        check(bool(torch.isfinite(o).all()), f"{name}: non-finite output")
        err = (o.float() - o_ref.float()).abs().max().item()
        tol = TOL[str(dt).removeprefix("torch.")]
        ok = torch.allclose(o.float(), o_ref.float(), rtol=tol, atol=tol)
        print(f"[check] K1 {name:18s} {str(dt):15s} max|err| {err:.3e} "
              f"(rtol=atol={tol:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"K1 {name}: kernel disagrees with its plain version")
        if name.startswith(("serve", "train")):
            main_err = max(main_err, err)
    return main_err


def _held(torch, tag, name, dt, got, want, tol, failed) -> float:
    """Print one comparison of kernel outputs with their plain versions
    at rtol = atol = ``tol``; note a failure.  Returns the max |err|."""
    err = max((g - w).abs().max().item() if g.numel() else 0.0
              for g, w in zip(got, want))
    ok = all(g.shape == w.shape and g.dtype == torch.float32
             and bool(torch.isfinite(g).all())
             and torch.allclose(g, w, rtol=tol, atol=tol)
             for g, w in zip(got, want))
    print(f"[check] {tag} {name:24s} {str(dt):15s} max|err| {err:.3e} "
          f"(rtol=atol={tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"{tag} {name} {dt}")
    return err


def check_scan(torch, k2, ref) -> float:
    """K2 against its plain version, in float32 and bfloat16: the
    tests/test_kernels.py sweep, the serving shapes, S around the chunked
    scan's chunk T (1, T−1, T, T+1, 2048: the one-pass loop up to T, the
    three passes past it) with and without h0, and an h0 continuation.
    Returns the largest error at the serving path's shapes."""
    T = k2.chunk()
    cases = [  # name, B, S, R, with h0, dtype
        ("sweep 1x128x256", 1, 128, 256, False, torch.float32),
        ("sweep 2x256x512", 2, 256, 512, False, torch.float32),
        ("sweep 1x64x1024", 1, 64, 1024, False, torch.float32),
        ("serve S=4", 1, 4, 2560, False, torch.float32),
        ("serve S=23", 1, 23, 2560, False, torch.float32),
        ("h0 S=23", 1, 23, 2560, True, torch.float32),
        ("ragged B=2", 2, 1000, 300, True, torch.bfloat16),
    ]
    for dt in (torch.float32, torch.bfloat16):
        for S in (1, T - 1, T, T + 1, 2048):
            for with_h0 in (False, True):
                cases.append((f"edge S={S}" + (" h0" if with_h0 else ""), 1,
                              S, 2560, with_h0, dt))
    main_err, failed = 0.0, []
    for i, (name, B, S, R, with_h0, dt) in enumerate(cases):
        a, b, h0 = scan_inputs(torch, B, S, R, seed=100 + i)
        a, b = a.to(dt), b.to(dt)
        h0 = h0 if with_h0 else None
        h, hf = k2.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        want = ref.rglru_ref(a, b, h0)
        err = _held(torch, "K2", name, dt, (h, hf), (want, want[:, -1]),
                    SCAN_TOL, failed)
        if name.startswith(("serve", "train")):
            main_err = max(main_err, err)
    # continuation: two halves, the second from the first's final state
    a, b, h0 = scan_inputs(torch, 2, 2 * T + 6, 2560, seed=200)
    whole, wf = k2.rglru_scan(a, b, h0)
    half = T + 3
    h1, f1 = k2.rglru_scan(a[:, :half].contiguous(),
                           b[:, :half].contiguous(), h0)
    h2, f2 = k2.rglru_scan(a[:, half:].contiguous(),
                           b[:, half:].contiguous(), f1)
    torch.cuda.synchronize()
    _held(torch, "K2", "h0 continuation", torch.float32,
          (torch.cat([h1, h2], 1), f2), (whole, wf), SCAN_TOL, failed)
    check(not failed, f"K2 disagrees with its plain version: {failed}")
    return main_err


def check_wkv(torch, k3, ref) -> float:
    """K3 against its plain version at 1e-4, in float32 and bfloat16 r/k/v:
    the tests/test_kernels.py sweep, S = 1, 15, 16, 17, 31, 32, 33 and 2048
    around the chunk, chunks 1, 16 and 32, B=2, the serving shapes (64
    heads, a zero initial state), the model's strided layout, extreme and
    mixed decays, a random s0 and a continuation (two halves against the
    whole).  Returns the largest error at the serving path's shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, S, chunk, r/k/v dtype, initial state
        ("sweep 1x2x64 c16", 1, 2, 64, 16, f32, None),
        ("sweep 1x2x64 c32", 1, 2, 64, 32, f32, None),
        ("sweep 2x4x128 c16", 2, 4, 128, 16, f32, None),
        ("sweep 2x4x128 c32", 2, 4, 128, 32, f32, None),
        ("serve S=4", 1, 64, 4, 16, bf16, "zero"),
        ("serve S=23", 1, 64, 23, 16, bf16, "zero"),
    ]
    for dt in (f32, bf16):
        cases += [(f"S={S} c16", 1, 4, S, 16, dt, None)
                  for S in (1, 15, 16, 17, 31, 32, 33)]
        cases += [(f"S={S} c1", 1, 4, S, 1, dt, "random")
                  for S in (1, 17, 33)]
        cases += [(f"S={S} c32", 1, 4, S, 32, dt, "random")
                  for S in (31, 32, 33)]
        cases += [("B=2 S=100 s0", 2, 4, 100, 16, dt, "random"),
                  ("S=2048 c16", 1, 64, 2048, 16, dt, None),
                  ("S=2048 c32 s0", 1, 8, 2048, 32, dt, "random"),
                  ("S=2048 c1", 1, 2, 2048, 1, dt, None)]
    main_err, failed = 0.0, []
    for i, (name, B, H, S, chunk, dt, init) in enumerate(cases):
        r, k, v, w, u, s0 = wkv_inputs(torch, B, H, S, seed=300 + i,
                                       rkv_dtype=dt)
        s0 = {None: None, "zero": torch.zeros_like(s0),
              "random": s0}[init]
        y, sf = k3.wkv6(r, k, v, w, u, s0, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.wkv6_ref(r, k, v, w, u, s0)
        err = _held(torch, "K3", name, r.dtype, (y, sf), want, WKV_TOL,
                    failed)
        if name.startswith(("serve", "train")):
            main_err = max(main_err, err)
    for j, dt in enumerate((f32, bf16)):
        # the model's layout: head-transposed views of (B, S, H, N)
        r, k, v, w, u, s0 = wkv_inputs(torch, 2, 4, 40, seed=500 + j,
                                       rkv_dtype=dt)
        views = [t.transpose(1, 2).contiguous().transpose(1, 2)
                 for t in (r, k, v, w)]
        check(not views[0].is_contiguous(), "the strided case is contiguous")
        got = k3.wkv6(*views, u, s0)
        torch.cuda.synchronize()
        _held(torch, "K3", "model's strided layout", dt, got,
              ref.wkv6_ref(r, k, v, w, u, s0), WKV_TOL, failed)
        # decays at the clamp's edges: w = 1e-38 (clipped before the log)
        # and w = 1 everywhere; half the channels at 1e-6, half at 0.999
        r, k, v, w, u, s0 = wkv_inputs(torch, 1, 4, 100, seed=510 + j,
                                       rkv_dtype=dt)
        mixed = torch.where(torch.arange(64, device="cuda") < 32,
                            1e-6, 0.999).expand_as(w).contiguous()
        for name, wx in (("w=1e-38", torch.full_like(w, 1e-38)),
                         ("w=1", torch.ones_like(w)),
                         ("w=1e-6 | 0.999", mixed)):
            got = k3.wkv6(r, k, v, wx, u, s0)
            torch.cuda.synchronize()
            _held(torch, "K3", name, dt, got, ref.wkv6_ref(r, k, v, wx, u, s0),
                  WKV_TOL, failed)
        # continuation from a random s0: two halves (the first ending
        # mid-chunk) against the whole, and the whole against the plain
        # version
        r, k, v, w, u, s0 = wkv_inputs(torch, 1, 64, 128, seed=520 + j,
                                       rkv_dtype=dt)
        whole = k3.wkv6(r, k, v, w, u, s0)
        halves = [tuple(t[:, :, sl].contiguous() for t in (r, k, v, w))
                  for sl in (slice(0, 57), slice(57, None))]
        y1, s1 = k3.wkv6(*halves[0], u, s0)
        y2, s2 = k3.wkv6(*halves[1], u, s1)
        torch.cuda.synchronize()
        _held(torch, "K3", "halves vs whole", dt,
              (torch.cat([y1, y2], 2), s2), whole, WKV_TOL, failed)
        _held(torch, "K3", "whole from s0", dt, whole,
              ref.wkv6_ref(r, k, v, w, u, s0), WKV_TOL, failed)
    check(not failed, f"K3 disagrees with its plain version: {failed}")
    return main_err


# -- 3. times -----------------------------------------------------------------------


def time_attention(torch, fa, ref, B, S, H, KV, D, window=None,
                   softcap=None) -> dict:
    from torch.nn import functional as F
    sdpa_gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) \
        >= (2, 5)
    q, k, v = attention_inputs(torch, B, S, H, KV, D, torch.bfloat16,
                               seed=S + D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not sdpa_gqa:
        kt = kt.repeat_interleave(H // KV, dim=1)
        vt = vt.repeat_interleave(H // KV, dim=1)
    gqa_kw = {"enable_gqa": True} if sdpa_gqa else {}
    mask = None
    if window is not None and window < S:
        pos = torch.arange(S, device="cuda")
        mask = (pos[:, None] >= pos[None, :]) \
            & (pos[:, None] - pos[None, :] < window)

    def library():
        if softcap is not None:
            return None         # sdpa takes no softcap
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=True, **gqa_kw)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              **gqa_kw)

    o = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    o_ref = ref.attention_ref(q, k, v, window=window, softcap=softcap)
    tol = TOL["bfloat16"]
    err = (o.float() - o_ref.float()).abs().max().item()
    check(o.shape == o_ref.shape and bool(torch.isfinite(o).all())
          and torch.allclose(o.float(), o_ref.float(), rtol=tol, atol=tol),
          f"K1 timed at B={B} S={S} D={D}: kernel disagrees with its plain "
          f"version (max|err| {err:.3e})")
    iters = 200 if S <= 32 else 20
    row = {
        "ms": time_ms(torch, lambda: fa.flash_attention(
            q, k, v, window=window, softcap=softcap), iters),
        "plain_ms": time_ms(torch, lambda: ref.attention_ref(
            q, k, v, window=window, softcap=softcap), iters),
        "library_ms": None if softcap is not None
        else time_ms(torch, library, iters),
    }
    row["bound_ms"], row["bound_by"] = attention_bound(B, S, H, KV, D,
                                                       window, softcap)
    row["shape"] = (f"B={B} S={S} H={H} KV={KV} D={D} bf16"
                    + (f" window {window}" if window else "")
                    + (f" softcap {softcap:g}" if softcap else ""))
    print(f"[check] K1 timed {row['shape']}: max|err| {err:.3e} "
          f"(rtol=atol={tol:g}) ok")
    lib = "none (sdpa takes no softcap)" if row["library_ms"] is None \
        else f"{row['library_ms']:.5f} ms"
    print(f"[time] K1 {row['shape']}: kernel {row['ms']:.5f} ms, plain "
          f"{row['plain_ms']:.5f} ms, sdpa {lib}, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    w = S if window is None else min(window, S)
    flops = 4 * B * H * D * sum(min(i + 1, w) for i in range(S))
    lib = "" if row["library_ms"] is None \
        else f" (sdpa {flops / row['library_ms'] / 1e9:.2f})"
    print(f"[time] K1 {row['shape']}: {flops / row['ms'] / 1e9:.2f} TFLOP/s "
          f"achieved{lib}, {row['bound_ms'] / row['ms']:.4f} of the bound")
    return row


def time_scan(torch, k2, ref, B, S, R) -> dict:
    a, b, _ = scan_inputs(torch, B, S, R, seed=S)
    h, hf = k2.rglru_scan(a, b)
    row = {
        "ms": time_ms(torch, lambda: k2.rglru_scan(a, b),
                      200 if S <= 32 else 50),
        "plain_ms": time_ms(torch, lambda: ref.rglru_ref(a, b),
                            50 if S <= 32 else 3),
        "library_ms": None,     # no single PyTorch call is a linear scan
    }
    row["device_ms"] = device_ms(torch, lambda: k2.rglru_scan(a, b),
                                 50 if S <= 32 else 20)
    row["bound_ms"], row["bound_by"] = scan_bound(a, b, h, hf)
    row["shape"] = f"B={B} S={S} R={R} f32"
    print(f"[time] K2 {row['shape']}: kernel {row['ms']:.5f} ms a call "
          f"({row['device_ms']:.5f} ms of device time, CUDA graph), plain "
          f"{row['plain_ms']:.5f} ms, no library call, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


def time_wkv(torch, k3, ref, B, H, S, *, zero_s0: bool) -> dict:
    """K3 at the serving path's inputs: bf16 r/k/v, f32 w and u, and (as
    prefill passes it) a zero initial state when ``zero_s0``."""
    r, k, v, w, u, s0 = wkv_inputs(torch, B, H, S, seed=S,
                                   rkv_dtype=torch.bfloat16)
    s0 = torch.zeros_like(s0) if zero_s0 else None
    y, sf = k3.wkv6(r, k, v, w, u, s0)
    row = {
        "ms": time_ms(torch, lambda: k3.wkv6(r, k, v, w, u, s0),
                      200 if S <= 32 else 50),
        "plain_ms": time_ms(torch, lambda: ref.wkv6_ref(r, k, v, w, u, s0),
                            20 if S <= 32 else 3),
        "library_ms": None,     # no single PyTorch call computes the WKV
    }
    row["device_ms"] = device_ms(torch, lambda: k3.wkv6(r, k, v, w, u, s0),
                                 50 if S <= 32 else 20)
    inputs = [r, k, v, w, u] + ([s0] if s0 is not None else [])
    row["bound_ms"], row["bound_by"] = wkv_bound(inputs, [y, sf])
    row["shape"] = (f"B={B} H={H} S={S} N=64 bf16 r/k/v"
                    + (", zero s0" if zero_s0 else ", no s0"))
    print(f"[time] K3 {row['shape']}: kernel {row['ms']:.5f} ms a call "
          f"({row['device_ms']:.5f} ms of device time, CUDA graph), plain "
          f"{row['plain_ms']:.5f} ms, no library call, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


# -- 4.-6. serving ----------------------------------------------------------------


def free_card(torch) -> None:
    """Return the memory of the models and engines that went out of scope
    (their event buses hold reference cycles) to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_full_width(torch, arch: str, kernels: dict, expect: dict,
                     tag: str, n_layers: int | None = None) -> dict:
    """Serve ``arch`` at full width through the launcher's code path —
    at its full depth, or cut to ``n_layers`` where the weights do not
    fit one card; returns the launch counts of the run, read just after
    it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import report, serve
    from repro_torch.models import forward, init_params

    cfg = get_config(arch)
    check(cfg.param_dtype == "bfloat16", f"unexpected {arch} config")
    if n_layers is not None:
        full = cfg.param_count()[0]
        cfg = cfg.replace(n_layers=n_layers)
        print(f"[{tag}] depth cut to {n_layers} of {get_config(arch).n_layers}"
              f" layers: {full / 1e9:.2f} B parameters, "
              f"{full * 2 / 2**30:.1f} GiB of bf16 weights at full depth, "
              "do not fit one card")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[{tag}] {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.kv_heads}, head_dim {cfg.head_dim}, vocab "
          f"{cfg.vocab}, {cfg.param_dtype}: {n_params / 1e9:.3f} B "
          f"parameters, {n_bytes / 2**30:.2f} GiB; peak memory of the init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
    serve(cfg, requests=2, max_batch=4, max_new=2, seed=1,
          params=params)                                      # warm-up
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.launches = 0
    result = serve(cfg, requests=8, max_batch=4, max_new=16,
                   policy="prediction", seed=0, device="cuda",
                   params=params)
    launches = {name: mod.launches for name, mod in kernels.items()}
    engine, reqs = result["engine"], result["requests"]
    for line in report(result):
        print(f"[{tag}] {line}")
    lat = sorted(r.done_at - r.submitted_at for r in reqs)
    print(f"[{tag}] ticks {engine.ticks}, prefills {engine.prefills}, "
          f"kernel launches {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"latency max {lat[-1] * 1e3:.1f} ms")
    check(engine.prefills == len(reqs), "not every request was prefilled")
    for name, per_prefill in expect.items():
        check(launches[name] == per_prefill * engine.prefills,
              f"{arch}: {launches[name]} {name} launches for "
              f"{engine.prefills} prefills, want {per_prefill} each")
    check(all(r.done and len(r.output) == 16 for r in reqs),
          "a request did not finish with 16 tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.output),
          "a token outside the vocabulary")
    toks = torch.tensor([reqs[0].prompt + reqs[0].output[:-1]],
                        device="cuda")
    with torch.no_grad():
        logits, _ = forward(engine.params, toks, cfg)
    check(logits.shape == (1, toks.shape[1], cfg.padded_vocab())
          and bool(torch.isfinite(logits).all()),
          f"full-width logits {tuple(logits.shape)} not finite")
    # Teacher-forced, the forward's argmax is what the engine decoded
    # except where bf16 rounding flips a near-tie (informational): the
    # gap is how far below the forward's largest logit the engine's
    # token's logit lies, 0 where they agree.
    n = len(reqs[0].prompt)
    lg = logits[0, n - 1:, :cfg.vocab].float()
    chosen = torch.tensor(reqs[0].output, device=lg.device)
    gap = lg.max(-1).values - lg.gather(-1, chosen[:, None])[:, 0]
    same = int((lg.argmax(-1) == chosen).sum())
    print(f"[{tag}] request 0: forward argmax equals the engine's token "
          f"at {same}/{len(reqs[0].output)} steps; largest gap "
          f"{gap.max().item():.4f} (logits up to "
          f"{lg.abs().max().item():.2f})")
    return launches


def _small_model(torch, arch: str, dtype: str, nonzero: bool, overrides):
    """A small model of ``arch``; with ``nonzero`` the leaves that the
    init leaves at zero (``ZERO_INIT``: norm weights and qkv biases) are
    drawn nonzero, so that a bias or a post-norm the card path dropped
    would show."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import ZERO_INIT

    small = get_smoke_config(arch).replace(param_dtype=dtype, **overrides)
    cpu_model = init_params(small, torch.Generator().manual_seed(0),
                            device="cpu")
    if nonzero:
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for name, p in cpu_model.named_parameters():
                if name.rpartition(".")[2] in ZERO_INIT:
                    p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, small.vocab, (2, 24), generator=g)
    prefix = None
    if small.frontend_len:
        prefix = torch.randn((2, small.frontend_len, small.d_model),
                             generator=g)
    return small, cpu_model, copy.deepcopy(cpu_model).to("cuda"), toks, \
        prefix


def small_model_on_card_and_cpu(torch, arch: str, tag: str,
                                nonzero: bool = False, **overrides) -> None:
    """A small float32 model: the card (kernels) against the CPU
    (plain versions), logits (after a frontend prefix where the config
    has one) and greedy tokens."""
    from repro_torch.models import forward
    from repro_torch.serving import Request, ServingEngine

    small, cpu_model, gpu_model, toks, prefix = _small_model(
        torch, arch, "float32", nonzero, overrides)
    with torch.no_grad():
        l_cpu, _ = forward(cpu_model, toks, small, prefix=prefix)
        l_gpu, _ = forward(gpu_model, toks.cuda(), small,
                           prefix=None if prefix is None else prefix.cuda())
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    print(f"[{tag}] small f32 model logits"
          + ("" if prefix is None else
             f" after a {small.frontend_len}-position prefix")
          + f", card vs CPU: max|err| {err:.3e} (1e-4)")
    check(err <= 1e-4, f"{arch}: small model logits differ between card "
                       "and CPU")
    prompts = [[5, 9, 2, 7], [1, 2, 3], [4, 5, 6, 7, 8], [9, 10],
               list(range(20, 34))]
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        eng = ServingEngine(small, model, max_batch=2, max_len=64,
                            device=dev)
        rs = [eng.submit(Request(prompt=p, max_new_tokens=6))
              for p in prompts]
        eng.run_until_drained()
        outs.append([r.output for r in rs])
    print(f"[{tag}] small f32 engine, greedy tokens card == CPU: "
          f"{outs[0] == outs[1]}")
    check(outs[0] == outs[1], f"{arch}: greedy tokens differ between "
                              "card and CPU")


def _moe_inputs(model) -> tuple[list, list]:
    """Forward pre-hooks that record the (x, router) of every MoE layer's
    call in ``model``; returns (records, hooks)."""
    from repro_torch.models.layers import MoELayer

    seen, hooks = [], []
    for layer in model.layers:
        if isinstance(layer, MoELayer):
            hooks.append(layer.moe.register_forward_pre_hook(
                lambda m, args: seen.append((args[0], m.router))))
    return seen, hooks


def _routes(torch, x, router, cfg):
    """The routes of x (B, S, d) on its device, as the MoE layer takes
    them: each token's top-k experts (B, S, k), and whether each route
    fits its expert's capacity (one chunk, slot-major, every route
    counted) — on the CPU."""
    idx = torch.topk(torch.softmax(x.float() @ router.float(), dim=-1),
                     cfg.top_k, dim=-1).indices.cpu()
    B, S, k = idx.shape
    C = max(k, int(math.ceil(S * k / cfg.n_experts * cfg.capacity_factor)))
    kept = torch.zeros(idx.shape, dtype=torch.bool)
    for b in range(B):
        fill = [0] * cfg.n_experts
        for slot in range(k):
            for t in range(S):
                e = int(idx[b, t, slot])
                kept[b, t, slot] = fill[e] < C
                fill[e] += 1
    return idx, kept


def small_bf16_model_on_card_and_cpu(torch, fa, arch: str, tag: str,
                                     nonzero: bool = False,
                                     **overrides) -> None:
    """A small bf16 model: the card (K1 on the tensor cores) against the
    CPU (plain versions), logits within 2e-2 of the logits' scale, as
    tests/test_torch_model.py holds bf16.  Greedy tokens are not compared:
    bf16 rounds differently on the two devices and near-ties flip.  In a
    MoE model a near-tie in a router sends a token to another expert: each
    device's routes are taken from its own inputs to every MoE layer, and
    a token routed apart, with every later position of its row (which
    attends to it or shares its capacity), is counted and held apart, as
    tests/test_torch_moe.py holds the two frameworks."""
    from repro_torch.models import forward

    small, cpu_model, gpu_model, toks, _ = _small_model(
        torch, arch, "bfloat16", nonzero, overrides)
    check(small.moe_seq_chunk == 0 or toks.shape[1] <= small.moe_seq_chunk,
          f"{arch}: the routes are compared over one chunk")
    seen, hooks = {}, []
    for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        seen[dev], h = _moe_inputs(model)
        hooks += h
    with torch.no_grad():
        l_cpu, _ = forward(cpu_model, toks, small)
        fa.launches = 0
        l_gpu, _ = forward(gpu_model, toks.cuda(), small)
        torch.cuda.synchronize()
    launched = fa.launches
    for h in hooks:
        h.remove()
    apart = torch.zeros(toks.shape, dtype=torch.bool)
    for on_cpu, on_gpu in zip(seen["cpu"], seen["cuda"]):
        (i_c, k_c), (i_g, k_g) = (_routes(torch, x, r, small)
                                  for x, r in (on_cpu, on_gpu))
        apart |= ((i_c != i_g) | (k_c != k_g)).any(-1)
    held = torch.cummax(apart.int(), dim=1).values == 0
    want = l_cpu.float()[held]
    err = (l_gpu.cpu().float()[held] - want).abs().max().item()
    scale = want.abs().max().item()
    moe = "" if not seen["cpu"] else (
        f" over {int(held.sum())} of {held.numel()} positions "
        f"({int(apart.sum())} tokens routed apart over "
        f"{len(seen['cpu'])} MoE layers)")
    print(f"[{tag}] small bf16 model logits, card vs CPU{moe}: max|err| "
          f"{err:.3e} (2e-2 of the logits' scale {scale:.3f}: "
          f"{2e-2 * scale:.3e}); K1 launches {launched}")
    check(launched > 0, f"{arch}: the bf16 model did not run K1")
    check(held.float().mean().item() >= 0.5,
          f"{arch}: more than half the positions routed apart")
    check(bool(torch.isfinite(l_gpu).all()) and err <= 2e-2 * scale,
          f"{arch}: small bf16 model logits differ between card and CPU")


# -- 7.-9. training ------------------------------------------------------------------


def _functional_grads(torch, outs, inputs, seed: int):
    """Gradients of a random linear functional of ``outs`` (float32
    coefficients drawn on the card from ``seed``) with respect to
    ``inputs``."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device="cuda").manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                        device="cuda")).sum() for o in outs)
    return torch.autograd.grad(loss, inputs)


def check_gradients(torch, ops, ref, fa, k2, k3) -> None:
    """Each kernel's gradient (kernel forward, plain backward) against the
    fully plain autograd gradient on the card, inputs and outputs alike."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []      # name, module, dispatch, plain, inputs, tolerance
    for D, H, KV in ((64, 8, 2), (128, 8, 2), (256, 10, 1)):
        for dt in (f32, bf16):
            for window, softcap in ((None, None), (24, None), (None, 20.0)):
                q, k, v = attention_inputs(torch, 2, 40, H, KV, D, dt,
                                           seed=D + (window or 0),
                                           scale=3.0 if softcap else 1.0)
                cases.append((
                    f"D={D} window={window} softcap={softcap}", fa,
                    lambda *x, w=window, c=softcap: ops.attention(
                        *x, window=w, softcap=c),
                    lambda *x, w=window, c=softcap: ref.attention_ref(
                        *x, window=w, softcap=c),
                    [q, k, v], TOL["float32"] / 2 if dt == f32 else None))
    for S in (1, 17, 65):
        for with_state in (False, True):
            a, b, h0 = scan_inputs(torch, 2, S, 256, seed=S)
            cases.append((f"S={S}" + (" h0" if with_state else ""), k2,
                          ops.rglru, ops._rglru_plain,
                          [a, b, h0 if with_state else None], SCAN_TOL))
            r, k, v, w, u, s0 = wkv_inputs(torch, 1, 4, S, seed=S)
            cases.append((f"S={S}" + (" s0" if with_state else ""), k3,
                          ops.wkv, ref.wkv6_ref,
                          [r, k, v, w, u, s0 if with_state else None],
                          WKV_TOL))
    failed = []
    for i, (name, mod, dispatch, plain, inputs, tol) in enumerate(cases):
        tag = {id(fa): "K1", id(k2): "K2", id(k3): "K3"}[id(mod)]
        inputs = [None if x is None else x.detach().requires_grad_(True)
                  for x in inputs]
        wrt = [x for x in inputs if x is not None]
        before = mod.launches
        got = _functional_grads(torch, dispatch(*inputs), wrt, i)
        launched = mod.launches - before
        want = _functional_grads(torch, plain(*inputs), wrt, i)
        torch.cuda.synchronize()
        errs, ok = [], launched == 1
        for gg, ww in zip(got, want):
            gg, ww = gg.float(), ww.float()
            t = tol if tol is not None \
                else TOL["bfloat16"] * ww.abs().max().item()
            errs.append((gg - ww).abs().max().item())
            ok &= bool(torch.isfinite(gg).all()) and torch.allclose(
                gg, ww, rtol=tol or 0.0, atol=t)
        dt = str(inputs[0].dtype).removeprefix("torch.")
        print(f"[grad] {tag} {name:32s} {dt:8s} launches {launched}, "
              f"max|Δgrad| {max(errs):.3e} over {len(wrt)} inputs "
              f"({'ok' if ok else 'FAIL'})")
        if not ok:
            failed.append(f"{tag} {name} {dt}")
    check(not failed, f"kernel-forward gradients differ from the plain "
                      f"ones: {failed}")


def train_step_on_card_and_cpu(torch, fa, dtype: str,
                               arch: str = "llama3.2-1b") -> None:
    """One train step of a small ``arch`` (K1 at D=64) on the card and on
    the CPU from the same weights and batch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.steps import StepConfig, make_train_step

    small = get_smoke_config(arch).replace(
        param_dtype=dtype, d_model=256, n_heads=4, kv_heads=2, head_dim=64,
        d_ff=512, remat="full")
    data = SyntheticLM(vocab=small.vocab, seq_len=64, global_batch=4,
                       seed=0)
    batch_np = next(data)
    data.close()
    step = make_train_step(small, AdamWConfig(), StepConfig(warmup=0))
    cpu_model = init_params(small, torch.Generator().manual_seed(0),
                            device="cpu")
    out = {}
    for dev, model in (("cuda", copy.deepcopy(cpu_model).to("cuda")),
                       ("cpu", cpu_model)):
        state = adamw_init(dict(model.named_parameters()), AdamWConfig())
        batch = {k: torch.from_numpy(getattr(batch_np, k)).to(dev,
                                                              torch.long)
                 for k in ("tokens", "labels")}
        fa.launches = 0
        model, state, m = step(model, state, 0, batch)
        out[dev] = (model, float(m["loss"]), float(m["grad_norm"]),
                    fa.launches)
    (gpu, l_gpu, n_gpu, launched), (cpu, l_cpu, n_cpu, _) = \
        out["cuda"], out["cpu"]
    tag = f"train step, small {arch} {dtype}"
    print(f"[{tag}] loss card {l_gpu:.7f} CPU {l_cpu:.7f}; grad norm card "
          f"{n_gpu:.7f} CPU {n_cpu:.7f}; K1 launches {launched}")
    check(launched == 2 * small.n_layers,
          f"{tag}: {launched} K1 launches, want {2 * small.n_layers}")
    if dtype == "bfloat16":
        check(abs(l_gpu - l_cpu) <= 2e-2 * abs(l_cpu),
              f"{tag}: loss differs between card and CPU")
        return
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
          and abs(n_gpu - n_cpu) <= 1e-4 * abs(n_cpu),
          f"{tag}: loss or grad norm differs between card and CPU")
    worst, far = 0.0, 0
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        d = (pg.detach().cpu() - pc.detach()).abs()
        worst = max(worst, d.max().item())
        far += int((d > 1e-6).sum())
        check(d.max().item() <= AdamWConfig().lr,
              f"{tag}: {name} more than one step apart")
    n = sum(p.numel() for p in cpu.parameters())
    print(f"[{tag}] params after the step: max|Δ| {worst:.3e}, "
          f"{far} of {n} elements beyond 1e-6")
    check(far <= 1e-3 * n, f"{tag}: parameters differ between card and CPU")


def check_update(torch, trainer, tag: str,
                 leaves=("embed", "layers.0.wq", "layers.7.mlp.w2",
                         "layers.15.wo", "final_ln"),
                 n: int = 1 << 22) -> None:
    """One more step of ``trainer``, split as its step is (``grads_of``,
    then ``apply_update``).  On the first ``n`` elements of a few leaves
    the new parameters and moments are held against AdamW written out
    here in float64 on the CPU, from the same gradients, moments, global
    norm and schedule: parameters within one bfloat16 ulp, moments at
    1e-6 of their largest value."""
    from repro_torch.train.steps import apply_update, grads_of

    cfg, opt, scfg = trainer.cfg, trainer.tcfg.opt, trainer.step_cfg
    batch_np = next(trainer.data)
    batch = {k: torch.from_numpy(getattr(batch_np, k)).to(trainer.device,
                                                          torch.long)
             for k in ("tokens", "labels")}
    named = dict(trainer.params.named_parameters())
    _, grads = grads_of(trainer.params, cfg, batch, scfg)

    def head(t):
        return t.detach().reshape(-1)[:n].cpu().double()

    before = {k: (head(named[k]), head(trainer.opt_state["mu"][k]),
                  head(trainer.opt_state["nu"][k]), head(grads[k]))
              for k in leaves}
    count = int(trainer.opt_state["count"]) + 1
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    clip = min(1.0, scfg.clip_norm / max(gnorm, 1e-9))
    step = trainer.step
    if step < scfg.warmup:
        lr_scale = step / max(scfg.warmup, 1)
    else:
        frac = min(max((step - scfg.warmup)
                       / max(scfg.total_steps - scfg.warmup, 1), 0.0), 1.0)
        lr_scale = 0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac))
    trainer.opt_state, norm, _ = apply_update(
        trainer.params, trainer.opt_state, step, grads, cfg, opt, scfg)
    check(abs(float(norm) - gnorm) <= 1e-4 * gnorm,
          f"{tag}: grad norm {float(norm)} against {gnorm} in float64")
    moved = 0
    for k in leaves:
        p0, m0, v0, g = before[k]
        g = g * clip
        m = opt.b1 * m0 + (1 - opt.b1) * g
        v = opt.b2 * v0 + (1 - opt.b2) * g * g
        upd = (m / (1 - opt.b1 ** count)) \
            / (torch.sqrt(v / (1 - opt.b2 ** count)) + opt.eps) \
            + opt.weight_decay * p0
        want = p0 - opt.lr * lr_scale * upd
        got = head(named[k])
        ulp = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want)[1] - 8)   # bfloat16's 8 bits
        err = ((got - want).abs() / ulp).max().item()
        seen = int(((want - p0).abs() > 2 * ulp).sum())
        moved += seen
        err_m = max(((head(trainer.opt_state[x][k]) - w).abs().max()
                     / w.abs().max().clamp(min=1e-30)).item()
                    for x, w in (("mu", m), ("nu", v)))
        print(f"[{tag}] update of {k} (first {p0.numel()}): max|p − "
              f"AdamW in float64| {err:.3f} ulp, {seen} elements move by "
              f"more than 2 ulp; moments within {err_m:.2e} of their "
              f"largest")
        check(err <= 1.0 and err_m <= 1e-6,
              f"{tag}: the update of {k} differs from AdamW in float64")
    check(moved > 0, f"{tag}: no checked element moved visibly")


def run_trainer(torch, kernels: dict, tag: str, arch: str, tcfg):
    """The port's Trainer on ``arch`` at full width for ``tcfg.steps``
    steps; prints ms a step (synchronised), tokens/s, model TFLOP/s
    (6·N·B·S, the prefix counted in S) and peak memory.  Returns the
    trainer, its history and the launch counts of the run, read just
    after it."""
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import Trainer

    cfg = get_config(arch)
    check(cfg.param_dtype == "bfloat16" and cfg.remat == "full",
          f"unexpected {arch} config")
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tcfg, device="cuda")
    n_params = sum(p.numel() for p in trainer.params.parameters())
    print(f"[{tag}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters ({cfg.param_dtype}), AdamW "
          f"state {tcfg.opt.state_dtype}, grads {tcfg.step.grad_dtype}, "
          f"remat {cfg.remat}; global batch {tcfg.global_batch}, "
          f"{tcfg.seq_len} positions a row"
          + (f" ({cfg.frontend_len} of them the frontend prefix)"
             if cfg.frontend_len else ""))
    for mod in kernels.values():
        mod.launches = 0
    hist = trainer.run()
    launches = {name: mod.launches for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    dts = [h["dt"] for h in hist]
    tokens = tcfg.global_batch * tcfg.seq_len
    steady = sum(dts[2:]) / len(dts[2:])
    flops = 6.0 * cfg.param_count()[1] * tokens
    print(f"[{tag}] losses {[round(x, 5) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}")
    print(f"[{tag}] ms a step (synchronised) "
          f"{[round(d * 1e3, 3) for d in dts]}; steps 3-{len(dts)}: "
          f"{steady * 1e3:.3f} ms, {tokens / steady:.1f} tokens/s, "
          f"{flops / steady / 1e12:.2f} model TFLOP/s (6·N·B·S = "
          f"{flops:.4e}); peak memory {peak / 2**30:.2f} GiB; kernel "
          f"launches {launches}")
    check(all(math.isfinite(x) for x in losses + norms),
          "a loss or grad norm is not finite")
    want = {"flash_attention": 2 * cfg.n_layers * len(hist),
            "rglru_scan": 0, "wkv6": 0}
    check(launches == want, f"{tag}: kernel launches {launches}, want "
                            f"{want} (K1 {2 * cfg.n_layers} a step: "
                            "forward and remat recompute)")
    return trainer, losses, launches


def train_full_width(torch, kernels: dict, tag: str) -> dict:
    """The port's Trainer on llama3.2-1b at full width, then one more
    step held against AdamW in float64; returns the launch counts of the
    run, read just after it."""
    from repro_torch.train.steps import StepConfig
    from repro_torch.train.trainer import TrainerConfig

    tcfg = TrainerConfig(steps=6, global_batch=8, seq_len=128, log_every=1,
                         step=StepConfig(accum=1, warmup=2))
    trainer, losses, launches = run_trainer(torch, kernels, tag,
                                            "llama3.2-1b", tcfg)
    check_update(torch, trainer, tag)
    trainer.close()
    check(sum(losses[-2:]) < sum(losses[:2]),
          f"the loss did not fall: {losses}")
    return launches


# -- 10.-14. the dense configs -----------------------------------------------------


def serve_with_prefix(torch, kernels: dict, tag: str) -> dict:
    """internvl2-1b at full width with a frontend prefix, through the
    entry points that take one (``prefill`` and ``decode_step``; the
    engine, as the reference's, takes none): a seeded (1, 256, 896)
    prefix and a 16-token prompt, then 16 greedy decode steps, held
    teacher-forced against ``forward`` with the same prefix.  Returns the
    launch counts of the prefill and the steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = get_config("internvl2-1b")
    F, T, n_new = cfg.frontend_len, 16, 16
    params = init_params(cfg, device="cuda", seed=0)
    print(f"[{tag}] {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.kv_heads}, head_dim {cfg.head_dim}: "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"parameters; prefix ({1}, {F}, {cfg.d_model}), {T} prompt tokens")
    g = torch.Generator(device="cuda").manual_seed(5)
    # SyntheticLM's scale for a frontend's embeddings
    prefix = (torch.randn((1, F, cfg.d_model), generator=g, device="cuda")
              * 0.02).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (1, T), generator=g, device="cuda")

    def generate():
        """The greedy tokens, the logits of each step, and the seconds of
        the prefill and of the decode steps (``int`` of an argmax waits
        for the card)."""
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompt, cfg, max_len=F + T + n_new,
                                prefix=prefix)
        out, steps = [int(torch.argmax(logits[0, :cfg.vocab]))], [logits[0]]
        t1 = time.perf_counter()
        for i in range(n_new):
            lg, cache = decode_step(
                params, torch.tensor([out[-1]], device="cuda"),
                torch.tensor(F + T + i, device="cuda"), cache, cfg)
            steps.append(lg[0])
            out.append(int(torch.argmax(lg[0, :cfg.vocab])))
        return out, torch.stack(steps), t1 - t0, time.perf_counter() - t1

    with torch.no_grad():
        generate()                                          # warm-up
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.launches = 0
        out, step_logits, t_prefill, t_decode = generate()
        launches = {name: mod.launches for name, mod in kernels.items()}
        toks = torch.cat([prompt, torch.tensor([out[:-1]], device="cuda")],
                         dim=1)
        full, _ = forward(params, toks, cfg, prefix=prefix)
    print(f"[{tag}] prefill ({F} + {T} positions) {t_prefill * 1e3:.1f} ms, "
          f"{n_new} decode steps {t_decode * 1e3:.1f} ms "
          f"({n_new / t_decode:.1f} tok/s decoding), kernel launches "
          f"{launches}")
    check(full.shape == (1, F + T + n_new, cfg.padded_vocab())
          and bool(torch.isfinite(full).all())
          and bool(torch.isfinite(step_logits).all()),
          f"{tag}: logits {tuple(full.shape)} not finite")
    check(all(0 <= t < cfg.vocab for t in out), "a token outside the "
                                                "vocabulary")
    check(launches == {"flash_attention": cfg.n_layers, "rglru_scan": 0,
                       "wkv6": 0},
          f"{tag}: kernel launches {launches}, want K1 {cfg.n_layers} (the "
          "prefill's) and no other")
    # the prefill's logits are the forward's at the prompt's last position
    # (the same layers over the same positions; bf16 GEMMs of other
    # shapes round apart)
    want = full[0, F + T - 1].float()
    err = (step_logits[0].float() - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"[{tag}] prefill logits against forward's at position "
          f"{F + T - 1}: max|err| {err:.3e} (2e-2 of the scale {scale:.3f})")
    check(err <= 2e-2 * scale, f"{tag}: the prefill's logits are not the "
                               "forward's")
    lg = full[0, F + T - 1:, :cfg.vocab].float()
    chosen = torch.tensor(out, device="cuda")
    gap = lg.max(-1).values - lg.gather(-1, chosen[:, None])[:, 0]
    same = int((lg.argmax(-1) == chosen).sum())
    print(f"[{tag}] teacher-forced, forward's argmax equals the decoded "
          f"token at {same}/{len(out)} steps; largest gap "
          f"{gap.max().item():.4f} (logits up to "
          f"{lg.abs().max().item():.2f})")
    return launches


def train_with_prefix(torch, kernels: dict, tag: str) -> dict:
    """The port's Trainer on internvl2-1b at full width with its
    SyntheticLM prefix: global batch 8, 384 positions (256 prefix + 128
    tokens), 4 steps.  Returns the launch counts of the run."""
    from repro_torch.train.steps import StepConfig
    from repro_torch.train.trainer import TrainerConfig

    tcfg = TrainerConfig(steps=4, global_batch=8, seq_len=384, log_every=1,
                         step=StepConfig(accum=1, warmup=2))
    trainer, _, launches = run_trainer(torch, kernels, tag, "internvl2-1b",
                                       tcfg)
    trainer.close()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru as k2
    from repro_torch.kernels import wkv6 as k3

    # float32 products in full float32 (no TF32) for every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")

    build(torch, [fa, k2, k3], fa, k3)
    fa_err = check_attention(torch, fa, ref)
    k2_err = check_scan(torch, k2, ref)
    k3_err = check_wkv(torch, k3, ref)

    t_fa = time_attention(torch, fa, ref, 1, 32, 32, 8, 64)
    time_attention(torch, fa, ref, 1, 2048, 32, 8, 64)
    time_attention(torch, fa, ref, 1, 23, 10, 1, 256, window=2048)
    time_attention(torch, fa, ref, 1, 2048, 10, 1, 256, window=2048)
    time_attention(torch, fa, ref, 8, 128, 32, 8, 64)       # train step
    time_attention(torch, fa, ref, 1, 32, 16, 8, 256, window=4096,
                   softcap=50.0)                          # gemma2-9b
    time_attention(torch, fa, ref, 1, 32, 56, 8, 128)      # deepseek-33b
    time_attention(torch, fa, ref, 1, 288, 14, 2, 64)      # internvl2-1b
    time_attention(torch, fa, ref, 8, 384, 14, 2, 64)      # its train step
    time_attention(torch, fa, ref, 1, 32, 40, 8, 128)      # llama4-maverick
    time_attention(torch, fa, ref, 1, 32, 48, 8, 128,
                   window=4096)                            # mixtral-8x22b
    t_k2 = time_scan(torch, k2, ref, 1, 23, 2560)
    time_scan(torch, k2, ref, 1, 2048, 2560)
    t_k3 = time_wkv(torch, k3, ref, 1, 64, 23, zero_s0=True)
    time_wkv(torch, k3, ref, 1, 64, 2048, zero_s0=False)

    kernels = {"flash_attention": fa, "rglru_scan": k2, "wkv6": k3}
    llama = serve_full_width(torch, "llama3.2-1b", kernels,
                             {"flash_attention": 16, "rglru_scan": 0,
                              "wkv6": 0}, "serve llama3.2-1b")
    small_model_on_card_and_cpu(
        torch, "llama3.2-1b", "serve llama3.2-1b", d_model=256, n_heads=4,
        kv_heads=2, head_dim=64, d_ff=512)
    small_bf16_model_on_card_and_cpu(
        torch, fa, "llama3.2-1b", "serve llama3.2-1b", d_model=256,
        n_heads=4, kv_heads=2, head_dim=64, d_ff=512)
    rgemma = serve_full_width(torch, "recurrentgemma-2b", kernels,
                              {"flash_attention": 8, "rglru_scan": 18,
                               "wkv6": 0}, "serve recurrentgemma-2b")
    # untied: with tied, scaled embeddings a random model repeats its
    # last token, and greedy tokens would compare nothing
    small_model_on_card_and_cpu(
        torch, "recurrentgemma-2b", "serve recurrentgemma-2b", d_model=256,
        n_heads=4, kv_heads=1, head_dim=64, d_ff=512, rnn_width=256,
        tie_embeddings=False)
    small_bf16_model_on_card_and_cpu(
        torch, fa, "recurrentgemma-2b", "serve recurrentgemma-2b",
        d_model=256, n_heads=4, kv_heads=1, head_dim=64, d_ff=512,
        rnn_width=256, tie_embeddings=False)
    rwkv = serve_full_width(torch, "rwkv6-7b", kernels,
                            {"flash_attention": 0, "rglru_scan": 0,
                             "wkv6": 32}, "serve rwkv6-7b")
    small_model_on_card_and_cpu(torch, "rwkv6-7b", "serve rwkv6-7b")

    check_gradients(torch, ops, ref, fa, k2, k3)
    train_step_on_card_and_cpu(torch, fa, "float32")
    train_step_on_card_and_cpu(torch, fa, "bfloat16")
    train = train_full_width(torch, kernels, "train llama3.2-1b")
    free_card(torch)

    gemma = serve_full_width(torch, "gemma2-9b", kernels,
                             {"flash_attention": 42, "rglru_scan": 0,
                              "wkv6": 0}, "serve gemma2-9b")
    # head_dim 256 so that K1 runs; untied, as recurrentgemma-2b above
    small_model_on_card_and_cpu(
        torch, "gemma2-9b", "serve gemma2-9b", nonzero=True, head_dim=256,
        tie_embeddings=False)
    small_bf16_model_on_card_and_cpu(
        torch, fa, "gemma2-9b", "serve gemma2-9b", nonzero=True,
        head_dim=256, tie_embeddings=False)
    free_card(torch)
    # 62.1 GiB of weights: alone on the card
    deepseek = serve_full_width(torch, "deepseek-coder-33b", kernels,
                                {"flash_attention": 62, "rglru_scan": 0,
                                 "wkv6": 0}, "serve deepseek-coder-33b")
    free_card(torch)
    qwen = serve_full_width(torch, "qwen1.5-110b", kernels,
                            {"flash_attention": 8, "rglru_scan": 0,
                             "wkv6": 0}, "serve qwen1.5-110b", n_layers=8)
    small_model_on_card_and_cpu(torch, "qwen1.5-110b", "serve qwen1.5-110b",
                                nonzero=True, head_dim=128)
    free_card(torch)
    musicgen = serve_full_width(torch, "musicgen-medium", kernels,
                                {"flash_attention": 48, "rglru_scan": 0,
                                 "wkv6": 0}, "serve musicgen-medium")
    free_card(torch)
    internvl = serve_with_prefix(torch, kernels, "internvl2-1b prefix")
    small_model_on_card_and_cpu(torch, "internvl2-1b", "internvl2-1b prefix",
                                nonzero=True, head_dim=64)
    free_card(torch)
    train_internvl = train_with_prefix(torch, kernels, "train internvl2-1b")
    free_card(torch)

    # 65.3 GiB of weights: alone on the card
    llama4 = serve_full_width(torch, "llama4-maverick-400b-a17b", kernels,
                              {"flash_attention": 4, "rglru_scan": 0,
                               "wkv6": 0}, "serve llama4-maverick",
                              n_layers=4)
    free_card(torch)
    # all 128 experts at a narrow width; G=5 and head_dim 128 so that K1
    # runs as in the full model
    small_llama4 = dict(n_experts=128, n_heads=10, kv_heads=2, head_dim=128)
    small_model_on_card_and_cpu(torch, "llama4-maverick-400b-a17b",
                                "serve llama4-maverick", nonzero=True,
                                **small_llama4)
    small_bf16_model_on_card_and_cpu(torch, fa, "llama4-maverick-400b-a17b",
                                     "serve llama4-maverick", nonzero=True,
                                     **small_llama4)
    mixtral = serve_full_width(torch, "mixtral-8x22b", kernels,
                               {"flash_attention": 8, "rglru_scan": 0,
                                "wkv6": 0}, "serve mixtral-8x22b",
                               n_layers=8)
    free_card(torch)
    # G=6 and head_dim 128, the smoke config's window of 16
    small_mixtral = dict(n_heads=12, kv_heads=2, head_dim=128)
    small_model_on_card_and_cpu(torch, "mixtral-8x22b", "serve mixtral-8x22b",
                                nonzero=True, **small_mixtral)
    small_bf16_model_on_card_and_cpu(torch, fa, "mixtral-8x22b",
                                     "serve mixtral-8x22b", nonzero=True,
                                     **small_mixtral)
    train_step_on_card_and_cpu(torch, fa, "float32",
                               "llama4-maverick-400b-a17b")

    paths = {"llama3.2-1b": llama, "recurrentgemma-2b": rgemma,
             "rwkv6-7b": rwkv, "train llama3.2-1b": train,
             "gemma2-9b": gemma, "deepseek-coder-33b": deepseek,
             "qwen1.5-110b (8 of 80 layers)": qwen,
             "musicgen-medium": musicgen,
             "internvl2-1b prefix prefill + decode": internvl,
             "train internvl2-1b": train_internvl,
             "llama4-maverick-400b-a17b (4 of 48 layers)": llama4,
             "mixtral-8x22b (8 of 56 layers)": mixtral}

    def row(name, src, replaces, err, t):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces,
                "launches": sum(p[name] for p in paths.values()),
                "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t.get("device_ms"), "shape": t["shape"],
                "launches_by_path": {arch: p[name]
                                     for arch, p in paths.items()}}

    record = {"kernels": [
        row("flash_attention", "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:96", fa_err, t_fa),
        row("rglru_scan", "rglru.cu", "src/repro/kernels/rglru.py:53",
            k2_err, t_k2),
        row("wkv6", "wkv6.cu", "src/repro/kernels/rwkv6.py:77", k3_err,
            t_k3),
    ]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
