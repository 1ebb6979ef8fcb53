#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero
and no result line is printed):

1. build — print the card's name and power limit, compile the four
   kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` (one ``nvcc`` per source, started together), print the
   build seconds and what ``ptxas -v`` says of registers and spills,
   K1's dynamic shared memory a block, the ``HGMMA`` (tensor-core
   ``wgmma``) instructions ``cuobjdump -sass`` finds in each K1 kernel
   and the ``HMMA`` (``mma.sync``) ones in each K3 kernel and in each
   of K4's bf16 kernels, and K3's thread block cluster as the runtime
   reports it (width, clusters that fit at once, shared memory a block);
   K1's bf16 kernels, both K3 kernels and K4's three bf16 kernels must
   hold their tensor-core instructions, and K3 must run in clusters;
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
   K4 (the split-KV decode attention) against
   ``ref.decode_attention_ref`` at each serving architecture's decode
   shape (4 slots, the cache its local window or 2048 slots; gemma2-9b
   with its softcap 50 and 4096 ring, recurrentgemma-2b's KV=1, G=10 and
   2048 ring, llama3.2-1b's D=64) and at ``mixtral-8x22b.chat``'s (64
   slots of 2816, H=48, KV=8, D=128), every slot mix a quarter short, a
   quarter long, a quarter wrapped past the ring and a quarter dead
   (far past it), and with float32 q against a bf16 and a float32
   cache, within ``tests/test_kernels.py``'s tolerance (bf16 2e-2, f32
   2e-5), one entry-point call each;
3. times — each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (a yardstick only: the port
   never calls it; ``scaled_dot_product_attention`` takes no softcap, so
   gemma2-9b's shape has none), beside the kernel's bound, at the serving
   shapes (K1 also at S=2048, at the full-width train step's B=8, S=128,
   at phase 21's B=4, S=2048,
   at gemma2-9b's, deepseek-coder-33b's, llama4-maverick's and
   mixtral-8x22b's serving shapes and at internvl2-1b's prefix prefill
   and train step; K2 and K3 at S=2048; K4 at ``mixtral-8x22b.chat``'s,
   gemma2-9b's, llama3.2-1b's and recurrentgemma-2b's decode, its bound
   the bytes of the valid K/V slots);
   for K1 also its achieved
   TFLOP/s and its share of the bound; for K2, K3 and K4 also the device
   time a call from a replayed CUDA graph, since back-to-back calls at
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
   (its forward, with the backward of ``kernels/grad.py``: the
   reference's chunked attention, associative scan and chunked WKV)
   against the plain version's autograd gradient on the card, for a
   random linear functional of the outputs: K1 at S=40, D=64, 128 and
   256, with a window and a softcap, in float32 (1e-5) and bfloat16
   (2e-2 of the gradient's scale), and at S=2048 (four query chunks),
   D=64 in float32; K2 (1e-5) and K3 (1e-4; w's gradient as ∂/∂w
   where w ≥ 0.05 and as w ⊙ ∂/∂w below, where the chunked form's
   log w divides its rounding by w) at S = 1, 17, 65 and 2048 with and
   without h0 / s0; each kernel must have launched in its forward;
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
   the backward differentiates the reference's query-chunked attention,
   ``kernels/grad.py``, and launches none).  Prints ms a step
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
    CPU in float32, at phase 8's tolerances; K1 2 × its layers;
18. the elastic drill at full width: phase 9's llama3.2-1b ``Trainer``
    steered by an ``ElasticController`` of 4 replicas with a
    ``CheckpointManager`` (keep 1) under ``build/``, one step at a time,
    a checkpoint every 4 steps; a ``CORE_FAIL`` of replica 2 at step 6
    rolls the run back to step 4 (the restored tree loaded into the
    trainer), and it goes on to step 8.  Holds: restores [(6, 4)], 3
    replicas without replica 2 whose shards sum to 8, the parameters on
    the card after the restore equal to the step-4 checkpoint bit for
    bit, every loss and grad norm finite, ``resize_to_prediction``
    between 1 and 3 replicas, K1 exactly 32 × the 10 steps run.  Prints
    ms a step, the seconds of each save (the state to the host, then
    written) and of the restore, and peak memory; fails with the numbers
    if the disk lacks room for two checkpoints;
19. phase 4's full-width llama3.2-1b engine (max batch 4, 16 new tokens,
    the ``prediction`` autoscaler) under a ``TraceRecorder``: 8 requests
    in two bursts of 4, at ticks 0 and 8; the trace written as JSONL and
    Chrome JSON; the JSONL must round-trip byte for byte, rebuild as 8
    tasks with 4 release times of 0 and 4 later ones, and replay in the
    simulator under busy, idle, hybrid and prediction twice each with
    identical reports (makespan, energy, EDP and resumes printed); K1 16
    × the 8 prefills;
20. the host runtime on the card's machine: the quickstart table (the
    simulator on Gauss-Seidel on MN4 under the four policies, and the
    three DLB policies on Gauss-Seidel + STREAM through
    ``run_multi_app``) equal to the reference's numbers (``QUICKSTART``,
    ``SHARING``) within 1e-9, and a closed ``ThreadExecutor`` run of six
    dependent waves of eight tasks: all done, each after its
    dependencies.

21. remat on the card: one train step of full-width llama3.2-1b (bf16
    parameters, float32 AdamW state and gradients, ``ce_seq_chunk`` 512)
    on a fixed batch of 4 × 2048 tokens, accum 1, from the same seeded
    weights and batch under ``remat`` "none", "full" and "dots"
    (``repro_torch.launch.cells.build_cell`` on the card): equal first
    losses, grad norms within 1e-5 relative, K1 16, 32 and 32 launches,
    and peak memory ordered full < dots < none, the step's and that of
    its gradient pass alone (``grads_of``, where remat acts) alike.
    Prints each mode's
    ``max_memory_allocated`` (less what else the card held), the FLOPs
    ``FlopCounterMode`` counts in a second step, and the ms of a step as
    the median of 3 after it;
22. the dry-run held against the card: ``repro_torch.launch.dryrun``
    over all 40 (arch × shape) cells on the meta device, in worker
    processes (33 ok, 7 skipped with the reference's reason, a row
    each); then phase 21's cell on meta under each mode, whose peak must
    lie within ±15 % of phase 21's measured peak and whose FLOPs must
    equal ``FlopCounterMode``'s count of the real step exactly; the
    kernel operators' backwards (``kernels/grad.py``) at shapes that span
    several chunks (phase 21's attention, a window, a softcap, the scan,
    the WKV in float32 and with bf16 r, k, v; and four shapes the
    model's card terms were not fit to), each working set on the card
    within ±15 % of the model the dry-run's meta stand-in holds,
    and at S=2048 each one's ms and working set beside the plain
    version's gradient, which the operators took before; and the same
    FLOP equality for a
    small recurrentgemma-2b prefill (K1, K2) and a small rwkv6-7b
    prefill (K3) run on the card;
23. the analyzer: ``repro_torch.analysis``'s static passes over the
    checkout's ``src/repro_torch`` return 0, and phase 20's
    ``ThreadExecutor`` run repeats under the port's strict lock-order
    witness with no violation and no contradiction of the declared
    order (traced, so that the executor's, the scheduler's, the
    monitor's, the recorder's and the bus's locks nest);
24. the recurrent architectures train on the card: one train step of
    recurrentgemma-2b at full width and depth (26 layers) and of
    rwkv6-7b at full width and 8 of its 32 layers (the cut is printed:
    the full depth's weights, gradients and AdamW state do not fit one
    card), each through ``build_cell`` as phase 21 (bf16 parameters,
    float32 AdamW state and gradients, remat "full", ``ce_seq_chunk``
    512) on a fixed seeded batch of 2 × 2048 tokens, one warm-up step
    and then 3 timed: every loss and grad norm finite, exactly K2 34 and
    K1 16 launches a step for recurrentgemma-2b (each forward and its
    remat recompute, but the two trailing recurrent layers, which are not
    checkpointed) and K3 16 for rwkv6-7b, and no other, and the peak
    memory within ±15 % of the dry-run's peak for the same cell on
    meta.  Prints ms a step (the median of 3), tokens/s, model TFLOP/s
    (6·N·B·S) and peak memory;
25. deepseek-v3 on the card: one latent-attention layer at full width
    (128 heads, q_lora 1536, kv_lora 512, nope 128 + rope 64, v 128,
    bf16, the published init) over a seeded input of 1,024 and of 2,048
    tokens, its prefill attention (K1 over q and k padded from 192 to
    256 and v from 128, q pre-scaled) held against the plain causal
    attention of the same unpadded q, k, v in float32: every (position,
    head) row's relative error under ``MLA_ROW_REL_LIMIT``, one K1
    launch, and the same plain attention with a scale that lacks YaRN's
    m² over the limit; K1 timed at that padded shape (B=1, H=KV=128,
    D=256); then the model at full width and 31 of its 61 layers (8 of
    256 experts held, as ``deepseek-v3-ep32``) served as phase 4, K1 31
    × prefills and K4 none, and one prefill of 1,024 and one of 2,048
    tokens counted from 0: exactly 31 K1 launches each and no other.

The launch counts of each serving path and of each full-width train run
are set to 0 just before it and read just after; a kernel that the path
does not run must show 0.  K4 runs in every decode step, once a layer
with attention: its count is those layers × the decode steps (the
engine's ticks), and 0 on every train path and prefill.  No kernel of
the MoE layer: the reference computes the experts with ``jnp.einsum``
outside any kernel, and the port with ``torch.bmm``.  The last two
lines are the kernels' JSON record and the result line ``{"ok": true,
"device": {...}}``.  Needs one CUDA device; fails without.
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
from functools import partial
from pathlib import Path

TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: K4's limit on each slot's relative error, ||o_b − want_b|| / ||want_b||
#: (tests/test_torch_kernels.py DECODE_REL_LIMIT): a sound kernel reads
#: about 2.5e-3, one that drops a tile of a long slot about 0.17
DECODE_REL_LIMIT = 1e-2
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


def build(torch, kernels, fa, k3, fd) -> None:
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
    # K4's bf16 kernels take both products with mma.sync (SASS HMMA)
    hmma = {name: n for name, n in _build.sass_counts(fd._SOURCE,
                                                      "HMMA").items()
            if "flash_decode_split" in name}
    for name, n in hmma.items():
        print(f"[sass] {name}: {n} HMMA")
    tc = [n for name, n in hmma.items() if "flash_decode_split_tc" in name]
    check(len(tc) == 3 and all(n > 0 for n in tc),
          f"K4's bf16 kernels hold no HMMA instruction: {hmma}")


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

    from repro_torch.kernels.ops import attention_flops
    from repro_torch.launch.roofline import attention_bound
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
    flops = attention_flops(B, S, H, D, window)
    lib = "" if row["library_ms"] is None \
        else f" (sdpa {flops / row['library_ms'] / 1e9:.2f})"
    print(f"[time] K1 {row['shape']}: {flops / row['ms'] / 1e9:.2f} TFLOP/s "
          f"achieved{lib}, {row['bound_ms'] / row['ms']:.4f} of the bound")
    return row


def time_scan(torch, k2, ref, B, S, R) -> dict:
    from repro_torch.launch.roofline import scan_bound

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
    from repro_torch.launch.roofline import wkv_bound

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


#: the serving architectures whose decode steps K4 runs; phase 2 checks
#: each at 4 slots of its local window's ring, or of 2048 slots
DECODE_ARCHS = ("llama3.2-1b", "recurrentgemma-2b", "gemma2-9b",
                "deepseek-coder-33b", "qwen1.5-110b", "musicgen-medium",
                "internvl2-1b", "llama4-maverick-400b-a17b", "mixtral-8x22b")
#: mixtral-8x22b.chat's decode: 64 slots of a 2816-slot cache
CHAT_DECODE = (64, 2816)


def decode_positions(B: int, Sc: int, seed: int) -> list[int]:
    """B slots' positions over Sc cache slots, in turn short (under
    Sc/8), long (up to Sc − 1), wrapped past the ring (Sc to 2·Sc) and
    dead (10 to 20 × Sc: a freed slot's position keeps growing)."""
    import random

    rng = random.Random(seed)
    spans = [(0, max(1, Sc // 8)), (Sc // 2, Sc), (Sc, 2 * Sc),
             (10 * Sc, 20 * Sc)]
    return [rng.randrange(*spans[i % 4]) for i in range(B)]


def decode_inputs(torch, B, Sc, H, KV, D, q_dtype, kv_dtype, *, seed,
                  scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)
    return (randn(B, 1, H, D, dtype=q_dtype, s=scale),
            randn(B, Sc, KV, D, dtype=kv_dtype, s=scale),
            randn(B, Sc, KV, D, dtype=kv_dtype),
            torch.tensor(decode_positions(B, Sc, seed), device="cuda"))


def slot_rel_err(o, want):
    """(B,) relative errors of each slot's (1, H, D) output."""
    d = (o.double() - want.double()).flatten(1).norm(dim=1)
    return d / want.double().flatten(1).norm(dim=1)


def check_decode(torch, fd, ref) -> float:
    """K4 against its plain version at each serving architecture's decode
    shape and at the chat cell's; returns the largest error at the chat
    cell's shape.  The float32-q kernel rounds the probabilities as the
    plain version does, the bf16 one keeps them float32.  Each slot's
    relative error is held to ``DECODE_REL_LIMIT`` too, and at the chat
    cell's shape a planted fault must fail it: the kernel run at
    pos − T (the last tile of each slot's valid positions left out)."""
    from repro_torch.configs import get_config

    bf16, f32 = torch.bfloat16, torch.float32
    mix = get_config("mixtral-8x22b")
    cases = [("mixtral-8x22b.chat", *CHAT_DECODE, mix.n_heads,
              mix.kv_heads, mix.head_dim, bf16, bf16, None)]
    for arch in DECODE_ARCHS:
        cfg = get_config(arch)
        cases.append((arch, 4, cfg.window or 2048, cfg.n_heads,
                      cfg.kv_heads, cfg.head_dim, bf16, bf16,
                      cfg.attn_softcap))
    # the float32 models: float32 q, their bf16 cache or a float32 one
    cases += [("f32 q G=6 D=128", 4, 300, 12, 2, 128, f32, bf16, None),
              ("f32 q G=2 D=256 softcap", 4, 300, 4, 2, 256, f32, bf16,
               50.0),
              ("f32 q f32 cache G=4 D=64", 4, 300, 8, 2, 64, f32, f32, None)]
    failed, main_err = [], None
    for i, (name, B, Sc, H, KV, D, q_dt, kv_dt, softcap) in enumerate(cases):
        q, k, v, pos = decode_inputs(torch, B, Sc, H, KV, D, q_dt, kv_dt,
                                     seed=600 + i,
                                     scale=3.0 if softcap else 1.0)
        before = fd.launches
        o = fd.flash_decode(q, k, v, pos, softcap=softcap)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, k, v, pos, softcap=softcap)
        tol = TOL["float32" if kv_dt == f32 else "bfloat16"]
        err = (o.float() - want.float()).abs().max().item()
        rel = slot_rel_err(o, want)
        ok = (o.shape == want.shape and o.dtype == want.dtype
              and fd.launches == before + 1
              and bool(torch.isfinite(o).all())
              and torch.allclose(o.float(), want.float(), rtol=tol, atol=tol)
              and rel.max().item() < DECODE_REL_LIMIT)
        print(f"[check] K4 {name}: B={B} Sc={Sc} H={H} KV={KV} D={D} q "
              f"{q_dt} cache {kv_dt}"
              + (f" softcap {softcap:g}" if softcap else "")
              + f", pos {pos.tolist()[:8]}{'…' if B > 8 else ''}: max|err| "
              f"{err:.3e} (rtol=atol={tol:g}), slot rel err max "
              f"{rel.max().item():.3e} (limit {DECODE_REL_LIMIT:g}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(name)
        if main_err is None:
            main_err = err
            # the planted fault: the last tile of each slot left out
            T = 8192 // D
            dropped = (pos >= T) & (pos < Sc)
            faulty = slot_rel_err(
                fd.flash_decode(q, k, v, torch.where(dropped, pos - T, pos),
                                softcap=softcap), want)[dropped]
            caught = bool(dropped.any()) and bool(
                (faulty > DECODE_REL_LIMIT).all())
            print(f"[check] K4 {name}, planted fault (last tile of "
                  f"{int(dropped.sum())} slots left out): slot rel err min "
                  f"{faulty.min().item():.3e} max {faulty.max().item():.3e}"
                  f" {'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                failed.append(f"{name} fault")
        del q, k, v, o, want
    check(not failed, f"K4 disagrees with its plain version: {failed}")
    return main_err


def time_decode(torch, fd, ref, tag, B, Sc, H, KV, D,
                softcap=None) -> dict:
    """K4 at a decode shape (bf16), its slots in decode_positions' mix:
    ms a call back to back, device ms a call from a CUDA graph, the plain
    version, ``scaled_dot_product_attention`` with the valid slots as its
    mask (a yardstick only: the port never calls it; it takes no
    softcap), and the bound from the bytes of the valid slots."""
    from torch.nn import functional as F

    from repro_torch.launch.roofline import decode_bound

    q, k, v, pos = decode_inputs(torch, B, Sc, H, KV, D, torch.bfloat16,
                                 torch.bfloat16, seed=Sc + H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    valid = (torch.arange(Sc, device="cuda")[None, :]
             <= pos[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid,
                                              enable_gqa=True)

    def kernel():
        return fd.flash_decode(q, k, v, pos, softcap=softcap)

    def plain():
        return ref.decode_attention_ref(q, k, v, pos, softcap=softcap)

    iters = 50 if B * Sc > 100_000 else 200
    row = {"ms": time_ms(torch, kernel, iters),
           "device_ms": device_ms(torch, kernel, 50),
           "plain_ms": time_ms(torch, plain, 10),
           "library_ms": None if softcap is not None
           else time_ms(torch, library, iters)}
    row["bound_ms"], row["bound_by"] = decode_bound(Sc, H, KV, D,
                                                    pos.tolist())
    row["shape"] = (f"{tag}: B={B} Sc={Sc} H={H} KV={KV} D={D} bf16"
                    + (f" softcap {softcap:g}" if softcap else ""))
    lib = "none (sdpa takes no softcap)" if row["library_ms"] is None \
        else f"{row['library_ms']:.5f} ms"
    print(f"[time] K4 {row['shape']}: kernel {row['ms']:.5f} ms a call "
          f"({row['device_ms']:.5f} ms of device time, CUDA graph), plain "
          f"{row['plain_ms']:.5f} ms, sdpa {lib}, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}: the valid slots' "
          f"bytes), {row['bound_ms'] / row['device_ms']:.4f} of the bound")
    return row


def attention_layers(params) -> int:
    """Layers of ``params`` with attention (and so a K4 call a decode
    step)."""
    from repro_torch.models.layers import AttnLayer, MoELayer
    return sum(isinstance(layer, (AttnLayer, MoELayer))
               for layer in params.layers)


# -- 4.-6. serving ----------------------------------------------------------------


def free_card(torch) -> None:
    """Return the memory of the models and engines that went out of scope
    (their event buses hold reference cycles) to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_full_width(torch, arch: str, kernels: dict, expect: dict,
                     tag: str, n_layers: int | None = None,
                     after=None) -> dict:
    """Serve ``arch`` at full width through the launcher's code path —
    at its full depth, or cut to ``n_layers`` where the weights do not
    fit one card; returns the launch counts of the run, read just after
    it.  ``after(params, cfg)``, if given, runs last, on the served
    weights."""
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
    n_attn = attention_layers(engine.params)
    check(launches["flash_decode"] == n_attn * engine.ticks,
          f"{arch}: {launches['flash_decode']} flash_decode launches for "
          f"{engine.ticks} decode ticks, want {n_attn} each")
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
    if after is not None:
        after(engine.params, cfg)
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


#: K3's decays below which phase 7 holds w's gradient as w ⊙ ∂/∂w
W_SPLIT = 0.05


def _split_w_grad(torch, grads: list, w) -> list:
    """K3's gradients with w's split in two: ∂/∂w where w ≥ ``W_SPLIT``
    and w ⊙ ∂/∂w (the gradient with respect to log w) below, each zero
    elsewhere.  The chunked form takes log w, so ∂/∂w divides its
    rounding by w, by up to 1e15 at these inputs; at w ≥ 0.05 by at
    most 20."""
    big = w >= W_SPLIT
    dw = grads[3]
    return grads[:3] + [torch.where(big, dw, 0.0),
                        torch.where(big, 0.0, dw * w)] + grads[4:]


def check_gradients(torch, ops, ref, fa, k2, k3) -> None:
    """Each kernel's gradient (kernel forward, the backward of
    ``kernels/grad.py``) against the plain version's autograd gradient
    on the card, inputs and outputs alike; K3's w split as
    :func:`_split_w_grad` does."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []      # name, module, dispatch, plain, inputs, tolerance
    shapes = [(2, 40, D, H, KV, dt) for D, H, KV in
              ((64, 8, 2), (128, 8, 2), (256, 10, 1)) for dt in (f32, bf16)]
    for B, S, D, H, KV, dt in shapes + [(1, 2048, 64, 8, 2, f32)]:
        for window, softcap in ((None, None), (24, None), (None, 20.0)):
            q, k, v = attention_inputs(torch, B, S, H, KV, D, dt,
                                       seed=D + (window or 0),
                                       scale=3.0 if softcap else 1.0)
            cases.append((
                f"S={S} D={D} window={window} softcap={softcap}", fa,
                lambda *x, w=window, c=softcap: ops.attention(
                    *x, window=w, softcap=c),
                lambda *x, w=window, c=softcap: ref.attention_ref(
                    *x, window=w, softcap=c),
                [q, k, v], TOL["float32"] / 2 if dt == f32 else None))
    for S in (1, 17, 65, 2048):
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
        got = list(_functional_grads(torch, dispatch(*inputs), wrt, i))
        launched = mod.launches - before
        want = list(_functional_grads(torch, plain(*inputs), wrt, i))
        torch.cuda.synchronize()
        if tag == "K3":
            got, want = (_split_w_grad(torch, x, wrt[3]) for x in (got, want))
        errs, ok = [], launched == 1
        for gg, ww in zip(got, want):
            gg, ww = gg.float(), ww.float()
            t = tol if tol is not None \
                else TOL["bfloat16"] * ww.abs().max().item()
            errs.append((gg - ww).abs().max().item())
            ok &= bool(torch.isfinite(gg).all()) and torch.allclose(
                gg, ww, rtol=tol or 0.0, atol=t)
        dt = str(inputs[0].dtype).removeprefix("torch.")
        print(f"[grad] {tag} {name:40s} {dt:8s} launches {launched}, "
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
            "rglru_scan": 0, "wkv6": 0, "flash_decode": 0}
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
                       "wkv6": 0, "flash_decode": cfg.n_layers * n_new},
          f"{tag}: kernel launches {launches}, want K1 {cfg.n_layers} (the "
          f"prefill's), K4 {cfg.n_layers} × {n_new} steps and no other")
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


# -- 18.-20. the paper's runtime around the model ---------------------------------

#: phase 20's quickstart table, as the reference package computes it on the
#: CPU (``tests/test_torch_runtime.py`` holds both packages to these):
#: policy -> (makespan s, energy J, EDP, resumes) of Gauss-Seidel (30
#: steps, seed 0) on MN4, and DLB policy -> (gauss makespan s, stream
#: makespan s, DLB calls) of Gauss-Seidel (20 steps) + STREAM (10 rounds)
#: on 24 + 24 cores through ``run_multi_app``
QUICKSTART = {
    "busy": (3.363578809517858, 161.4517828568572, 543.0557955762034, 0),
    "idle": (5.146356855727164, 47.934429256413914, 246.6876786291145, 203),
    "hybrid": (5.141177715177496, 47.92124344180886, 246.37162886662344,
               203),
    "prediction": (3.37367879453413, 39.47654912883761, 133.18119667734422,
                   1846),
}
SHARING = {
    "dlb-lewi": (2.9331975689012126, 0.1024410298032276, 9145),
    "dlb-hybrid": (2.9290963366340614, 0.10251954532892375, 9068),
    "dlb-prediction": (2.3194266857353627, 0.10242069007229705, 6057),
}
#: relative tolerance of the table's floats: the same Python code on
#: another host's libm
QUICKSTART_RTOL = 1e-9


def elastic_drill(torch, kernels: dict, tag: str) -> dict:
    """Phase 18: the port's Trainer on llama3.2-1b at full width, steered
    by the ElasticController: a checkpoint every 4 steps, replica 2
    fails at step 6 (CORE_FAIL) and the run rolls back to step 4 and
    goes on to step 8.  Returns the launch counts of the drill."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.convert import named_from_tree
    from repro_torch.core.conditions import ConditionTimeline, core_fail
    from repro_torch.train.elastic import ElasticController
    from repro_torch.train.steps import StepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig, load_state

    every, fail_at, last = 4, 6, 8
    cfg = get_config("llama3.2-1b")
    tcfg = TrainerConfig(steps=0, global_batch=8, seq_len=128, log_every=1,
                         step=StepConfig(accum=1, warmup=2))
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tcfg, device="cuda")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in list(trainer.params.parameters())
                      + list(trainer.opt_state["mu"].values())
                      + list(trainer.opt_state["nu"].values()))
    print(f"[{tag}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in trainer.params.parameters()) / 1e9:.3f}"
          f" B parameters ({cfg.param_dtype}), AdamW state "
          f"{tcfg.opt.state_dtype}; training state {state_bytes / 1e9:.3f} "
          f"GB; global batch {tcfg.global_batch}, {tcfg.seq_len} tokens")
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="elastic_ckpt_", dir=root))
    try:
        # keep=1: the next checkpoint is written beside the last one
        # before that one goes
        free, need = shutil.disk_usage(tmp).free, 2 * state_bytes + 2**30
        print(f"[{tag}] {free / 1e9:.1f} GB free under {tmp}")
        check(free >= need, f"{tag}: {free / 1e9:.2f} GB free under {tmp}, "
                            f"two checkpoints need {need / 1e9:.2f} GB")
        ctl = ElasticController(max_replicas=4, global_batch=8,
                                checkpoint=CheckpointManager(tmp, keep=1))
        fired = {p.time: p for p in ConditionTimeline([core_fail(
            float(fail_at), 2)])}
        saved, saves, restore = {}, [], None
        for mod in kernels.values():
            mod.launches = 0
        while trainer.step < last:
            trainer.run(1)
            step, h = trainer.step, trainer.history[-1]
            ctl.on_batches_queued(1, 1024.0)
            ctl.on_step_done(ctl._task_seq, 1024.0, h["dt"],
                             replica=ctl.set.replicas[0])
            # trainer.state() copies the whole state to the host: only
            # at the steps that save
            if step % every == 0:
                t0 = time.perf_counter()
                state = trainer.state()
                t1 = time.perf_counter()
                check(ctl.maybe_checkpoint(step, state, every=every),
                      f"{tag}: no checkpoint at step {step}")
                saves.append((step, t1 - t0, time.perf_counter() - t1))
                saved[step] = state["params"]
                del state
            p = fired.pop(float(step), None)
            if p is not None:
                t0 = time.perf_counter()
                like = trainer.state()
                t1 = time.perf_counter()
                _, state, resume = ctl.apply_perturbation(p, step, like)
                t2 = time.perf_counter()
                del like
                load_state(trainer, state, resume)
                torch.cuda.synchronize()
                restore = (step, resume, t1 - t0, t2 - t1,
                           time.perf_counter() - t2)
                del state
                want = named_from_tree(saved[resume], cfg)
                same = [torch.equal(q, want[k].to(q.device))
                        for k, q in trainer.params.named_parameters()]
                check(all(same), f"{tag}: {same.count(False)} of "
                                 f"{len(same)} parameters differ from the "
                                 f"step-{resume} checkpoint after the "
                                 "restore")
        launches = {name: mod.launches for name, mod in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        trainer.close()
    hist = trainer.history
    dts = [h["dt"] for h in hist]
    print(f"[{tag}] steps run {[h['step'] for h in hist]}, losses "
          f"{[round(h['loss'], 5) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}")
    print(f"[{tag}] ms a step (synchronised) "
          f"{[round(d * 1e3, 3) for d in dts]}; steps 3 on: "
          f"{sum(dts[2:]) / len(dts[2:]) * 1e3:.3f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}")
    for step, t_host, t_write in saves:
        print(f"[{tag}] save at step {step}: {state_bytes / 1e9:.3f} GB, "
              f"state to the host {t_host:.3f} s, written "
              f"{t_write:.3f} s ({state_bytes / t_write / 1e9:.3f} GB/s)")
    check(restore is not None, f"{tag}: the failure did not fire")
    step, resume, t_like, t_read, t_load = restore
    survivors, shards = list(ctl.set.replicas), ctl.set.shards()
    target = ctl.resize_to_prediction(trainer.step)
    print(f"[{tag}] CORE_FAIL of replica 2 at step {step}: rolled back to "
          f"step {resume}; restore {t_like + t_read + t_load:.3f} s (the "
          f"live state to the host {t_like:.3f} s, the checkpoint read "
          f"{t_read:.3f} s, onto the card {t_load:.3f} s); replicas "
          f"{survivors}, shards {shards}, restores {ctl.restores}; "
          f"resize_to_prediction at step {trainer.step}: {target.replicas}")
    check(ctl.restores == [(fail_at, every)],
          f"{tag}: restores {ctl.restores}")
    check(len(survivors) == 3 and 2 not in survivors
          and sum(shards.values()) == 8,
          f"{tag}: replicas {survivors}, shards {shards}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"{tag}: a loss or grad norm is not finite")
    check(1 <= len(target.replicas) <= 3 and 2 not in target.replicas,
          f"{tag}: resize_to_prediction gave {target.replicas}")
    # steps 1-6, then 5-8 again after the rollback to step 4
    executed = fail_at + last - every
    check(len(hist) == executed, f"{tag}: {len(hist)} steps run")
    want = {"flash_attention": 2 * cfg.n_layers * executed,
            "rglru_scan": 0, "wkv6": 0, "flash_decode": 0}
    check(launches == want, f"{tag}: kernel launches {launches}, want "
                            f"{want} (32 a step: forward and remat "
                            "recompute)")
    return launches


def traced_serving(torch, kernels: dict, tag: str) -> dict:
    """Phase 19: phase 4's full-width llama3.2-1b engine under a
    TraceRecorder, 8 requests in two bursts (ticks 0 and 8); the trace
    replayed in the simulator under four policies.  Returns the launch
    counts of the serving run."""
    import random
    import shutil
    import tempfile
    from dataclasses import asdict

    from repro_torch.configs import get_config
    from repro_torch.core import GovernorSpec
    from repro_torch.models import init_params
    from repro_torch.serving import AutoScaler, Request, ServingEngine
    from repro_torch.trace import TraceRecorder, TraceReplayer

    cfg = get_config("llama3.2-1b")
    params = init_params(cfg, device="cuda", seed=0)
    engine = ServingEngine(cfg, params, max_batch=4, max_len=128,
                           device="cuda")
    scaler = AutoScaler(engine.monitor, max_replicas=4, policy="prediction",
                        bus=engine.bus)
    rec = TraceRecorder(bus=engine.bus)
    rng = random.Random(0)
    bursts = {0: 4, 8: 4}
    reqs, tick = [], 0
    for mod in kernels.values():
        mod.launches = 0
    while tick <= max(bursts) or engine.load:
        for _ in range(bursts.get(tick, 0)):
            prompt = [rng.randrange(cfg.vocab)
                      for _ in range(rng.randint(4, 23))]
            reqs.append(engine.submit(Request(prompt=prompt,
                                              max_new_tokens=16)))
        scaler.target(len(engine.queue),
                      sum(r is not None for r in engine.active))
        engine.tick()
        tick += 1
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernels.items()}
    print(f"[{tag}] {len(reqs)} requests in bursts {bursts} (tick: "
          f"requests), {engine.ticks} decode ticks, {engine.prefills} "
          f"prefills, {engine.tokens_out} tokens, {len(rec)} events "
          f"recorded; kernel launches {launches}")
    check(all(r.done and len(r.output) == 16 for r in reqs),
          f"{tag}: a request did not finish with 16 tokens")
    check(engine.prefills == 8, f"{tag}: {engine.prefills} prefills")
    want = {"flash_attention": 16 * engine.prefills, "rglru_scan": 0,
            "wkv6": 0, "flash_decode": 16 * engine.ticks}
    check(launches == want, f"{tag}: kernel launches {launches}, want "
                            f"{want}")
    tmp = Path(tempfile.mkdtemp(prefix="trace_"))
    try:
        jsonl = rec.to_jsonl(tmp / "serving.jsonl")
        chrome = rec.to_chrome(tmp / "serving.chrome.json")
        print(f"[{tag}] trace: {jsonl.stat().st_size} bytes of JSONL, "
              f"{chrome.stat().st_size} bytes of Chrome trace")
        again = TraceRecorder.from_jsonl(jsonl).to_jsonl(tmp / "again.jsonl")
        check(again.read_bytes() == jsonl.read_bytes(),
              f"{tag}: the JSONL does not round-trip byte for byte")
        replayer = TraceReplayer(jsonl)
        graph, timeline = replayer.build()
        releases = sorted(t.release_time for t in graph.tasks)
        print(f"[{tag}] replayed graph: {len(graph.tasks)} tasks, release "
              f"times (s) {[round(x, 6) for x in releases]}")
        check(len(graph.tasks) == 8, f"{tag}: {len(graph.tasks)} tasks")
        check(timeline is not None
              and list(timeline.release_times) == releases,
              f"{tag}: the arrival timeline is {timeline}")
        check(releases[:4] == [0.0] * 4 and all(x > 0 for x in releases[4:]),
              f"{tag}: release times {releases}")
        for policy in ("busy", "idle", "hybrid", "prediction"):
            spec = GovernorSpec(resources=4, policy=policy, monitoring=True)
            a, b = replayer.replay(spec), replayer.replay(spec)
            check(asdict(a) == asdict(b),
                  f"{tag}: two replays under {policy} differ")
            check(a.tasks_completed == 8,
                  f"{tag}: {policy} replay completed {a.tasks_completed}")
            print(f"[{tag}] replay {policy:10s} makespan {a.makespan!r} s, "
                  f"energy {a.energy!r} J, EDP {a.edp!r}, resumes "
                  f"{a.resumes}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def runtime_tables(tag: str) -> tuple[dict, dict]:
    """Phase 20's quickstart table: the simulator on Gauss-Seidel under
    the four policies, and the three DLB policies through
    ``run_multi_app``; returns them in :data:`QUICKSTART`'s and
    :data:`SHARING`'s form."""
    from repro_torch.core import GovernorSpec
    from repro_torch.runtime import MN4, SimExecutor, SimJobSpec, run_multi_app
    from repro_torch.workloads import build_gauss_seidel, build_stream

    table, sharing = {}, {}
    for policy in ("busy", "idle", "hybrid", "prediction"):
        graph = build_gauss_seidel(steps=30, seed=0)
        spec = GovernorSpec(resources=MN4.n_cores, policy=policy,
                            monitoring=True)
        r = SimExecutor(MN4, spec=spec).run(graph)
        check(r.tasks_completed == len(graph.tasks),
              f"{tag}: {policy} completed {r.tasks_completed}")
        table[policy] = (r.makespan, r.energy, r.edp, r.resumes)
    for policy in ("dlb-lewi", "dlb-hybrid", "dlb-prediction"):
        rep = run_multi_app(MN4, [
            SimJobSpec(name="gauss", graph=build_gauss_seidel(steps=20,
                                                              seed=0),
                       policy=policy, cpus=list(range(24))),
            SimJobSpec(name="stream", graph=build_stream(rounds=10, seed=1),
                       policy=policy, cpus=list(range(24, 48)))])
        sharing[policy] = (rep.apps["gauss"].makespan,
                           rep.apps["stream"].makespan, rep.total_dlb_calls)
    return table, sharing


def host_runtime(tag: str) -> None:
    """Phase 20: the quickstart table against the reference's numbers,
    and one closed ThreadExecutor run of a graph with dependencies."""
    t0 = time.perf_counter()
    table, sharing = runtime_tables(tag)
    for policy, (mk, energy, edp, resumes) in table.items():
        print(f"[{tag}] gauss-seidel on MN4, {policy:10s} makespan "
              f"{mk * 1e3:.4f} ms, energy {energy:.4f} J, EDP {edp:.6f}, "
              f"resumes {resumes}")
    for policy, (gauss, stream, calls) in sharing.items():
        print(f"[{tag}] gauss-seidel + stream, {policy:14s} gauss "
              f"{gauss * 1e3:.4f} ms, stream {stream * 1e3:.4f} ms, DLB "
              f"calls {calls}")
    for got, want in ((table, QUICKSTART), (sharing, SHARING)):
        check(got.keys() == want.keys(), f"{tag}: policies {list(got)}")
        for policy, row in got.items():
            check(all(math.isclose(x, y, rel_tol=QUICKSTART_RTOL)
                      if isinstance(y, float) else x == y
                      for x, y in zip(row, want[policy], strict=True)),
                  f"{tag}: {policy} gave {row}, the reference {want[policy]}")

    thread_waves(tag)
    print(f"[{tag}] phase {time.perf_counter() - t0:.2f} s")


def thread_waves(tag: str, traced: bool = False) -> None:
    """A closed ThreadExecutor run of six dependent waves of eight tasks
    on four workers (with ``traced``, into a ``TraceRecorder`` on its
    bus): all done, each after its dependencies."""
    import threading

    from repro_torch.runtime import Task, TaskGraph, ThreadExecutor
    from repro_torch.trace import TraceRecorder

    lock, done = threading.Lock(), {}

    def ran(key) -> None:
        with lock:
            done[key] = len(done)

    # six waves of eight, each task after every task of the wave before
    graph, prev = TaskGraph(), []
    for wave in range(6):
        cur = []
        for i in range(8):
            task = Task("wave", cost=1.0, fn=partial(ran, (wave, i)))
            task.depends_on(*prev)
            cur.append(task)
            graph.add(task)
        prev = cur
    ex = ThreadExecutor(4, policy="prediction")
    rec = TraceRecorder(bus=ex.bus) if traced else None
    rep = ex.run(graph)
    order_kept = all(done[(w, i)] > done[(w - 1, j)]
                     for w in range(1, 6) for i in range(8)
                     for j in range(8))
    print(f"[{tag}] ThreadExecutor, 4 workers, prediction: "
          f"{rep.tasks_completed} of {len(graph.tasks)} tasks, makespan "
          f"{rep.makespan * 1e3:.3f} ms, dependency order kept: "
          f"{order_kept}"
          + (f", {len(rec.events)} events traced" if traced else ""))
    check(rep.tasks_completed == len(graph.tasks) == len(done) == 48,
          f"{tag}: {rep.tasks_completed} tasks completed, {len(done)} ran")
    check(order_kept, f"{tag}: a task ran before its dependencies")


# -- 21.-23. remat, the dry-run and the analyzer -----------------------------------

#: phase 21's cell: full-width llama3.2-1b, 4 rows of 2048 tokens, accum 1
REMAT_ARCH = "llama3.2-1b"
REMAT_MODES = ("none", "full", "dots")
#: phase 22's bound on the dry-run's peak against the card's
PEAK_RTOL = 0.15


def _remat_setup():
    """Phase 21's shape and training knobs."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.cells import TrainKnobs

    return (ShapeSpec("train_4x2048", 2048, 4, "train"),
            TrainKnobs(accum=1, ce_seq_chunk=512))


def _remat_cell(remat: str, device: str):
    from repro_torch.launch.cells import build_cell

    shape, knobs = _remat_setup()
    return build_cell(REMAT_ARCH, shape, {"remat": remat}, knobs=knobs,
                      device=device)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def remat_on_card(torch, kernels: dict, card: str, tag: str
                  ) -> tuple[dict, dict]:
    """Phase 21; returns each mode's numbers and the phase's launch
    counts, read just after it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.train.steps import StepConfig, grads_of

    fa = kernels["flash_attention"]
    for mod in kernels.values():
        mod.launches = 0
    out = {}
    for remat in REMAT_MODES:
        free_card(torch)
        cell = _remat_cell(remat, "cuda")
        check(cell.cfg.param_dtype == "bfloat16"
              and cell.static_notes["accum"] == 1, f"{tag}: {cell.cfg}")
        args = _nbytes(t for ts in cell.argument_tensors().values()
                       for t in ts)
        torch.cuda.synchronize()
        others = torch.cuda.memory_allocated() - args
        torch.cuda.reset_peak_memory_stats()
        before = fa.launches
        m = cell.fn(*cell.args)[2]      # the state stays in cell.args
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        k1 = fa.launches - before
        peak = torch.cuda.max_memory_allocated() - others
        # the gradient pass alone, where remat acts
        torch.cuda.reset_peak_memory_stats()
        grads = grads_of(cell.args[0], cell.cfg, cell.args[3],
                         StepConfig(accum=1, grad_dtype="float32"))[1]
        grad_peak = torch.cuda.max_memory_allocated() - others
        del grads
        with FlopCounterMode(display=False) as counter:
            cell.fn(*cell.args)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(cell.fn(*cell.args)[2]["loss"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        n_layers = cell.cfg.n_layers
        out[remat] = {"loss": loss, "grad_norm": gnorm, "k1": k1,
                      "peak": peak, "grad_peak": grad_peak, "args": args,
                      "others": others,
                      "flops": counter.get_total_flops(),
                      "ms": sorted(ms)[1], "ms_all": ms}
        print(f"[{tag}] remat {remat:4s}: first loss {loss!r}, grad norm "
              f"{gnorm!r}, K1 {k1} launches; peak memory "
              f"{peak / 2**30:.3f} GiB ({peak} B), of the gradient pass "
              f"{grad_peak / 2**30:.3f} GiB ({grad_peak} B; arguments "
              f"{args / 2**30:.3f} GiB, {others} B else on the card); "
              f"FlopCounterMode {out[remat]['flops']:.6e} FLOPs a step; "
              f"ms a step {out[remat]['ms']:.3f} (median of "
              f"{[round(x, 3) for x in ms]}) [{card}]")
        del cell, m, counter
    launches = {name: mod.launches for name, mod in kernels.items()}
    losses = {r: o["loss"] for r, o in out.items()}
    check(len(set(losses.values())) == 1,
          f"{tag}: first losses differ: {losses}")
    norms = [o["grad_norm"] for o in out.values()]
    check(max(norms) - min(norms) <= 1e-5 * max(norms),
          f"{tag}: grad norms differ: {norms}")
    want = {"none": n_layers, "full": 2 * n_layers, "dots": 2 * n_layers}
    check({r: o["k1"] for r, o in out.items()} == want,
          f"{tag}: K1 launches {[o['k1'] for o in out.values()]}, want "
          f"{want}")
    grad_peaks = [o["grad_peak"] for o in out.values()]
    check(out["full"]["grad_peak"] < out["dots"]["grad_peak"]
          < out["none"]["grad_peak"],
          f"{tag}: the gradient passes' peaks {grad_peaks} are not ordered "
          "full < dots < none")
    check(out["full"]["peak"] < out["dots"]["peak"] < out["none"]["peak"],
          f"{tag}: the steps' peaks {[o['peak'] for o in out.values()]} "
          "are not ordered full < dots < none")
    check(launches["rglru_scan"] == launches["wkv6"]
          == launches["flash_decode"] == 0, f"{tag}: launches {launches}")
    free_card(torch)
    return out, launches


#: phase 22's small prefills on the card: (arch, overrides of its smoke
#: config that let K1 run as in the serving phases, batch, length)
SMALL_PREFILLS = (
    ("recurrentgemma-2b", dict(d_model=256, n_heads=4, kv_heads=1,
                               head_dim=64, d_ff=512, rnn_width=256), 2,
     300),
    ("rwkv6-7b", {}, 2, 300),
)


def dryrun_against_card(torch, kernels: dict, remat: dict, card: str,
                        tag: str) -> dict:
    """Phase 22; returns the launch counts of its runs on the card, read
    just after them."""
    import os

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import (SHAPES, ShapeSpec, all_cells,
                                     cell_runnable, get_config)
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import run_cell, run_cells
    from repro_torch.launch.roofline import count_step

    t0 = time.perf_counter()
    jobs = max(1, min(8, os.cpu_count() or 1))
    records, skips, failures = run_cells(all_cells(), save=False, jobs=jobs)
    print(f"[{tag}] {len(records)} cells ok, {len(skips)} skipped, "
          f"{len(failures)} failed on meta in {jobs} processes, "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{sum(r['fits_80GB'] for r in records)} fit one card [{card}]")
    check(not failures, f"{tag}: cells failed: {failures}")
    want_skips = {(a, s, cell_runnable(get_config(a), SHAPES[s])[1])
                  for a, s in all_cells()
                  if not cell_runnable(get_config(a), SHAPES[s])[0]}
    check(len(records) == 33 and len(skips) == 7
          and set(skips) == want_skips,
          f"{tag}: {len(records)} ok and skips {skips}")

    before = {name: mod.launches for name, mod in kernels.items()}
    shape, knobs = _remat_setup()
    for mode in REMAT_MODES:
        rec = run_cell(REMAT_ARCH, shape, cfg_overrides={"remat": mode},
                       knobs=knobs, save=False, verbose=False)
        card_run = remat[mode]
        est = rec["memory"]["peak_bytes"]
        err = est / card_run["peak"] - 1.0
        print(f"[{tag}] {REMAT_ARCH} 4 × 2048 remat {mode:4s}: peak "
              f"{est / 2**30:.3f} GiB on meta, {card_run['peak'] / 2**30:.3f} "
              f"GiB on the card ({err * 100:+.2f} %); arguments "
              f"{rec['memory']['argument_bytes']} B on meta, "
              f"{card_run['args']} B on the card; FLOPs {rec['flops']} on "
              f"meta, {card_run['flops']} counted on the card; roofline "
              f"{rec['terms']['compute_s'] * 1e3:.3f} ms compute, "
              f"{rec['terms']['memory_s'] * 1e3:.3f} ms memory against "
              f"{card_run['ms']:.3f} ms measured [{card}]")
        check(abs(err) <= PEAK_RTOL,
              f"{tag}: {mode}'s peak estimate is {err * 100:+.2f} % off")
        check(rec["flops"] == card_run["flops"],
              f"{tag}: {mode}: {rec['flops']} FLOPs on meta, "
              f"{card_run['flops']} on the card")
        check(rec["memory"]["argument_bytes"] == card_run["args"],
              f"{tag}: {mode}'s arguments differ")
    check({name: mod.launches for name, mod in kernels.items()} == before,
          f"{tag}: a meta run launched a kernel")
    backward_on_card(torch, card, tag)

    for mod in kernels.values():
        mod.launches = 0
    for arch, overrides, B, S in SMALL_PREFILLS:
        shape = ShapeSpec("small_prefill", S, B, "prefill")
        meta = build_cell(arch, shape, overrides, smoke=True)
        est = count_step(meta.fn, meta.args)
        cell = build_cell(arch, shape, overrides, smoke=True, device="cuda")
        start = {name: mod.launches for name, mod in kernels.items()}
        with FlopCounterMode(display=False) as counter:
            logits, _ = cell.fn(*cell.args)
        torch.cuda.synchronize()
        ran = {name: mod.launches - start[name]
               for name, mod in kernels.items()}
        print(f"[{tag}] small {arch} prefill B={B} S={S}: FLOPs "
              f"{est.flops} on meta, {counter.get_total_flops()} counted "
              f"on the card; launches {ran} [{card}]")
        check(est.flops == counter.get_total_flops(),
              f"{tag}: small {arch} prefill's FLOPs differ")
        check(bool(torch.isfinite(logits.float()).all())
              and tuple(logits.shape) == (B, cell.cfg.padded_vocab()),
              f"{tag}: small {arch} prefill's logits")
        kinds = {"rglru_scan": "recurrentgemma" in arch,
                 "wkv6": "rwkv" in arch,
                 "flash_attention": "recurrentgemma" in arch,
                 "flash_decode": False}
        check(all((ran[k] > 0) == v for k, v in kinds.items()),
              f"{tag}: small {arch} prefill launched {ran}")
        del cell, meta
    launches = {name: mod.launches for name, mod in kernels.items()}
    free_card(torch)
    return launches


#: the backwards whose working set phase 22 measures, at shapes that span
#: several chunks: phase 21's attention (bf16, four query chunks), one
#: with a window and one with a softcap, the scan at recurrentgemma-2b's
#: width, and the WKV at rwkv6-7b's 64 heads (float32, and r, k, v in
#: bf16 as the model passes them) — the shapes the card's terms of
#: ``ops.grad_workspace`` were fit to; then shapes they were not fit to:
#: attention at G = 3, D = 128, a window of 300 and a ragged S, and at
#: G = 1 in float32 with a softcap; the scan at an odd S; the WKV at
#: chunk 32 with a ragged S; (op, dims, dtype, options)
BACKWARDS = (
    ("flash_attention", (4, 2048, 32, 8, 64), "bfloat16", (None, None)),
    ("flash_attention", (1, 2048, 10, 1, 256), "bfloat16", (64, None)),
    ("flash_attention", (2, 1536, 16, 8, 128), "float32", (None, 30.0)),
    ("rglru_scan", (1, 2048, 2560), "float32", ()),
    ("wkv6", (1, 64, 2048), "float32", (16,)),
    ("wkv6", (1, 64, 2048), "bfloat16", (16,)),
    ("flash_attention", (2, 1100, 12, 4, 128), "bfloat16", (300, None)),
    ("flash_attention", (1, 2600, 8, 8, 64), "float32", (None, 50.0)),
    ("rglru_scan", (3, 777, 1024), "float32", ()),
    ("wkv6", (2, 32, 700), "bfloat16", (32,)),
)
#: the first of ``BACKWARDS`` that the model was not fit to
HELD_OUT = 6
#: phase 22's bound on the working-set model against the card
WORKSPACE_RTOL = 0.15
#: the backwards phase 22 also times against the plain version's
#: gradient at S=2048: the first of each operator in ``BACKWARDS``
TIMED_BACKWARDS = (0, 3, 4)


def _backward_inputs(torch, name, dims, dtype):
    """Seeded inputs and output gradients of an operator's backward, and
    its plain version."""
    from repro_torch.kernels import ops, ref

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, f=None, to=dt):
        x = torch.randn(shape, generator=g, device="cuda")
        return (x if f is None else f(x)).to(to)
    if name == "flash_attention":
        B, S, H, KV, D = dims
        return ((randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)),
                (randn(B, S, H, D),),
                lambda q, k, v, window, softcap: ref.attention_ref(
                    q, k, v, window=window, softcap=softcap))
    if name == "rglru_scan":
        B, S, R = dims
        return ((randn(B, S, R, f=torch.sigmoid), randn(B, S, R), None),
                (randn(B, S, R), randn(B, R)), ops._rglru_plain)
    B, H, S = dims
    f32 = torch.float32
    return (tuple(randn(B, H, S, 64) for _ in range(3))
            + (randn(B, H, S, 64, f=lambda x: torch.exp(-torch.exp(x - 1)),
                     to=f32), randn(H, 64, to=f32), None),
            (randn(B, H, S, 64, to=f32), randn(B, H, 64, 64, to=f32)),
            lambda r, k, v, w, u, s0, chunk: ref.wkv6_ref(r, k, v, w, u,
                                                          s0))


def _held_and_ms(torch, fn, runs: int) -> tuple[int, float, list]:
    """``fn()``'s working set on the card (its peak beyond what it was
    given, less what it returns, from ``max_memory_allocated``) on its
    first call, and the median ms of ``runs`` calls after it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fn()
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base \
        - _nbytes(x for x in got if x is not None)
    del got
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return held, sorted(ms)[len(ms) // 2], ms


def backward_on_card(torch, card: str, tag: str) -> None:
    """Each kernel operator's backward (``ops.backward``) at
    chunk-spanning shapes, those the model's card terms were fit to and
    four it was not: its working set on the card against
    ``ops.grad_workspace(..., device="cuda")``, which the dry-run's meta
    stand-in holds (±15 %); at S=2048 also its ms against the plain
    version's gradient (``ops._grads_of`` on ``ref``), which the
    operators took before, with that one's working set."""
    from repro_torch.kernels import ops

    for i, (name, dims, dtype, options) in enumerate(BACKWARDS):
        inputs, grads, plain = _backward_inputs(torch, name, dims, dtype)
        shapes = [None if x is None else x.shape for x in inputs]
        held, ms, all_ms = _held_and_ms(
            torch, lambda: ops.backward(name, inputs, grads, options), 3)
        model = ops.grad_workspace(name, shapes, inputs[0].dtype, options,
                                   "cuda")
        err = model / held - 1.0
        fit = "held out" if i >= HELD_OUT else "fit"
        print(f"[{tag}] {name} backward {dims} {dtype} options {options} "
              f"({fit}): working set {held} B on the card, {model} B "
              f"modelled ({err * 100:+.2f} %); {ms:.3f} ms (median of "
              f"{[round(x, 3) for x in all_ms]}) [{card}]")
        check(abs(err) <= WORKSPACE_RTOL,
              f"{tag}: the {name} backward's working set is "
              f"{err * 100:+.2f} % off its model")
        if i in TIMED_BACKWARDS:
            old_held, old_ms, old_all = _held_and_ms(
                torch, lambda: ops._grads_of(
                    lambda *xs: plain(*xs, *options), inputs, grads), 2)
            print(f"[{tag}] {name} backward {dims} {dtype} at S=2048: "
                  f"plain version's gradient {old_ms:.3f} ms (median of "
                  f"{[round(x, 3) for x in old_all]}), working set "
                  f"{old_held} B; the reference's formula {ms:.3f} ms, "
                  f"{held} B; {old_ms / ms:.2f}× the time, "
                  f"{old_held / held:.2f}× the memory [{card}]")
        del inputs, grads


def analyzer_on_card(card: str, tag: str) -> None:
    """Phase 23: the static passes over the checkout's port, and phase
    20's threaded run, traced, under the port's strict lock-order
    witness."""
    from repro_torch.analysis import install_witness, uninstall_witness
    from repro_torch.analysis.__main__ import main as analyze

    t0 = time.perf_counter()
    rc = analyze([])
    print(f"[{tag}] python -m repro_torch.analysis: exit {rc} in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    check(rc == 0, f"{tag}: the analyzer found something")
    witness = install_witness(strict=True)
    try:
        thread_waves(tag, traced=True)
    finally:
        uninstall_witness()
    problems = witness.check_declared()
    print(f"[{tag}] strict witness: {len(witness.observed)} lock nestings "
          f"observed {sorted(witness.observed)}, {len(witness.violations)} "
          f"violations, {len(problems)} contradictions of LOCK_ORDER "
          f"[{card}]")
    check(not witness.violations and not problems and witness.observed,
          f"{tag}: {witness.violations} {problems}")


# -- 24. the recurrent architectures' train step -----------------------------

#: phase 24's cells: (arch, depth or None for the full one, the kernel
#: launches a step — each forward and its remat recompute; the two
#: trailing RG-LRU layers of recurrentgemma-2b's 26, outside its eight
#: (recurrent, recurrent, attention) units, are not checkpointed, as in
#: the reference, and run once)
RECURRENT_TRAIN = (
    ("recurrentgemma-2b", None,
     {"flash_attention": 16, "rglru_scan": 34, "wkv6": 0,
      "flash_decode": 0}),
    ("rwkv6-7b", 8, {"flash_attention": 0, "rglru_scan": 0, "wkv6": 16,
                     "flash_decode": 0}),
)
#: phase 24's batch (B × S tokens) and the steps timed after its warm-up
RECURRENT_SHAPE = (2, 2048)
RECURRENT_STEPS = 3


def train_recurrent(torch, kernels: dict, card: str, tag: str) -> dict:
    """Phase 24: one train step of each recurrent architecture on the
    card through ``build_cell``, held against the dry-run of the same
    cell on meta; returns the launch counts, read just after."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.cells import TrainKnobs, build_cell
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.transformer import Transformer

    B, S = RECURRENT_SHAPE
    shape = ShapeSpec(f"train_{B}x{S}", S, B, "train")
    knobs = TrainKnobs(accum=1, ce_seq_chunk=512)
    steps = 1 + RECURRENT_STEPS
    for mod in kernels.values():
        mod.launches = 0
    for arch, depth, per_step in RECURRENT_TRAIN:
        overrides = {"remat": "full"}
        if depth is not None:
            full = sum(p.numel() for p in Transformer(
                get_config(arch), device="meta").parameters())
            overrides["n_layers"] = depth
            print(f"[{tag}] {arch}: depth cut to {depth} of "
                  f"{get_config(arch).n_layers} layers: {full / 1e9:.2f} B "
                  f"parameters at full depth, whose bf16 weights, float32 "
                  f"gradients and AdamW state ({full * 14 / 1e9:.1f} GB) do "
                  "not fit one card")
        free_card(torch)
        start = {name: mod.launches for name, mod in kernels.items()}
        cell = build_cell(arch, shape, overrides, knobs=knobs,
                          device="cuda")
        cfg = cell.cfg
        check(cfg.param_dtype == "bfloat16"
              and cell.static_notes["accum"] == 1, f"{tag}: {cfg}")
        args = _nbytes(t for ts in cell.argument_tensors().values()
                       for t in ts)
        torch.cuda.synchronize()
        others = torch.cuda.memory_allocated() - args
        torch.cuda.reset_peak_memory_stats()
        m = cell.fn(*cell.args)[2]
        losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
        peak = torch.cuda.max_memory_allocated() - others
        ms = []
        for _ in range(RECURRENT_STEPS):
            t0 = time.perf_counter()
            m = cell.fn(*cell.args)[2]
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ran = {name: mod.launches - start[name]
               for name, mod in kernels.items()}
        step_ms = sorted(ms)[len(ms) // 2]
        n_params = sum(p.numel() for p in cell.args[0].parameters())
        flops = 6.0 * n_params * B * S
        rec = run_cell(arch, shape, cfg_overrides=overrides, knobs=knobs,
                       save=False, verbose=False)
        est = rec["memory"]["peak_bytes"]
        err = est / peak - 1.0
        print(f"[{tag}] {arch}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, bf16 "
              f"weights, float32 gradients and AdamW state "
              f"({args / 2**30:.3f} GiB of arguments); B={B} S={S}, remat "
              f"full, ce_seq_chunk 512; losses {losses}, grad norms "
              f"{norms} (the schedule's first step moves no weight); "
              f"launches {ran} over {steps} steps; ms a step "
              f"{step_ms:.3f} (median of {[round(x, 3) for x in ms]}), "
              f"{B * S / step_ms * 1e3:.1f} tokens/s, "
              f"{flops / step_ms / 1e9:.2f} model TFLOP/s (6·N·B·S, N "
              f"{n_params}); peak "
              f"memory {peak / 2**30:.3f} GiB ({peak} B; {others} B else "
              f"on the card), {est / 2**30:.3f} GiB on meta "
              f"({err * 100:+.2f} %) [{card}]")
        check(all(map(math.isfinite, losses + norms)),
              f"{tag}: {arch}'s losses {losses} or grad norms {norms}")
        check(ran == {k: n * steps for k, n in per_step.items()},
              f"{tag}: {arch} launched {ran}, want {per_step} a step")
        check(abs(err) <= PEAK_RTOL,
              f"{tag}: {arch}'s peak estimate is {err * 100:+.2f} % off")
        del cell, m
    launches = {name: mod.launches for name, mod in kernels.items()}
    free_card(torch)
    return launches


# -- 25. deepseek-v3 ------------------------------------------------------------

#: phase 25's limit on each (position, head) row's relative error,
#: ||o − want|| / ||want||, of deepseek-v3's prefill attention (K1 over
#: the heads padded to 256, bf16) against the plain causal attention of
#: the unpadded q, k, v in float32: on an H100 the sound rows read at
#: most 1.45e-2 (median 4.0e-3) at S = 1,024 and 2,048, and a scale that
#: lacks YaRN's m² reads 0.90 at the worst row (median 0.62)
MLA_ROW_REL_LIMIT = 5e-2
#: phase 25's prompt lengths: the two largest buckets of the
#: ``deepseek-v3.chat`` cell (prompts 32–2048, median 1020)
MLA_PREFILL_S = (1024, 2048)
#: deepseek-v3-ep32's depth: the first stage of two (bench/configs)
DEEPSEEK_LAYERS = 31


def mla_plain_attention(torch, q, k, v, scale: float):
    """Causal attention of q, k (B, S, H, nope + rope) and v (B, S, H,
    v) in float32, 16 heads at a time: (B, S, H, v) float32."""
    S, H = q.shape[1], q.shape[2]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = []
    for h in range(0, H, 16):
        qh, kh, vh = (t[:, :, h:h + 16].transpose(1, 2).float()
                      for t in (q, k, v))
        s = (qh @ kh.transpose(-1, -2)) * scale
        s.masked_fill_(~causal, -math.inf)
        out.append((torch.softmax(s, dim=-1) @ vh).transpose(1, 2))
    return torch.cat(out, dim=2)


def row_rel_err(o, want):
    """(B, S, H) relative errors of each (position, head) row."""
    d = (o.double() - want.double()).norm(dim=-1)
    return d / want.double().norm(dim=-1)


def check_mla_attention(torch, cfg, device, lengths, *, tag: str,
                        seed: int = 25) -> float:
    """One MLA layer of ``cfg`` (its published init) over a seeded
    normed input of each length in ``lengths``: ``MLALayer.attend`` (K1
    on the card, over q and k padded from nope + rope to 256 and v from
    v_head_dim, q pre-scaled) against :func:`mla_plain_attention` of the
    same q_nope, RoPE(q_pe) and latent, unpadded, with the keys and
    values materialised in float32.  Each row's relative error must stay
    under ``MLA_ROW_REL_LIMIT``, and the same plain attention with a
    scale that lacks YaRN's m² (a planted fault) must exceed it.
    Returns the largest sound row error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.mla import MLALayer, fill_mla_layer, yarn_mscale

    dtype = getattr(torch, cfg.dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    layer = MLALayer(cfg, dtype=dtype, device=device)
    fill_mla_layer(layer, g)
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    worst = 0.0
    for S in lengths:
        h = torch.randn((1, S, cfg.d_model), generator=g,
                        device=device).to(dtype)
        x = rmsnorm(h, layer.ln1, cfg.norm_eps)
        rot = layer.rotation(torch.arange(S, device=device))
        with torch.no_grad():
            q_nope, q_pe = layer.queries(x, rot)
            lat = layer.latent(x, rot)
            before = fa.launches
            o = layer.attend(q_nope, q_pe, lat)
            ran = fa.launches - before
            kv = (lat[..., :r].float() @ layer.wkv_b.float().T) \
                .view(1, S, H, dn + dv)
            q = torch.cat([q_nope, q_pe], dim=-1).float()
            k = torch.cat([kv[..., :dn], lat[:, :, None, r:].float()
                           .expand(1, S, H, dr)], dim=-1)
            want = mla_plain_attention(torch, q, k, kv[..., dn:],
                                       layer.scale)
            err = row_rel_err(o, want)
            fault = row_rel_err(mla_plain_attention(
                torch, q, k, kv[..., dn:], layer.scale / (m * m)), want)
        e_max, e_med = err.max().item(), err.median().item()
        f_max, f_med = fault.max().item(), fault.median().item()
        print(f"[{tag}] MLA prefill attention S={S} H={H} (q/k {dn + dr}, "
              f"v {dv}; K1 launches {ran}) {cfg.dtype}: row relative error "
              f"max {e_max:.3e}, median {e_med:.3e} (limit "
              f"{MLA_ROW_REL_LIMIT:g}); planted fault, no YaRN m² in the "
              f"scale: max {f_max:.3e}, median {f_med:.3e}")
        check(o.shape == (1, S, H, dv) and bool(torch.isfinite(o).all()),
              f"{tag}: MLA attention at S={S}: {tuple(o.shape)} or not "
              "finite")
        check(e_max < MLA_ROW_REL_LIMIT,
              f"{tag}: MLA attention at S={S}: row relative error "
              f"{e_max:.3e} over {MLA_ROW_REL_LIMIT:g}")
        check(f_max > MLA_ROW_REL_LIMIT,
              f"{tag}: the planted fault at S={S} passes the limit "
              f"({f_max:.3e})")
        check(ran == (1 if o.is_cuda else 0),
              f"{tag}: {ran} K1 launches for one MLA attention")
        worst = max(worst, e_max)
    return worst


def deepseek_v3_on_card(torch, fa, ref, kernels: dict, card: str,
                        tag: str) -> dict:
    """Phase 25: deepseek-v3's prefill attention on the card at full
    width, K1 timed at its padded shape, and the 31-layer model served,
    with one prefill of each of ``MLA_PREFILL_S`` counted; returns the
    serving run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import prefill

    cfg = get_config("deepseek-v3")
    err = check_mla_attention(torch, cfg, "cuda", MLA_PREFILL_S, tag=tag)
    print(f"[{tag}] MLA prefill attention: largest row error {err:.3e} "
          f"[{card}]")
    free_card(torch)
    for S in MLA_PREFILL_S:
        time_attention(torch, fa, ref, 1, S, cfg.n_heads, cfg.n_heads, 256)
    free_card(torch)

    def one_prefill(params, cfg):
        g = torch.Generator(device="cuda").manual_seed(DEEPSEEK_LAYERS)
        for S in MLA_PREFILL_S:
            toks = torch.randint(1, cfg.vocab, (1, S), generator=g,
                                 device="cuda")
            for mod in kernels.values():
                mod.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                logits, _ = prefill(params, toks, cfg, max_len=S)
                end.record()
            torch.cuda.synchronize()
            ran = {name: mod.launches for name, mod in kernels.items()}
            print(f"[{tag}] one prefill of {S} tokens through "
                  f"{cfg.n_layers} layers: launches {ran}, "
                  f"{start.elapsed_time(end):.2f} ms (CUDA events)")
            check(bool(torch.isfinite(logits).all()),
                  f"{tag}: the prefill's logits are not finite")
            check(ran == {"flash_attention": DEEPSEEK_LAYERS,
                          "rglru_scan": 0, "wkv6": 0, "flash_decode": 0},
                  f"{tag}: one prefill launched {ran}, want K1 "
                  f"{DEEPSEEK_LAYERS} and nothing else")

    launches = serve_full_width(
        torch, "deepseek-v3", kernels,
        {"flash_attention": DEEPSEEK_LAYERS, "rglru_scan": 0, "wkv6": 0},
        tag, n_layers=DEEPSEEK_LAYERS, after=one_prefill)
    free_card(torch)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
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

    build(torch, [fa, k2, k3, fd], fa, k3, fd)
    fa_err = check_attention(torch, fa, ref)
    k2_err = check_scan(torch, k2, ref)
    k3_err = check_wkv(torch, k3, ref)
    fd_err = check_decode(torch, fd, ref)

    t_fa = time_attention(torch, fa, ref, 1, 32, 32, 8, 64)
    time_attention(torch, fa, ref, 1, 2048, 32, 8, 64)
    time_attention(torch, fa, ref, 1, 23, 10, 1, 256, window=2048)
    time_attention(torch, fa, ref, 1, 2048, 10, 1, 256, window=2048)
    time_attention(torch, fa, ref, 8, 128, 32, 8, 64)       # train step
    time_attention(torch, fa, ref, 4, 2048, 32, 8, 64)      # phase 21's
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
    t_fd = time_decode(torch, fd, ref, "mixtral-8x22b.chat", *CHAT_DECODE,
                       48, 8, 128)
    time_decode(torch, fd, ref, "gemma2-9b", 4, 4096, 16, 8, 256,
                softcap=50.0)
    time_decode(torch, fd, ref, "llama3.2-1b", 4, 2048, 32, 8, 64)
    time_decode(torch, fd, ref, "recurrentgemma-2b", 4, 2048, 10, 1, 256)

    kernels = {"flash_attention": fa, "rglru_scan": k2, "wkv6": k3,
               "flash_decode": fd}
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
    free_card(torch)

    elastic = elastic_drill(torch, kernels, "elastic llama3.2-1b")
    free_card(torch)
    traced = traced_serving(torch, kernels, "traced serving llama3.2-1b")
    free_card(torch)
    host_runtime("host runtime")

    remat, remat_launches = remat_on_card(torch, kernels, card,
                                          "remat llama3.2-1b")
    dryrun_launches = dryrun_against_card(torch, kernels, remat, card,
                                          "dry-run")
    analyzer_on_card(card, "analyzer")
    recurrent = train_recurrent(torch, kernels, card, "train recurrent")
    deepseek_v3 = deepseek_v3_on_card(torch, fa, ref, kernels, card,
                                      "deepseek-v3")

    paths = {"llama3.2-1b": llama, "recurrentgemma-2b": rgemma,
             "rwkv6-7b": rwkv, "train llama3.2-1b": train,
             "gemma2-9b": gemma, "deepseek-coder-33b": deepseek,
             "qwen1.5-110b (8 of 80 layers)": qwen,
             "musicgen-medium": musicgen,
             "internvl2-1b prefix prefill + decode": internvl,
             "train internvl2-1b": train_internvl,
             "llama4-maverick-400b-a17b (4 of 48 layers)": llama4,
             "mixtral-8x22b (8 of 56 layers)": mixtral,
             "elastic train llama3.2-1b": elastic,
             "traced serving llama3.2-1b": traced,
             "remat llama3.2-1b (none, full, dots; 4 × 2048)":
             remat_launches,
             "dry-run's small prefills on the card": dryrun_launches,
             "train recurrentgemma-2b and rwkv6-7b (8 of 32 layers)":
             recurrent,
             "deepseek-v3 (31 of 61 layers)": deepseek_v3}

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
        row("flash_decode", "flash_decode.cu",
            "none: src/repro/models/layers.py decode_gqa_attention is plain "
            "jnp under a pallas:flash_decode scope", fd_err, t_fd),
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
