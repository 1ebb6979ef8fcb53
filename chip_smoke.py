#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero
and no result line is printed):

1. build — print the card's name and power limit, compile the
   flash-attention kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` and print the build seconds;
2. kernel against its plain version — the kernel against
   ``ref.attention_ref`` on the card at the serving path's shapes and at
   prefill, MQA/f32, window, softcap and ragged shapes, within the
   tolerance of ``tests/test_kernels.py`` (bf16 2e-2, f32 2e-5);
3. times — kernel, plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) at S = 32 and S = 2048, beside the kernel's bound;
4. serve — full-width llama3.2-1b (bf16, seeded random weights) through
   ``repro_torch.launch.serve``: 8 requests, max batch 4, 16 new tokens,
   policy ``prediction``; every prefill attention must have launched the
   kernel (16 layers × prefills), every request must finish, and a small
   float32 model must give the same logits and greedy tokens on the card
   as the plain path on the CPU.

The last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Needs one CUDA device; fails without.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core FLOP/s
#: and device-memory bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
N_LAYERS = 16


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


def bound(B, S, H, KV, D) -> tuple[float, str]:
    """Least time on the card for causal bf16 attention, ms: its
    operations (4·D per unmasked query-key pair, S(S+1)/2 pairs a head)
    at the tensor-core peak, or the bytes of q, k, v and o once each at
    the memory rate, whichever is larger."""
    ops_s = 4 * B * H * (S * (S + 1) // 2) * D / PEAK_BF16_FLOPS
    bytes_s = (2 * B * S * H * D + 2 * B * S * KV * D) * 2 / PEAK_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import report, serve
    from repro_torch.models import forward, init_params
    from repro_torch.serving import Request, ServingEngine

    # float32 products in full float32 (no TF32) for every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = fa.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")

    # -- 2. kernel against its plain version --------------------------------
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, S, H, KV, D, dtype, window, softcap, input scale
        ("serve S=16", 1, 16, 32, 8, 64, bf16, None, None, 1.0),
        ("serve S=32", 1, 32, 32, 8, 64, bf16, None, None, 1.0),
        ("prefill S=2048", 1, 2048, 32, 8, 64, bf16, None, None, 1.0),
        ("MQA D=128 f32", 2, 256, 8, 1, 128, f32, None, None, 1.0),
        ("window 128", 1, 512, 32, 8, 64, bf16, 128, None, 1.0),
        ("softcap 20", 1, 256, 32, 8, 64, bf16, None, 20.0, 3.0),
        ("ragged S=200", 2, 200, 32, 8, 64, bf16, None, None, 1.0),
    ]
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
        print(f"[check] {name:15s} {str(dt):15s} max|err| {err:.3e} "
              f"(rtol=atol={tol:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with its plain version")
        if name.startswith("serve"):
            main_err = max(main_err, err)

    # -- 3. times ---------------------------------------------------------------
    from torch.nn import functional as F
    sdpa_gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) \
        >= (2, 5)
    times = {}
    for S in (32, 2048):
        B, H, KV, D = 1, 32, 8, 64
        q, k, v = attention_inputs(torch, B, S, H, KV, D, bf16, seed=S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not sdpa_gqa:
            kt = kt.repeat_interleave(H // KV, dim=1)
            vt = vt.repeat_interleave(H // KV, dim=1)
        gqa_kw = {"enable_gqa": True} if sdpa_gqa else {}
        iters = 200 if S <= 32 else 20
        row = {
            "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v),
                          iters),
            "plain_ms": time_ms(torch, lambda: ref.attention_ref(q, k, v),
                                iters),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, **gqa_kw), iters),
        }
        row["bound_ms"], row["bound_by"] = bound(B, S, H, KV, D)
        times[S] = row
        print(f"[time] flash_attention B={B} S={S} H={H} KV={KV} D={D} "
              f"bf16: kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f}"
              f" ms, sdpa {row['library_ms']:.5f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})")

    # -- 4. serve -------------------------------------------------------------------
    cfg = get_config("llama3.2-1b")
    check(cfg.param_dtype == "bfloat16" and cfg.n_layers == N_LAYERS,
          "unexpected llama3.2-1b config")
    params = init_params(cfg, device="cuda", seed=0)
    serve(cfg, requests=2, max_batch=4, max_new=2, seed=1,
          params=params)                                      # warm-up
    fa.launches = 0
    result = serve(cfg, requests=8, max_batch=4, max_new=16,
                   policy="prediction", seed=0, device="cuda",
                   params=params)
    launches = fa.launches
    engine, reqs = result["engine"], result["requests"]
    for line in report(result):
        print(f"[serve] {line}")
    lat = sorted(r.done_at - r.submitted_at for r in reqs)
    print(f"[serve] ticks {engine.ticks}, prefills {engine.prefills}, "
          f"kernel launches {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"latency max {lat[-1] * 1e3:.1f} ms")
    check(engine.prefills == len(reqs), "not every request was prefilled")
    check(launches == N_LAYERS * engine.prefills,
          f"{launches} kernel launches for {engine.prefills} prefills")
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
    # except where bf16 rounding flips a near-tie (informational).
    n = len(reqs[0].prompt)
    greedy = logits[0, n - 1:, :cfg.vocab].argmax(-1).tolist()
    same = sum(a == b for a, b in zip(greedy, reqs[0].output))
    print(f"[serve] request 0: forward argmax equals the engine's token "
          f"at {same}/{len(reqs[0].output)} steps")
    del result, engine, logits, params

    # a small float32 model: the card (kernel) against the CPU (plain)
    small = get_smoke_config("llama3.2-1b").replace(
        d_model=256, n_heads=4, kv_heads=2, head_dim=64, d_ff=512,
        param_dtype="float32")
    cpu_model = init_params(small, torch.Generator().manual_seed(0),
                            device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    toks = torch.randint(0, small.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        l_cpu, _ = forward(cpu_model, toks, small)
        l_gpu, _ = forward(gpu_model, toks.cuda(), small)
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    print(f"[check] small f32 model logits, card vs CPU: max|err| "
          f"{err:.3e} (1e-4)")
    check(err <= 1e-4, "small model logits differ between card and CPU")
    prompts = [[5, 9, 2, 7], [1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]
    outs = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        eng = ServingEngine(small, model, max_batch=2, max_len=64,
                            device=dev)
        rs = [eng.submit(Request(prompt=p, max_new_tokens=6))
              for p in prompts]
        eng.run_until_drained()
        outs.append([r.output for r in rs])
    print(f"[check] small f32 engine, greedy tokens card == CPU: "
          f"{outs[0] == outs[1]}")
    check(outs[0] == outs[1], "greedy tokens differ between card and CPU")

    row = times[32]
    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }]}
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
