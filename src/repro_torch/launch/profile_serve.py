"""Where the serving path's time goes on the card: one
:func:`repro_torch.launch.serve.serve` run under ``torch.profiler``.

    python -m repro_torch.launch.profile_serve --arch llama3.2-1b \\
        [--requests 8] [--max-batch 4] [--max-new 16] [--out FILE]

Prints the wall seconds, the device-kernel seconds and the device's idle
share of the wall (one stream, so kernels do not overlap), then the
kernels with the most device time and the port's own kernels.  ``--out``
also writes them as JSON.  The weights are made, and a warm-up run is
served, before the profiler starts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config, get_smoke_config
from ..models import init_params
from .serve import serve

#: kernels of this package, by the name of their CUDA function
PORT_KERNELS = ("flash_attention_kernel",)


def _device_us(evt) -> float:
    # the attribute's name changed across PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time attribute")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    params = init_params(cfg, seed=args.seed)
    serve(cfg, requests=2, max_batch=args.max_batch, max_new=2,
          seed=args.seed + 1, params=params)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = serve(cfg, requests=args.requests,
                       max_batch=args.max_batch, max_new=args.max_new,
                       seed=args.seed, params=params)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(_device_us(e) for e in kernels) / 1e6
    wall = result["wall_s"]
    kernels.sort(key=_device_us, reverse=True)

    def row(e) -> dict:
        return {"kernel": e.key[:80], "calls": e.count,
                "device_ms": _device_us(e) / 1e3,
                "share_of_device": _device_us(e) / 1e6 / device_s
                if device_s else None}

    top = [row(e) for e in kernels[:args.top]]
    ours = [row(e) for e in kernels
            if any(name in e.key for name in PORT_KERNELS)]
    summary = {"card": card, "arch": cfg.name, "requests": args.requests,
               "max_batch": args.max_batch, "max_new": args.max_new,
               "tokens": result["engine"].tokens_out, "wall_s": wall,
               "device_kernel_s": device_s,
               "device_idle_share": 1.0 - device_s / wall,
               "kernel_launches": sum(e.count for e in kernels),
               "top": top, "port_kernels": ours}
    print(f"{card}: {cfg.name}, {args.requests} requests, "
          f"{summary['tokens']} tokens; wall {wall:.4f} s (profiled), "
          f"device kernels {device_s:.4f} s, idle share "
          f"{summary['device_idle_share']:.3f}, "
          f"{summary['kernel_launches']} kernel launches")
    for label, rows in (("top", top), ("port kernels", ours)):
        print(f" {label}:")
        for r in rows:
            print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d} calls  "
                  f"{r['kernel']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
