"""Where a train step's time goes on the card: one step of
:class:`repro_torch.train.trainer.Trainer` under ``torch.profiler``.

    python -m repro_torch.launch.profile_train --arch llama3.2-1b \\
        [--global-batch 8] [--seq-len 128] [--out FILE]

Prints, for the whole step and for its two phases run alone — the loss
and its gradients (:func:`repro_torch.train.steps.grads_of`) and the
optimizer (:func:`~repro_torch.train.steps.apply_update`: the clip, the
schedule and AdamW), the two functions the step is made of — the wall
seconds, the device-kernel seconds, the device's idle
share of the wall (one stream, so kernels do not overlap) and the kernel
launches.  Then the step's kernels with the most device time, K1's
launches and share, and the host-side operations with the most self CPU
time; and, unprofiled, the host's microseconds a launch for a loop of
one-element additions, the floor of eager PyTorch on this machine.
``--out`` also writes them as JSON.  Two steps run before the profiler
starts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config, get_smoke_config
from ..train.steps import StepConfig, apply_update, grads_of
from ..train.trainer import Trainer, TrainerConfig
from .profile_serve import PORT_KERNELS, _device_us


def _profiled(fn) -> tuple[list, float]:
    """key_averages() of one synchronised call of ``fn``, and its wall
    seconds."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return list(prof.key_averages()), wall


def _kernels(events: list) -> list:
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _summary(events: list, wall: float) -> dict:
    kernels = _kernels(events)
    device_s = sum(_device_us(e) for e in kernels) / 1e6
    return {"wall_s": wall, "device_kernel_s": device_s,
            "device_idle_share": 1.0 - device_s / wall,
            "kernel_launches": sum(e.count for e in kernels)}


def _launch_floor_us(n: int = 2000) -> float:
    """Host microseconds a launch of a one-element addition, unprofiled."""
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
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
    tcfg = TrainerConfig(steps=3, global_batch=args.global_batch,
                         seq_len=args.seq_len, seed=args.seed,
                         log_every=1 << 30, step=StepConfig(warmup=2))
    trainer = Trainer(cfg, tcfg, device="cuda")
    trainer.run(2)
    events, wall = _profiled(lambda: trainer.run(1))
    phases = {"step": _summary(events, wall)}
    device_s = phases["step"]["device_kernel_s"]
    kernels = sorted(_kernels(events), key=_device_us, reverse=True)

    def row(e) -> dict:
        return {"kernel": e.key[:80], "calls": e.count,
                "device_ms": _device_us(e) / 1e3,
                "share_of_device": _device_us(e) / 1e6 / device_s}

    top = [row(e) for e in kernels[:args.top]]
    ours = [row(e) for e in kernels
            if any(name in e.key for name in PORT_KERNELS)]
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_top = [{"op": e.key[:60], "calls": e.count,
                 "self_cpu_ms": e.self_cpu_time_total / 1e3}
                for e in host[:args.top]]

    # the step's two phases alone, on the next batch: they advance the
    # trainer by one more step
    named = dict(trainer.params.named_parameters())
    batch_np = next(trainer.data)
    batch = {k: torch.from_numpy(getattr(batch_np, k)).to("cuda", torch.long)
             for k in ("tokens", "labels")}
    grads = {}

    def loss_and_grads():
        grads.update(grads_of(trainer.params, cfg, batch, trainer.step_cfg)[1])

    def update():
        trainer.opt_state = apply_update(
            trainer.params, trainer.opt_state, trainer.step, grads, cfg,
            tcfg.opt, trainer.step_cfg)[0]

    phases["loss and gradients"] = _summary(*_profiled(loss_and_grads))
    phases["optimizer"] = _summary(*_profiled(update))
    floor_us = _launch_floor_us()
    trainer.close()
    summary = {"card": card, "arch": cfg.name,
               "global_batch": args.global_batch, "seq_len": args.seq_len,
               "tokens": args.global_batch * args.seq_len,
               "parameters": sum(p.numel() for p in named.values()),
               "tensors": len(named), "phases": phases, "top": top,
               "port_kernels": ours, "host_top": host_top,
               "host_us_per_launch_floor": floor_us}
    print(f"{card}: {cfg.name} train step, {summary['tokens']} tokens, "
          f"{summary['parameters']} parameters in {len(named)} tensors")
    for name, ph in phases.items():
        print(f" {name:18s}: wall {ph['wall_s']:.4f} s (profiled), device "
              f"kernels {ph['device_kernel_s']:.4f} s, idle share "
              f"{ph['device_idle_share']:.3f}, {ph['kernel_launches']} "
              f"kernel launches, {ph['wall_s'] / ph['kernel_launches'] * 1e6:.1f}"
              f" µs of wall a launch")
    print(f" host floor: {floor_us:.2f} µs a launch (one-element add, "
          "unprofiled)")
    for label, rows in (("top", top), ("port kernels", ours)):
        print(f" {label}:")
        for r in rows:
            print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d} calls  "
                  f"{r['share_of_device']:.4f}  {r['kernel']}")
    print(" host (self CPU time):")
    for r in host_top:
        print(f"  {r['self_cpu_ms']:10.3f} ms  {r['calls']:6d} calls  "
              f"{r['op']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
