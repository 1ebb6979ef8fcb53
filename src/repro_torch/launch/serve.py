"""Serving launcher — continuous batching + prediction autoscaling, on the
card.  The port of :mod:`repro.launch.serve`, with a ``--device`` flag:

    python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --requests 16 --policy prediction
    python -m repro_torch.launch.serve --arch gemma2-9b
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch rwkv6-7b
    python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke \\
        --device cpu

``--arch`` takes every id of :data:`repro_torch.configs.ARCH_IDS`.  At
full depth qwen1.5-110b (≈ 207 GiB of bf16 weights), mixtral-8x22b
(≈ 262 GiB) and llama4-maverick-400b-a17b (≈ 741 GiB) do not fit one
80 GB card, and deepseek-coder-33b (≈ 62 GiB) fits with little room;
``chip_smoke.py`` serves the three at full width and reduced depth
through :func:`serve`.  internvl2-1b and musicgen-medium are served on
their tokens alone, with no frontend prefix, as the reference's engine
serves them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import policy_entry, registered_policies
from ..models import ModelConfig, init_params
from ..models.transformer import Transformer, resolve_device
from ..serving import AutoScaler, Request, ServingEngine

__all__ = ["serve", "main"]


def serve(cfg: ModelConfig, *, requests: int = 16, max_batch: int = 4,
          max_new: int = 16, policy: str = "prediction", seed: int = 0,
          device: str | torch.device = "cuda", max_len: int = 128,
          params: Transformer | None = None) -> dict:
    """Serve ``requests`` random prompts (4–23 tokens, drawn from
    ``seed``) through a :class:`ServingEngine` driven by an
    :class:`AutoScaler`; weights are ``params`` or else the port's init
    from ``seed``.

    Returns the engine, the requests, the autoscaler's Δ trace and the
    wall seconds from the first submit to the drained engine.
    """
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, device=device, seed=seed)
    engine = ServingEngine(cfg, params, max_batch=max_batch,
                           max_len=max_len, device=device)
    scaler = AutoScaler(engine.monitor, max_replicas=max_batch,
                        policy=policy, bus=engine.bus)
    rng = np.random.default_rng(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    reqs = []
    for _ in range(requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 24)) \
            .tolist()
        reqs.append(engine.submit(Request(prompt=prompt,
                                          max_new_tokens=max_new)))
    targets = []
    while engine.load:
        targets.append(scaler.target(len(engine.queue),
                                     sum(r is not None
                                         for r in engine.active)))
        engine.tick()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return {"engine": engine, "requests": reqs, "targets": targets,
            "wall_s": wall}


def report(result: dict) -> list[str]:
    """The launcher's three summary lines: tok/s, latency, Δ trace."""
    engine, reqs = result["engine"], result["requests"]
    wall = result["wall_s"]
    lat = [r.done_at - r.submitted_at for r in reqs]
    return [
        f"{len(reqs)} requests, {engine.tokens_out} tokens in "
        f"{wall:.2f}s ({engine.tokens_out / wall:.1f} tok/s)",
        f"latency p50={np.percentile(lat, 50)*1e3:.0f}ms "
        f"p95={np.percentile(lat, 95)*1e3:.0f}ms",
        f"autoscaler Δ trace (first 20): {result['targets'][:20]}",
    ]


def main() -> None:
    # Any registered non-sharing policy can drive the autoscaler.
    policies = [p for p in registered_policies()
                if not policy_entry(p).sharing]
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="prediction", choices=policies)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    result = serve(cfg, requests=args.requests, max_batch=args.max_batch,
                   max_new=args.max_new, policy=args.policy,
                   seed=args.seed, device=args.device)
    for line in report(result):
        print(line)


if __name__ == "__main__":
    main()
