"""The readings that set a cell's limits of ``correct``: the program's
numbers on many seeds (the lower readings), and on some of them the
control's — the plain reference computed in float8, the nearest
precision below the configuration's bfloat16 — and, for a train cell,
a planted fault's (the upper readings).  One process, the kernels built
once, the weights drawn anew for each seed.

    python3 -m bench.tools.calibrate --workload mixtral-8x22b.chat \\
        --seeds 11 12 13 14 15 16 --controls 3 --seconds 15

Serving: each seed runs the cell's traffic at its own rate for a window
of ``--seconds`` and compares the same sample a run compares;
``control_gap`` is the widest gap, in the reference's logits, of the
token the float8 reference puts first at each position.  Training: each
seed runs the job's first steps on the program and the reference;
``control_fp8`` is the float8 reference read against the float32 one
(``control_fp8_forward``: float8 in the forward products only), and
``half_batch`` the program with half of each batch left out (the mean
taken over the rest); each is judged by the cell's own limits
(``correct``), and the tool exits with 1 if a control or a fault comes
out correct.  Prints one JSON line a seed."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import program
from ..drivers import serve, train
from ..harness import Context
from ..model import dims
from ..spec import load_cell
from ..trace import Tracer
from ..traffic import schedule


class _NoEnergy:
    def joules(self) -> float:
        return 0.0


def _serve(ctx, control: bool) -> dict:
    sut = serve.build(ctx)
    serve.warm(sut, ctx)
    rec = serve.drive(sut, ctx, schedule(ctx.cell.traffic, ctx.seed,
                                         ctx.seconds, ctx.dims.vocab),
                      ctx.seconds)
    serve.free(sut, ctx.device)
    picked = serve.sample(rec["done"], ctx.seed, ctx.cell.traffic["check"])
    out = serve.compare(ctx.dims, ctx.seed, ctx.device, picked, control)
    out.update({"failed": rec["failed"], "due": rec["attempted"],
                "compared_tokens": sum(len(r["served"]) for r in picked)})
    if control:
        out["control_judged"] = _judged(
            {"max_logit_gap": out["control_gap"],
             "mean_logit_gap": out["control_mean_gap"]}, ctx.cell.traffic)
    return out


def _program_steps(ctx, half: bool = False) -> dict:
    """The program's numbers over the job's first steps (as a run's
    set-up reads them), with half of each batch left out if ``half``."""
    from repro_torch.train import steps
    grads_of = steps.grads_of
    if half:
        def halved(params, cfg, batch, step_cfg):
            b = batch["tokens"].shape[1] // 2
            return grads_of(params, cfg, {k: v[:, :b] for k, v in
                                          batch.items()}, step_cfg)
        steps.grads_of = halved
    try:
        rec = train.run_steps(ctx)
    finally:
        steps.grads_of = grads_of
    return rec


def _train(ctx, control: bool) -> dict:
    d, job = ctx.dims, ctx.cell.traffic
    prog = _program_steps(ctx)
    batches = [train.batch_tokens(ctx.seed, i, job["batch"], job["seq_len"],
                                  d.vocab, ctx.device)
               for i in range(job["check_steps"])]
    keep = train.positions(ctx.seed, job["batch"], job["seq_len"],
                           job["check"]["positions"])
    ref_mod = program.reference(d)
    ref = ref_mod.train_steps(d, ctx.seed, ctx.device, batches, job,
                              positions=keep)
    out = {"program": _judged(train.compare(prog, ref), job),
           "losses": prog["losses"], "ref_losses": ref["losses"]}
    if control:
        for precision in ("fp8", "fp8_forward"):
            low = ref_mod.train_steps(d, ctx.seed, ctx.device, batches, job,
                                      precision, positions=keep)
            out[f"control_{precision}"] = _judged(train.compare(low, ref),
                                                  job)
        out["half_batch"] = _judged(
            train.compare(_program_steps(ctx, half=True), ref), job)
    return out


def _judged(nums: dict, job: dict) -> dict:
    """``nums`` with ``correct``: whether each of the cell's limits holds."""
    return {**nums, "correct": all(nums[k] <= v for k, v in
                                   job["check"]["limits"].items())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="read the control (and faults) on the first N seeds")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    program.import_program()
    cell = load_cell(args.workload)
    device = torch.device("cuda")
    passed = False
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = Context(cell, dims(cell.config), seed, args.seconds, device,
                      Tracer(False, device), _NoEnergy(), t0)
        kind = cell.traffic["driver"]
        out = (_serve if kind == "serve" else _train)(ctx, n < args.controls)
        out.update({"seed": seed, "s": time.perf_counter() - t0})
        print(json.dumps(out), flush=True)
        passed |= any(v.get("correct") for k, v in out.items()
                      if isinstance(v, dict) and k != "program")
        torch.cuda.empty_cache()
    sys.exit(1 if passed else 0)


if __name__ == "__main__":
    main()
