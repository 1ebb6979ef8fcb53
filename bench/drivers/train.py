"""The program's train step, closed loop: ``grads_of`` then
``apply_update`` (the two halves ``make_train_step`` composes), back to
back, on batches drawn from the seed.

Set-up builds one model and one optimizer state and drives them through
the job's first ``check_steps`` steps, through the same calls and on the
same kind of batches as the window; those steps are the warm-up too.
From them the program's numbers for the comparison are read: each step's
loss, the first step's logits at positions drawn from the seed (as its
forward pass computes them, read as the head hands them to the loss),
each leaf's first clipped gradient's norm (from AdamW's first moment
after one step, ``μ / (1 − β₁)``) and each leaf's change after the steps
(against the seed's weights, drawn again).  The window then
runs steps on the same objects; a step counts when it has ended (its
loss read, which waits for the device) inside the window.

After the window, with the program's state freed, the plain reference
follows the same steps from the same weights and batches, in float32.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from .. import program
from ..weights import draw, group_seed

__all__ = ["run", "setup", "first_steps", "run_steps", "batch_tokens",
           "positions", "compare"]


def batch_tokens(seed: int, step: int, B: int, S: int, vocab: int,
                 device) -> torch.Tensor:
    """Step ``step``'s batch: (B, S + 1) tokens, inputs and their
    next-token labels, drawn from the seed on the device."""
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, 1_000_000 + step))
    return torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)


def positions(seed: int, B: int, S: int, n: int) -> torch.Tensor:
    """``n`` of the first step's B × S positions, drawn from the seed, as
    indices into its rows flattened (b · S + s), in order."""
    gen = torch.Generator().manual_seed(group_seed(seed, 2_000_000))
    return torch.randperm(B * S, generator=gen)[:n].sort().values


def compare(prog: dict, ref: dict, rule: float = 1e-3) -> dict:
    """The numbers compared: the widest relative gap of a step's loss;
    the first step's logits at the drawn positions, their distance from
    the reference's over the reference's spread about each row's mean
    (``logit_rel_err``); and, by the worst leaf, the gap between the
    program's and the reference's norms of the first clipped gradient
    and of the change, each over the reference's norm of that leaf or of
    the median leaf, whichever is larger.  The change leaves out leaves
    whose reference gradient is under ``rule`` × the median leaf's (they
    move under AdamW by round-off alone)."""
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    rg = ref["first_grad_norms"]
    med_g = statistics.median(rg.values())
    grad = [abs(prog["first_grad_norms"][k] - v) / max(v, med_g)
            for k, v in rg.items()]
    moved = [k for k, v in rg.items() if v >= rule * med_g]
    rc = ref["change_norms"]
    med_c = statistics.median(rc[k] for k in moved)
    change = [abs(prog["change_norms"][k] - rc[k]) / max(rc[k], med_c)
              for k in moved]
    lr = ref["sample_logits"].float()
    lp = prog["sample_logits"].float()[:, :lr.shape[1]].to(lr.device)
    spread = torch.linalg.vector_norm(lr - lr.mean(-1, keepdim=True))
    logit = float(torch.linalg.vector_norm(lp - lr) / spread)
    return {"loss_rel_gap": loss, "logit_rel_err": logit,
            "grad_norm_gap": max(grad),
            "change_norm_gap": max(change),
            "grad_norm_gap_median": statistics.median(grad),
            "change_norm_gap_median": statistics.median(change),
            "leaves_compared": len(moved)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx) -> dict:
    """The system under test: the model with the seed's weights, AdamW's
    state, and ``step(i)``, which runs step i on its batch."""
    program.import_program()
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import steps

    d, job, device = ctx.dims, ctx.cell.traffic, ctx.device
    B, S = job["batch"], job["seq_len"]
    cfg, model = program.build_model(d, ctx.cell.config, ctx.seed, device,
                                     remat=job["remat"],
                                     ce_seq_chunk=job["ce_seq_chunk"])
    opt_cfg = AdamWConfig(lr=job["lr"], b1=job["b1"], b2=job["b2"],
                          eps=job["eps"], weight_decay=job["weight_decay"],
                          state_dtype=job["opt_dtype"])
    step_cfg = steps.StepConfig(accum=1, grad_dtype=job["grad_dtype"],
                                clip_norm=job["clip_norm"],
                                warmup=job["warmup"],
                                total_steps=job["total_steps"])
    sut = {"model": model,
           "opt": adamw_init(dict(model.named_parameters()), opt_cfg)}
    tracer = ctx.tracer

    def step(i: int) -> torch.Tensor:
        x = batch_tokens(ctx.seed, i, B, S, d.vocab, device)
        batch = {"tokens": x[None, :, :-1], "labels": x[None, :, 1:]}
        with tracer.range("bench.grads"):
            loss, grads = steps.grads_of(model, cfg, batch, step_cfg)
        with tracer.range("bench.update"):
            sut["opt"] = steps.apply_update(
                model, sut["opt"], job["start_step"] + i, grads, cfg,
                opt_cfg, step_cfg)[0]
        return loss

    sut["step"] = step
    return sut


def _read_logits(model, S: int, keep: torch.Tensor, rows: list) -> None:
    """Have ``model.unembed`` hand ``rows`` the logits at the flat
    positions ``keep`` as the next forward pass computes them, chunk by
    chunk (the positions' offsets counted along S); the backward pass's
    recomputation, past S, is not read.  A position whose row the step
    never computed reads NaN, which no limit holds."""
    unembed, seen = model.unembed, [0]
    b_idx, s_idx = keep // S, keep % S

    def reading(h: torch.Tensor) -> torch.Tensor:
        out = unembed(h)
        off, n = seen[0], h.shape[1]
        if off < S:
            sel = (s_idx >= off) & (s_idx < off + n)
            b, s = b_idx[sel].to(out.device), (s_idx[sel] - off).to(
                out.device)
            got = out.detach().new_full((len(b), out.shape[-1]), math.nan)
            ok = b < out.shape[0]      # a row the step left out reads NaN
            got[ok] = out.detach()[b[ok], s[ok]]
            rows.append((keep[sel], got))
            seen[0] = off + n
        return out
    model.unembed = reading


def first_steps(sut: dict, ctx) -> dict:
    """Run the job's first ``check_steps`` steps and read the program's
    numbers: each step's loss, the first step's logits at the drawn
    positions, each leaf's first clipped gradient's norm (from AdamW's
    first moment) and each leaf's change."""
    job, d = ctx.cell.traffic, ctx.dims
    keep = positions(ctx.seed, job["batch"], job["seq_len"],
                     job["check"]["positions"])
    losses, first, rows = [], None, []
    _read_logits(sut["model"], job["seq_len"], keep, rows)
    for i in range(job["check_steps"]):
        losses.append(float(sut["step"](i)))
        if i == 0:
            del sut["model"].unembed
            order = torch.cat([k for k, _ in rows]).argsort()
            sample = torch.cat([r for _, r in rows])[order.to(
                rows[0][1].device)]
        if first is None:
            first = {k: float(torch.linalg.vector_norm(m.float()))
                     / (1 - job["b1"])
                     for k, m in sut["opt"]["mu"].items()}
    params = dict(sut["model"].named_parameters())
    change = {}
    with torch.no_grad():
        for g, leaves in enumerate(program.reference(d).groups(d)):
            for k, v in draw(leaves, ctx.seed, g, ctx.device).items():
                change[k] = float(torch.linalg.vector_norm(
                    params[k].float() - v.float()))
    return {"losses": losses, "sample_logits": sample,
            "first_grad_norms": first, "change_norms": change}


def _free(sut: dict, device) -> None:
    sut.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_steps(ctx) -> dict:
    """The program's numbers of a fresh model over the job's first
    steps, its state freed after."""
    sut = setup(ctx)
    prog = first_steps(sut, ctx)
    _free(sut, ctx.device)
    return prog


def run(ctx) -> dict:
    d, job, device = ctx.dims, ctx.cell.traffic, ctx.device
    B, S = job["batch"], job["seq_len"]
    sut = setup(ctx)
    prog = first_steps(sut, ctx)
    _sync(device)
    clock = time.perf_counter
    setup_s = clock() - ctx.t_process

    tracer, energy, seconds = ctx.tracer, ctx.energy, ctx.seconds
    trace_s = min(job.get("trace_s", seconds), seconds)
    t0 = clock()
    ts = t0 + 0.5 * (seconds - trace_s)
    e0 = energy.joules()
    count, t_last, e_last = 0, t0, e0
    window_losses = []
    i = job["check_steps"]
    while True:
        now = clock()
        if tracer.enabled:
            if not tracer.active and tracer.trace is None and now >= ts:
                tracer.start()
            elif tracer.active and now >= ts + trace_s:
                tracer.stop()
        lv = float(sut["step"](i))
        i += 1
        t = clock()
        if t - t0 > seconds:
            break
        count, t_last, e_last = count + 1, t, energy.joules()
        window_losses.append(lv)
    if tracer.active:
        tracer.stop()
    _sync(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    _free(sut, device)

    ref = program.reference(d).train_steps(
        d, ctx.seed, device,
        [batch_tokens(ctx.seed, i, B, S, d.vocab, device)
         for i in range(job["check_steps"])], job,
        positions=positions(ctx.seed, B, S, job["check"]["positions"]))
    nums = compare(prog, ref)
    checks = {k: {"value": nums[k], "limit": v}
              for k, v in job["check"]["limits"].items()}
    finite = all(math.isfinite(x) for x in window_losses + prog["losses"])
    correct = finite and all(c["value"] <= c["limit"]
                             for c in checks.values())
    return {
        "kind": "train", "dims": d, "traffic": job, "seconds": seconds,
        "setup_s": setup_s, "steps": count, "tokens": count * B * S,
        "span_s": t_last - t0, "energy_j": e_last - e0,
        "attempted": count, "failed": 0 if finite else count,
        "memory_peak_bytes": int(memory_peak), "trace": tracer.trace,
        "correct": correct, "checks": checks, "program": prog,
        "reference": ref, "numbers": nums}
