"""Open-loop serving through the program's ``ServingEngine``.

Set-up (:func:`build`, :func:`warm`): the model filled with the seed's
weights, the engine (the traffic's ``slots`` and ``max_len``) and an
``AutoScaler`` over its monitor, as the program's serving launcher
builds them, and a warm-up of the traffic's ``warmup_prompts`` (each
prompt shape the cell uses).  Then the loop (:func:`drive`): every
request whose due time has passed is submitted, the autoscaler's Δ is
read (recorded, not applied, as the program does) and ``engine.tick()``
runs; after each tick the harness stamps every new output token with the
tick's end.  The loop runs the lead-in, the window and then the tail
until every request due in the window is done, or the drain limit
passes.

Records: each window request's time to first token (from its due time)
and gaps between tokens (+inf where it never finished), the engine's
prefill and decode-tick events (``TASK_COMPLETED`` with ``elapsed``),
the card's energy over the window and the tokens processed in it (prompt
tokens prefilled, and tokens generated), and the comparison that decides
``correct`` (:func:`compare`): a sample of the window's finished
requests, drawn from the seed with the longest in it, run through the
plain reference; the widest gap by which a served token's logit lies
below the reference's best.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from .. import program
from ..traffic import schedule

__all__ = ["run", "build", "warm", "drive", "free", "sample", "compare"]


def sample(done: list[dict], seed: int, check: dict) -> list[dict]:
    """The requests to compare: the longest (prompt and served tokens),
    then others in an order drawn from the seed, until ``tokens`` served
    tokens and ``min_requests`` requests are in, at most
    ``max_requests``."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i]["prompt"]) + len(done[i]["served"]))
    order = [longest] + [int(i) for i in np.random.default_rng(
        [int(seed) % 2**63, 4]).permutation(len(done)) if i != longest]
    picked, tokens = [], 0
    for i in order:
        if len(picked) >= check["max_requests"] or (
                tokens >= check["tokens"]
                and len(picked) >= check["min_requests"]):
            break
        picked.append(done[i])
        tokens += len(done[i]["served"])
    return picked


def compare(d, seed: int, device, picked: list[dict],
            control: bool = False) -> dict:
    """How far the served tokens' logits lie below the plain reference's
    best at their positions: the widest gap (``max_logit_gap``), the
    mean gap (``mean_logit_gap``) and the share of tokens that are not
    the reference's first (``tokens_off``); with ``control``, the same
    for the tokens the reference computed in float8 puts first
    (``control_gap``, ``control_mean_gap``, ``control_tokens_off``)."""
    from ..reference.common import control_gaps, logit_gaps
    ref_mod = program.reference(d)
    ref = ref_mod.served_logits(d, seed, device, picked)
    gaps = torch.cat([logit_gaps(x, torch.tensor(r["served"],
                                                 device=x.device))
                      for x, r in zip(ref, picked)])
    out = {"max_logit_gap": float(gaps.max()),
           "mean_logit_gap": float(gaps.mean()),
           "tokens_off": float((gaps > 0).float().mean())}
    if control:
        low = ref_mod.served_logits(d, seed, device, picked, "fp8")
        gaps = torch.cat([control_gaps(x, y) for x, y in zip(ref, low)])
        out.update({"control_gap": float(gaps.max()),
                    "control_mean_gap": float(gaps.mean()),
                    "control_tokens_off": float((gaps > 0).float().mean())})
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(ctx, model: tuple | None = None) -> dict:
    """The system under test: model (or the given ``(cfg, model)``),
    engine, autoscaler, and the list the engine's prefill and
    decode-tick events go to."""
    program.import_program()
    from repro_torch.core.events import EventKind
    from repro_torch.serving import AutoScaler, ServingEngine

    d, tr = ctx.dims, ctx.cell.traffic
    cfg, model = model or program.build_model(d, ctx.cell.config, ctx.seed,
                                              ctx.device)
    engine = ServingEngine(cfg, model, max_batch=tr["slots"],
                           max_len=tr["max_len"], device=ctx.device)
    scaler = AutoScaler(engine.monitor, max_replicas=tr["slots"],
                        policy=tr.get("policy", "prediction"),
                        bus=engine.bus)
    events: list[tuple] = []

    def on_event(e) -> None:
        if e.type_name in ("prefill", "decode_tick"):
            events.append((e.type_name, e.time, e.cost, e.elapsed))

    engine.bus.subscribe(on_event, kinds=[EventKind.TASK_COMPLETED])
    return {"engine": engine, "scaler": scaler, "events": events,
            "model": (cfg, model)}


def warm(sut: dict, ctx) -> None:
    """Serve one short request of each of the traffic's warm-up prompt
    lengths, to the end."""
    from repro_torch.serving import Request
    engine = sut["engine"]
    rng = np.random.default_rng([int(ctx.seed) % 2**63, 3])
    for n in ctx.cell.traffic["warmup_prompts"]:
        engine.submit(Request(prompt=rng.integers(1, ctx.dims.vocab,
                                                  n).tolist(),
                              max_new_tokens=2))
    engine.run_until_drained()
    _sync(ctx.device)
    sut["events"].clear()


def drive(sut: dict, ctx, arrivals: list, seconds: float) -> dict:
    """The open loop over ``arrivals``: lead-in, a window of ``seconds``
    and the tail, until every request due in the window is done or the
    drain limit passes."""
    from repro_torch.serving import Request
    engine, scaler, events = sut["engine"], sut["scaler"], sut["events"]
    tr, tracer, energy = ctx.cell.traffic, ctx.tracer, ctx.energy
    clock = time.perf_counter
    lead = tr["lead_in_s"]
    t0 = clock()
    ws, we = t0 + lead, t0 + lead + seconds
    limit = we + tr["drain_s"]
    trace_s = min(tr.get("trace_s", seconds), seconds)
    ts = ws + 0.5 * (seconds - trace_s)
    reqs: list = [None] * len(arrivals)
    stamps: list[list[float]] = [[] for _ in arrivals]
    window = [i for i, a in enumerate(arrivals) if a.segment == "window"]
    waiting = set(window)
    inflight: dict[int, object] = {}
    deltas: list[int] = []
    e_start = e_end = None
    nxt, pairs = 0, 0
    while True:
        now = clock()
        if e_start is None and now >= ws:
            e_start = (now, energy.joules())
        if e_end is None and now >= we:
            e_end = (now, energy.joules())
            queued_at_end = len(engine.queue)
        if tracer.enabled:
            if not tracer.active and tracer.trace is None and now >= ts:
                tracer.start()
            elif tracer.active and now >= ts + trace_s:
                tracer.stop()
        if (now >= we and not waiting) or now >= limit:
            break
        while nxt < len(arrivals) and t0 + arrivals[nxt].due <= now:
            a = arrivals[nxt]
            reqs[nxt] = engine.submit(Request(prompt=a.prompt,
                                              max_new_tokens=a.max_new))
            inflight[nxt] = reqs[nxt]
            nxt += 1
        if not engine.load:
            due = t0 + arrivals[nxt].due if nxt < len(arrivals) else limit
            with tracer.range("bench.wait"):
                time.sleep(min(max(due - clock(), 0.0), 0.002))
            continue
        deltas.append(scaler.target(
            len(engine.queue), sum(r is not None for r in engine.active)))
        before = engine.prefills
        with tracer.range("bench.tick"):
            engine.tick()
        end = clock()
        if tracer.active:
            tracer.tick_info.append({"admitted": engine.prefills - before})
        counting = e_start is not None and e_end is None
        for i, r in list(inflight.items()):
            have = len(stamps[i])
            new = len(r.output) - have
            if new > 0:
                stamps[i].extend([end] * new)
                if counting:
                    # each decoded token's query-key pairs in a layer
                    L = len(r.prompt)
                    pairs += sum(L + j for j in range(max(have, 1),
                                                      have + new))
            if r.done:
                del inflight[i]
                waiting.discard(i)
    if tracer.active:
        tracer.stop()
    _sync(ctx.device)
    if e_end is None:
        e_end = (clock(), energy.joules())
        queued_at_end = len(engine.queue)

    requests, done = [], []
    for i in window:
        a, r = arrivals[i], reqs[i]
        due = t0 + a.due
        ok = r is not None and r.done and len(stamps[i]) == len(r.output)
        requests.append({
            "due_s": a.due - lead, "prompt_len": len(a.prompt),
            "max_new": a.max_new, "done": ok,
            "ttft_s": stamps[i][0] - due if ok else math.inf,
            "gaps_s": (np.diff(stamps[i]).tolist() if ok else [math.inf]),
            "stamps_s": [s - due for s in stamps[i]]})
        if ok:
            done.append({"prompt": list(a.prompt),
                         "served": list(r.output)})
    in_window = [e for e in events if e_start[0] <= e[1] < e_end[0]]
    events.clear()
    tokens = sum(c + 1 for n, _, c, _ in in_window if n == "prefill") \
        + sum(c for n, _, c, _ in in_window if n == "decode_tick")
    return {"requests": requests, "done": done, "events": in_window,
            "attempted": len(window),
            "failed": sum(not r["done"] for r in requests),
            "window_s": e_end[0] - e_start[0],
            "energy_j": e_end[1] - e_start[1], "tokens": tokens,
            "decode_pairs": pairs, "deltas": deltas,
            "queued_at_end": queued_at_end}


def free(sut: dict, device: torch.device) -> None:
    """Drop the system under test and return its memory to the card."""
    sut.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    d, tr, device = ctx.dims, ctx.cell.traffic, ctx.device
    sut = build(ctx)
    arrivals = schedule(tr, ctx.seed, ctx.seconds, d.vocab)
    warm(sut, ctx)
    setup_s = time.perf_counter() - ctx.t_process
    rec = drive(sut, ctx, arrivals, ctx.seconds)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    free(sut, device)

    check = tr["check"]
    picked = sample(rec["done"], ctx.seed, check)
    checks = {}
    if picked:
        got = compare(d, ctx.seed, device, picked)
        checks = {k: {"value": got[k], "limit": v}
                  for k, v in check["limits"].items()}
    correct = (bool(picked) and rec["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    rec.update({
        "kind": "serve", "dims": d, "traffic": tr, "seconds": ctx.seconds,
        "setup_s": setup_s, "memory_peak_bytes": int(memory_peak),
        "trace": ctx.tracer.trace, "correct": correct, "checks": checks,
        "compared_tokens": sum(len(r["served"]) for r in picked)})
    return rec
