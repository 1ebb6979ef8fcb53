"""A cell run with the program's spans on (``repro_torch.trace.spans``),
and what they cost.

    python3 -m bench.tools.spans --workload mixtral-8x22b.chat \\
        --seed 7 --seconds 51
    python3 -m bench.tools.spans --workload rwkv6-7b.train --seed 7 \\
        --seconds 51 --cost 6

Without ``--cost``: the cell as a traced run drives it (its set-up, the
lead-in and the window, the profiler over the traffic's ``trace_s`` in
the middle of the window; none with ``--no-profile``), but with the
program's spans enabled from before the model is built, the profile
read only after the run (the loop waits for the profiler's stop alone,
whose seconds are printed), and no comparison with the reference.
Prints one JSON line: the readings :mod:`bench.program_spans` makes from
the spans — the queue wait's p95 over the window's requests (beside the
run's own ``ttft_p95_ms``), the prefills' padding, the device's idle
share inside the admitting and the backward ranges, the decode
attention's share of a decode tick's device time, the kernels' load —
the device's idle time by harness range and program span, the share of
the idle time in ``bench.tick`` and ``bench.grads`` that a span labels,
each span's count and host seconds in the window, and the program's
counters.  A reading with nothing to read is null (the device's, on the
CPU and without the profiler).

With ``--cost N``: the spans' cost, with no profiler, in turns on one
model: N blocks of decode ticks (serving; every slot live, outputs long
enough that no request ends) or of train steps, off and on alternately,
each block's mean host seconds a tick or a step; prints both sides'
medians and the cost in %."""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from .. import program
from .. import program_spans as ps
from ..drivers import serve, train
from ..harness import Context
from ..model import dims
from ..spec import load_cell
from ..stats import percentile
from ..trace import Trace, Tracer, _collect
from ..traffic import schedule

__all__ = ["SpanTracer", "trace_run", "cost_run"]


class NoMeter:
    def joules(self) -> float:
        return 0.0


class SpanTracer(Tracer):
    """The harness's tracer, which reads its profile only after the run
    (:meth:`collect`), so that the loop waits for nothing but the
    profiler's own stop (``stop_s``), and also keeps the program's
    ranges, the kernels' correlation ids and the launches."""

    program: ps.ProgramTrace | None = None
    stop_s: float | None = None
    _stopped = None

    def stop(self) -> None:
        if not self.active:
            return
        if self._cuda:
            torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        t0 = time.perf_counter()
        self._prof.stop()
        self.stop_s = time.perf_counter() - t0
        self.active = False
        self._stopped, self._prof = self._prof, None
        self.trace = Trace()            # read by collect(), after the run

    def collect(self) -> None:
        if self._stopped is not None:
            self.trace = _collect(self._stopped)
            self.trace.tick_info = self.tick_info
            self.program = ps.collect(self._stopped)
            self._stopped = None


def _spans():
    program.import_program()
    from repro_torch.trace import spans
    return spans


def _context(workload: str, seed: int, seconds: float, device: str,
             sizes: dict | None, traffic: dict | None, profile: bool):
    cell = load_cell(workload)
    cell.traffic.update(traffic or {})
    dev = torch.device(device)
    return Context(cell, dims(cell.config, **(sizes or {})), int(seed),
                   float(seconds), dev, SpanTracer(profile, dev),
                   NoMeter(), time.perf_counter())


def _serve(ctx) -> dict:
    tr = ctx.cell.traffic
    sut = serve.build(ctx)
    arrivals = schedule(tr, ctx.seed, ctx.seconds, ctx.dims.vocab)
    serve.warm(sut, ctx)
    engine, ids = sut["engine"], []

    def submit(req):
        ids.append(engine.__class__.submit(engine, req).request_id)
        return req
    engine.submit = submit              # drive() submits in arrival order
    start = time.perf_counter()
    rec = serve.drive(sut, ctx, arrivals, ctx.seconds)
    serve.free(sut, ctx.device)
    ws = start + tr["lead_in_s"]
    return {"window_ids": [ids[i] for i, a in enumerate(arrivals)
                           if a.segment == "window" and i < len(ids)],
            "window_ns": (ws * 1e9, (ws + ctx.seconds) * 1e9),
            "ttft_p95_ms": percentile([r["ttft_s"] for r in rec["requests"]],
                                      95) * 1e3}


def _train(ctx) -> dict:
    job, tracer = ctx.cell.traffic, ctx.tracer
    sut = train.setup(ctx)
    train.first_steps(sut, ctx)
    trace_s = min(job.get("trace_s", ctx.seconds), ctx.seconds)
    t0 = time.perf_counter()
    ts, i = t0 + 0.5 * (ctx.seconds - trace_s), job["check_steps"]
    while time.perf_counter() - t0 < ctx.seconds:
        now = time.perf_counter()
        if tracer.enabled and not tracer.active and tracer.trace is None \
                and now >= ts:
            tracer.start()
        elif tracer.active and now >= ts + trace_s:
            tracer.stop()
        float(sut["step"](i))
        i += 1
    tracer.stop()
    train._free(sut, ctx.device)
    return {"window_ns": (t0 * 1e9, time.perf_counter() * 1e9)}


def trace_run(workload: str, seed: int, seconds: float, *,
              device: str = "cuda", sizes: dict | None = None,
              traffic: dict | None = None, profile: bool = True) -> dict:
    """One run of ``workload`` with the program's spans on, and the
    profiler over part of its window unless ``profile`` is false; the
    readings (see the module's doc)."""
    spans = _spans()
    spans.reset()
    spans.enable()
    try:
        ctx = _context(workload, seed, seconds, device, sizes, traffic,
                       profile)
        kind = ctx.cell.traffic["driver"]
        got = (_serve if kind == "serve" else _train)(ctx)
    finally:
        spans.disable()
    records, counters = spans.records(), spans.counters()
    spans.reset()
    ctx.tracer.collect()
    tr, pt = ctx.tracer.trace, ctx.tracer.program
    lo, hi = got["window_ns"]
    per_span: dict[str, list] = {}
    for r in records:
        if lo <= r.end_ns < hi:
            n, s = per_span.get(r.name, (0, 0.0))
            per_span[r.name] = [n + 1, s + (r.end_ns - r.start_ns) / 1e9]
    out = {"workload": workload, "seed": seed, "device": str(ctx.device),
           "profiled": profile, "profiler_stop_s": ctx.tracer.stop_s,
           "kernels.load_s": ps.kernel_load_s(records),
           "counters": counters, "spans_in_window": per_span}
    if kind == "serve":
        out["ttft_p95_ms"] = got["ttft_p95_ms"]
        out["engine.queue_wait_p95_ms"] = ps.queue_wait_p95_ms(
            records, got["window_ids"])
        out["engine.prefill_pad_pct"] = ps.prefill_pad_pct(records, lo, hi)
    device = tr is not None and pt is not None and bool(pt.kernels)
    if kind == "serve":
        out["engine.admit_idle_pct"] = ps.idle_pct(
            pt, "engine.admit", tr.window) if device else None
        out["model.decode_attn_pct"] = ps.launched_share_pct(
            pt, "model.attn", "engine.decode", tr.window) if device else None
    else:
        out["train.backward_idle_pct"] = ps.idle_pct(
            pt, "train.backward", tr.window) if device else None
    if device:
        gaps_by_label, labelled = ps.idle_gaps(tr, pt)
        out.update({"idle_gaps": gaps_by_label,
                    "idle_labelled_pct": labelled,
                    "window_s": tr.window_s,
                    "kernels": len(pt.kernels),
                    "launches_matched": sum(k[3] in pt.launches
                                            for k in pt.kernels),
                    "device_annotations": pt.annotations})
    return out


def _blocks(run_block, n: int, spans) -> tuple[list[float], list[float]]:
    """``n`` blocks each way, off and on in turns (the side that goes
    first alternates): each block's mean seconds."""
    off, on = [], []
    for b in range(2 * n):
        first_on = (b // 2) % 2 == 1
        enable = (b % 2 == 0) == first_on
        if enable:
            spans.enable()
        (on if enable else off).append(run_block())
        spans.disable()
        spans.reset()
    return off, on


def cost_run(workload: str, seed: int, n: int, *, device: str = "cuda",
             sizes: dict | None = None, traffic: dict | None = None,
             ticks: int = 25) -> dict:
    """The spans' cost: ``n`` blocks each way, off and on in turns, of
    ``ticks`` decode ticks (serving, every slot live) or of 2 train
    steps, each block's mean host seconds a tick or a step."""
    spans = _spans()
    ctx = _context(workload, seed, 0.0, device, sizes, traffic, False)
    if ctx.cell.traffic["driver"] == "serve":
        from repro_torch.serving import Request
        tr = ctx.cell.traffic
        sut = serve.build(ctx)
        serve.warm(sut, ctx)
        engine = sut["engine"]
        gen = torch.Generator().manual_seed(seed % 2**63)
        n_prompt = tr["prompt"]["median"]
        for _ in range(tr["slots"]):
            engine.submit(Request(
                prompt=torch.randint(1, ctx.dims.vocab, (n_prompt,),
                                     generator=gen).tolist(),
                max_new_tokens=tr["max_len"] - n_prompt - 1))
        engine.tick()                       # admits every slot
        ticks = min(ticks, (tr["max_len"] - n_prompt - 2) // (2 * n))
        events = sut["events"]

        def block() -> float:
            events.clear()
            for _ in range(ticks):
                engine.tick()
            return statistics.mean(e[3] for e in events
                                   if e[0] == "decode_tick")
        off, on = _blocks(block, n, spans)
        serve.free(sut, ctx.device)
        what = "decode tick"
    else:
        sut = train.setup(ctx)
        train.first_steps(sut, ctx)
        step = [ctx.cell.traffic["check_steps"]]

        def block() -> float:
            t0 = time.perf_counter()
            for _ in range(2):
                float(sut["step"](step[0]))
                step[0] += 1
            return (time.perf_counter() - t0) / 2
        off, on = _blocks(block, n, spans)
        train._free(sut, ctx.device)
        what = "train step"
    m_off, m_on = statistics.median(off), statistics.median(on)
    return {"workload": workload, "seed": seed, "device": str(ctx.device),
            "what": what, "off_s": off, "on_s": on, "median_off_s": m_off,
            "median_on_s": m_on, "cost_pct": 100.0 * (m_on / m_off - 1.0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, default=0,
                    help="measure the spans' cost over this many blocks "
                         "each way instead")
    ap.add_argument("--no-profile", action="store_true",
                    help="run the spans without the profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench.tools.spans: no CUDA card")
    card = torch.cuda.get_device_name(0)
    if args.cost:
        out = cost_run(args.workload, args.seed, args.cost)
    else:
        out = trace_run(args.workload, args.seed, args.seconds,
                        profile=not args.no_profile)
    print(json.dumps({"card": card, **out}), flush=True)


if __name__ == "__main__":
    main()
