"""The knee sweep of a serving cell: one process, one model, the cell's
traffic offered at each of several fixed rates in turn, each for a
window of ``--seconds`` after the traffic's lead-in.

    python3 -m bench.tools.sweep --workload mixtral-8x22b.chat \\
        --rates 3.5 4.5 5.5 6.5 --seconds 15 --seed 7 --drain 40

Prints one JSON line a rate: the requests due in the window, those
finished, ``ttft_p95_ms``, ``itl_p95_ms``, the queue left when the
window closed, the decode tick's mean ms and the tokens a second
generated.  A request of the window unfinished at the drain limit counts
+inf, as in a run, so the drain has to outlast the longest output.  The
knee is the highest rate whose ``ttft_p95_ms`` stays under a second
with no queue left when the window closes."""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from ..drivers import serve
from ..harness import Context
from ..model import dims
from ..spec import load_cell
from ..stats import percentile
from ..trace import Tracer
from ..traffic import schedule


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--drain", type=float, default=None,
                    help="the drain limit in seconds (the file's by default)")
    args = ap.parse_args()
    from ..energy import Energy
    cell = load_cell(args.workload)
    device = torch.device("cuda")
    ctx = Context(cell, dims(cell.config), args.seed, args.seconds, device,
                  Tracer(False, device), Energy(), time.perf_counter())
    sut = serve.build(ctx)
    serve.warm(sut, ctx)
    for rate in args.rates:
        tr = copy.deepcopy(cell.traffic)
        tr["arrivals"]["rate"] = rate
        if args.drain is not None:
            tr["drain_s"] = args.drain
        ctx.cell.traffic = tr
        rec = serve.drive(sut, ctx, schedule(tr, args.seed, args.seconds,
                                             ctx.dims.vocab), args.seconds)
        # the next rate starts on a fresh engine over the same model: what
        # is still in flight is dropped, not drained
        sut = serve.build(ctx, sut["model"])
        reqs = rec["requests"]
        ticks = [e[3] for e in rec["events"] if e[0] == "decode_tick"]
        gen = sum(e[2] for e in rec["events"] if e[0] == "decode_tick")
        print(json.dumps({
            "rate": rate, "due": len(reqs),
            "finished": sum(r["done"] for r in reqs),
            "ttft_p95_ms": percentile([r["ttft_s"] for r in reqs], 95) * 1e3,
            "itl_p95_ms": percentile([g for r in reqs for g in r["gaps_s"]],
                                     95) * 1e3,
            "queued_at_end": rec["queued_at_end"],
            "decode_tick_ms": sum(ticks) / max(len(ticks), 1) * 1e3,
            "generated_tok_s": gen / rec["window_s"],
            "joules_per_token": rec["energy_j"] / max(rec["tokens"], 1)}),
            flush=True)


if __name__ == "__main__":
    main()
