"""One run of one cell: the driver named by the cell's traffic, then each
of the cell's metrics read by its own reader, then the result line.

:func:`run` is the whole run without the look for a card, so that the
tests can drive it on the CPU at small sizes; ``bench/run.py`` is the
command, which looks for the card first."""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import spec
from .model import Dims, dims
from .trace import Tracer

__all__ = ["Context", "run", "result_line", "FORBIDDEN"]

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    cell: spec.Cell
    dims: Dims
    seed: int
    seconds: float
    device: torch.device
    tracer: Tracer
    energy: object          # .joules()
    t_process: float


def _write(out: Path | None, cell: str, seed: int, trace: bool,
           rec: dict) -> None:
    """The run's Δ trace and per-request times, beside its result."""
    if out is None:
        return
    path = Path(out) / cell
    path.mkdir(parents=True, exist_ok=True)
    body = {"deltas": rec.get("deltas", []),
            "requests": rec.get("requests", []),
            "checks": rec.get("checks", {}),
            "numbers": rec.get("numbers", {})}
    (path / f"seed{seed}-trace{int(trace)}.json").write_text(
        json.dumps(body, default=lambda x: None))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", energy=None, out: Path | None = None,
        root: Path = spec.ROOT, t_process: float | None = None,
        sizes: dict | None = None, traffic: dict | None = None,
        kind: str | None = None) -> dict:
    """Run ``workload`` once and return the result line's object.
    ``sizes`` replaces published keys of the configuration and
    ``traffic`` keys of the traffic file (the tests' small runs);
    ``energy`` is the card's meter (``.joules()``)."""
    cell = spec.load_cell(workload, root=root)
    cell.traffic.update(traffic or {})
    d = dims(cell.config, **(sizes or {}))
    device = torch.device(device)
    ctx = Context(cell, d, int(seed), float(seconds), device,
                  Tracer(trace, device), energy,
                  time.perf_counter() if t_process is None else t_process)
    rec = spec.driver(cell.traffic["driver"]).run(ctx)
    _write(out, workload, seed, trace, rec)
    return result_line(cell, rec, trace, device, kind)


def result_line(cell: spec.Cell, rec: dict, trace: bool,
                device: torch.device, kind: str | None) -> dict:
    metrics, correct = {}, rec["correct"]
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"]).read(rec)
        if value is None:
            continue
        if not math.isfinite(value):
            correct = False
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind or str(device), "count": cell.chips,
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = {"correct": bool(correct), "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = rec["checks"]
    return line
