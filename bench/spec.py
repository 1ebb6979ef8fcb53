"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
checkout's root, each cell's configuration file and traffic file
(``bench/traffic/<traffic>.json``), its driver
(``bench/drivers/<driver>.py``, named by the traffic) and a reader for
each of its metrics (``bench/metrics/<metric>.py``).  A new cell, mix or
metric is new files and an entry in ``BENCHMARK.json``; no file here
changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["ROOT", "BENCH", "Cell", "load_benchmark", "load_cell",
           "reader", "driver"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None,
              root: Path = ROOT) -> Cell:
    bm = benchmark if benchmark is not None else load_benchmark(root)
    work = {w["name"]: w for w in bm["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the cells are "
                       + ", ".join(work))
    w = work[name]
    conf = {c["name"]: c for c in bm["configs"]}[w["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads((Path(root) / "bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name, w["config"], config, w["traffic"], traffic,
                int(w["chips"]),
                [m for m in bm["end_to_end"] if _applies(m, name)],
                [m for m in bm["per_layer"] if _applies(m, name)])


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The reader of one metric: ``bench/metrics/<metric>.py``, whose
    ``read(records)`` returns the metric's value, or None where the
    records hold nothing to read."""
    safe = metric.replace(".", "_").replace("-", "_")
    return _load(Path(root) / "bench" / "metrics" / f"{metric}.py",
                 f"bench_metric_{safe}")


def driver(name: str):
    """The driver of a traffic's kind: ``bench/drivers/<name>.py``."""
    return importlib.import_module(f"bench.drivers.{name}")
