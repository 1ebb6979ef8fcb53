"""One-card dry-run: the memory and FLOPs of every (arch × shape) cell on
one H100, without the card — the port of :mod:`repro.launch.dryrun`.

The reference lowers and compiles each cell against 256- and 512-chip
TPU meshes and reads XLA's memory and cost analyses.  The port builds
each cell on the meta device (:func:`repro_torch.launch.cells.build_cell`)
and runs its step there under :func:`repro_torch.launch.roofline.count_step`:
nothing is allocated or computed, and each operator is counted as it
would run on the card.  A record a cell:

* the arguments' bytes by role (parameters, optimizer state, batch,
  cache), exact ``nbytes`` sums;
* the peak of the bytes alive at once over the step, and whether it
  fits one card (``HW.HBM_BYTES``);
* the FLOPs counted, ``model_flops`` and their ratio, the HBM bytes
  counted, and the roofline terms;
* the seconds the build and the meta run took.

Records go to ``build/dryrun/<arch>_<shape>.json`` unless ``--no-save``.

Usage::

    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--no-save] [--jobs N]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import pathlib
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from ..configs import ARCH_IDS, SHAPES, ShapeSpec
from .cells import SkipCell, TrainKnobs, build_cell
from .mesh import HW
from .roofline import count_step, model_flops, roofline_terms

__all__ = ["run_cell", "run_cells", "row", "main", "ART_DIR"]

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_cell(arch: str, shape: str | ShapeSpec, *,
             cfg_overrides: dict | None = None,
             rules_overrides: dict | None = None,
             knobs: TrainKnobs | None = None, smoke: bool = False,
             save: bool = True, verbose: bool = True,
             tag: str = "") -> dict:
    """Build the cell on meta, run its step once under the counters and
    return (and, with ``save``, write) its record.  Raises
    :class:`~repro_torch.launch.cells.SkipCell` for a cell that is not
    runnable."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, cfg_overrides, rules_overrides, knobs,
                      smoke=smoke)
    groups = cell.argument_tensors()
    count = count_step(cell.fn, cell.args,
                       [t for ts in groups.values() for t in ts])
    build_s = time.perf_counter() - t0
    mf = model_flops(cell.cfg, cell.shape, cell.kind)
    terms = roofline_terms(count, 1, mf)
    mem = {f"{role}_bytes": _nbytes(ts) for role, ts in groups.items()}
    mem["argument_bytes"] = count.argument_bytes
    mem["peak_bytes"] = count.peak_bytes
    fits = count.peak_bytes <= HW.HBM_BYTES
    record = {
        "arch": arch,
        "shape": cell.shape.name,
        "seq_len": cell.shape.seq_len,
        "global_batch": cell.shape.global_batch,
        "mesh": "1 card",
        "n_chips": 1,
        "kind": cell.kind,
        "remat": cell.cfg.remat,
        "notes": cell.static_notes,
        "memory": mem,
        "fits_80GB": bool(fits),
        "flops": count.flops,
        "model_flops": mf,
        "hbm_bytes": count.hbm_bytes,
        "terms": terms.to_json(),
        "build_s": round(build_s, 2),
        "tag": tag,
    }
    if verbose:
        print(row(record))
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        name = f"{arch}_{cell.shape.name}{suffix}.json".replace("/", "-")
        (ART_DIR / name).write_text(json.dumps(record, indent=1))
    return record


def row(record: dict) -> str:
    """One line of a record: kind, argument and peak GB, whether it fits
    one card, the FLOPs counted, ``model_flops``, their ratio, the
    dominant term and the seconds the cell took."""
    mem, terms = record["memory"], record["terms"]
    return (f"[dryrun] {record['arch']:26s} {record['shape']:12s} "
            f"{record['kind']:7s} args {mem['argument_bytes'] / 1e9:9.2f} "
            f"GB, peak {mem['peak_bytes'] / 1e9:9.2f} GB "
            f"({'fits' if record['fits_80GB'] else 'OVER'} 80 GB), "
            f"{record['flops'] / 1e12:12.2f} TFLOPs counted, model "
            f"{record['model_flops'] / 1e12:12.2f}, useful "
            f"{terms['useful_ratio']:.3f}, {terms['dominant']}-bound "
            f"({terms['compute_s'] * 1e3:.2f} ms compute, "
            f"{terms['memory_s'] * 1e3:.2f} ms memory), built in "
            f"{record['build_s']:.2f} s")


def _one(cell: tuple[str, str], save: bool) -> tuple[str, object]:
    arch, shape = cell
    try:
        return "ok", run_cell(arch, shape, save=save, verbose=False)
    except SkipCell as e:
        return "skip", str(e)
    except Exception:
        return "fail", traceback.format_exc()


def run_cells(cells: list[tuple[str, str]], *, save: bool = True,
              jobs: int = 1
              ) -> tuple[list[dict], list[tuple], list[tuple]]:
    """:func:`run_cell` over ``cells``, in ``jobs`` worker processes
    (started with ``spawn``, and all ended on return) where ``jobs`` is
    above 1; prints a row a cell in ``cells``' order and returns
    (records, skips as (arch, shape, reason), failures as (arch,
    shape))."""
    if jobs > 1:
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            # the train cells first: they take the longest
            order = sorted(range(len(cells)), key=lambda i: getattr(
                SHAPES.get(cells[i][1]), "kind", "") != "train")
            futures = {i: ex.submit(_one, cells[i], save) for i in order}
            results = [futures[i].result() for i in range(len(cells))]
    else:
        results = [_one(cell, save) for cell in cells]
    records, skips, failures = [], [], []
    for (arch, shape), (status, out) in zip(cells, results):
        if status == "ok":
            records.append(out)
            print(row(out))
        elif status == "skip":
            skips.append((arch, shape, out))
            print(f"[skip] {arch} × {shape}: {out}")
        else:
            failures.append((arch, shape))
            print(f"[FAIL] {arch} × {shape}\n{out}")
    print(f"\n{len(records)} ok, {len(skips)} skipped, "
          f"{len(failures)} FAILED")
    return records, skips, failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the cells (default 1)")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    _, _, failures = run_cells(cells, save=not args.no_save,
                               jobs=args.jobs)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
