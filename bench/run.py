"""The benchmark's command: one run of one cell on the card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--out DIR]

Prints the result as one JSON object on the last line of standard
output, and each number compared with its limit as the last lines of
standard error.  Exits with 2, printing no result, without a CUDA card
(or with fewer than the cell asks for), and with 3 if a module of JAX or
of the JAX package is loaded once the window has closed.  Every build
and kernel cache stays in ``build/`` inside the checkout, and the run's
Δ trace and per-request times go to ``--out`` (``bench_out/``)."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=str(ROOT / "bench_out"))
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from bench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench.energy import Energy
    from bench.harness import FORBIDDEN, run
    print(f"bench: {_card_line()}", file=sys.stderr)
    uuid = getattr(torch.cuda.get_device_properties(0), "uuid", None)
    if uuid is not None and not str(uuid).startswith("GPU-"):
        uuid = f"GPU-{uuid}"
    energy = Energy(None if uuid is None else str(uuid))
    print(f"bench: energy from {energy.source}", file=sys.stderr)
    try:
        line = run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", energy=energy, out=Path(args.out),
                   t_process=T_PROCESS, kind=torch.cuda.get_device_name(0))
    finally:
        energy.close()
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"bench: {loaded} loaded in the run's process", file=sys.stderr)
        return 3
    what = "requests due" if cell.traffic["driver"] == "serve" else "steps"
    print(f"bench: {line['attempted']} {what} in the window, "
          f"{line['failed']} failed", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
