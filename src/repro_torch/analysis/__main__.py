"""``python -m repro.analysis`` — run the static passes over the repo.

With no arguments, analyzes the whole ``repro`` package.  Explicit file
or directory arguments narrow the target (used by the test fixtures).
Exit status is nonzero iff any finding survives suppression — this is
the required CI ``analysis`` job.

The lock/field pass runs on every target file; the determinism lint
only on files in its scope: ``runtime/`` (except ``thread_executor.py``,
whose real threads legitimately use the real clock), ``trace/``,
``workloads/``, ``serving/`` (the SLO/overload layer must be replayable
— clocks are injected, backoff jitter is seeded), ``core/conditions.py``
(the machine-conditions timeline feeds the simulator and the trace
round trip), and any module whose name mentions ``sim`` or ``replay``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .determinism import run_determinism
from .lockcheck import run_lockcheck
from .report import Finding, render_json, render_text

_DETERMINISM_DIRS = {"trace", "workloads", "serving"}


def determinism_scope(path: Path) -> bool:
    if path.name == "thread_executor.py":
        return False
    # the machine-conditions timeline feeds the simulator and the trace
    # round trip, so it must be as wall-clock-free as they are
    if path.name == "conditions.py":
        return True
    parts = set(path.parts)
    if parts & _DETERMINISM_DIRS or "runtime" in parts:
        return True
    stem = path.stem
    return "sim" in stem or "replay" in stem


def discover(targets: list[str]) -> list[Path]:
    files: list[Path] = []
    for t in targets:
        p = Path(t)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    # the analyzer does not analyze itself: its fixtures-by-design
    # (witness lock wrappers, decorator machinery) are not runtime code
    pkg = Path(__file__).resolve().parent
    return [f for f in files
            if pkg not in f.resolve().parents and f.resolve() != pkg]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro.analysis",
        description="concurrency & determinism static analysis")
    parser.add_argument("targets", nargs="*",
                        help="files or directories (default: the repro "
                             "package)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    args = parser.parse_args(argv)

    targets = args.targets or [str(Path(__file__).resolve().parents[1])]
    files = discover(targets)
    sources: list[tuple[str, str]] = []
    findings: list[Finding] = []
    for f in files:
        try:
            sources.append((str(f), f.read_text(encoding="utf-8")))
        except (OSError, UnicodeDecodeError) as exc:
            findings.append(Finding(rule="unreadable", path=str(f), line=1,
                                    message=f"cannot analyze: {exc}"))

    lock_findings, n = run_lockcheck(sources)
    findings.extend(lock_findings)
    det_files = [(p, s) for p, s in sources if determinism_scope(Path(p))]
    det_findings, _ = run_determinism(det_files)
    findings.extend(det_findings)

    out = (render_json(findings, n) if args.json
           else render_text(findings, n))
    print(out)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
