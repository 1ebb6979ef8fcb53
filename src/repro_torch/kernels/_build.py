"""Build a ``csrc/*.cu`` source into a shared library and load it.

Every kernel of the port is compiled the same way: ``nvcc`` for
``sm_90a`` into a shared library with a plain C entry point, at first
use, into ``build/`` at the repository root, named by the source's
content hash, and loaded with ``ctypes``.  ``ptxas -v`` runs with every
build; its report (registers, shared memory, spills) is kept beside the
library as ``<name>.log``; :func:`sass_counts` counts an opcode in each
kernel's machine code with ``cuobjdump``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "function", "ptxas_report", "sass_counts"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

_fns: dict[tuple[Path, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return found


def build(source: Path) -> Path:
    """Compile ``source`` (once per source content) and return the shared
    library's path.

    Safe when several processes build at once: each compiles to its own
    temporary name and ``os.replace`` publishes the result atomically.
    """
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log = lib.with_suffix(".log")
    log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    log_tmp.write_text(proc.stdout + proc.stderr)
    os.replace(log_tmp, log)
    os.replace(tmp, lib)
    return lib


def function(source: Path, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library built from ``source``,
    returning an ``int`` (a ``cudaError_t``); loaded once per process."""
    key = (source, name)
    if key not in _fns:
        fn = getattr(ctypes.CDLL(str(build(source))), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def ptxas_report(source: Path) -> list[str]:
    """What ``ptxas -v`` said of each kernel in ``source``'s library:
    one line per function with its registers and its spill bytes."""
    log = build(source).with_suffix(".log")
    out, entry, spills = [], None, "spills not reported"
    for line in log.read_text().splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line and entry is not None:
            spills = line
        elif line.startswith("ptxas info") and "Used" in line \
                and entry is not None:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; "
                       f"{spills}")
            entry = None
    return out


def sass_counts(source: Path, opcode: str) -> dict[str, int]:
    """How many instructions of ``opcode`` (e.g. ``HGMMA``, the tensor
    cores' warpgroup product) each kernel in ``source``'s library holds,
    from ``cuobjdump -sass`` beside ``nvcc``."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        raise RuntimeError(f"{cuobjdump} not found: it ships with nvcc")
    proc = subprocess.run([str(cuobjdump), "-sass", str(build(source))],
                          capture_output=True, text=True, check=True)
    counts: dict[str, int] = {}
    entry = None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            entry = line.split(":", 1)[1].strip()
            counts[entry] = 0
        elif entry is not None and f" {opcode}." in line:
            counts[entry] += 1
    return counts
