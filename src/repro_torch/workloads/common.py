"""Shared helpers for workload builders.

Service times derive from per-task flop/byte counts over nominal per-core
rates; multiplicative jitter (seeded, deterministic) models the run-to-run
variability the paper's EMA smoothing is designed to absorb.
"""

from __future__ import annotations

import random

#: nominal per-core compute rate for compute-bound tasks (MN4 Skylake-ish)
CORE_GFLOPS = 35.0
#: nominal per-core memory bandwidth for memory-bound tasks
CORE_GBS = 5.0


def compute_time(flops: float, rng: random.Random,
                 jitter: float = 0.15) -> float:
    """Seconds for a compute-bound task of ``flops`` on one core."""
    base = flops / (CORE_GFLOPS * 1e9)
    return base * rng.uniform(1.0 - jitter, 1.0 + jitter)


def memory_time(bytes_moved: float, rng: random.Random,
                jitter: float = 0.2) -> float:
    """Seconds for a memory-bound task moving ``bytes_moved``."""
    base = bytes_moved / (CORE_GBS * 1e9)
    return base * rng.uniform(1.0 - jitter, 1.0 + jitter)
