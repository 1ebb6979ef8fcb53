"""Gauss-Seidel heat diffusion with a barrier per time step.

The OmpSs-2 version in the paper inserts a barrier after each time step to
match the OpenMP structure — "this produces load imbalance but makes it an
ideal candidate to be combined with STREAM".  Within a step the blocks
form a wavefront (block (i,j) depends on (i-1,j) and (i,j-1) of the same
step), so parallelism ramps 1 → min(bi,bj) → 1: the tail of each step
leaves most CPUs without work.

Paper Table 2: 25 600 instances — e.g. 100 steps × 16×16 blocks.
"""

from __future__ import annotations

import random

from ..runtime.task import Task, TaskGraph
from .common import memory_time

__all__ = ["build_gauss_seidel"]


def build_gauss_seidel(steps: int = 100, bi: int = 16, bj: int = 16,
                       block_elems: int = 1024 * 1024, seed: int = 0,
                       with_payload: bool = False) -> TaskGraph:
    rng = random.Random(seed)
    g = TaskGraph()
    nbytes = block_elems * 8.0 * 2          # read + write the block

    payload = None
    if with_payload:
        import numpy as np
        a = np.ones(block_elems // 64)

        def payload():  # noqa: ANN202
            (a * 0.25).sum()

    prev_barrier: Task | None = None
    for s in range(steps):
        wave: list[Task] = []
        for i in range(bi):
            for j in range(bj):
                t = Task("gs_block", cost=nbytes / 1e6, fn=payload,
                         service_time=memory_time(nbytes, rng))
                deps_in = [("blk", i - 1, j)] if i > 0 else []
                if j > 0:
                    deps_in.append(("blk", i, j - 1))
                if prev_barrier is not None:
                    t.depends_on(prev_barrier)
                g.add(t, in_=deps_in, out=[("blk", i, j)])
                wave.append(t)
        barrier = Task("barrier", cost=0.01, service_time=5e-7,
                       fn=(lambda: None) if with_payload else None)
        for t in wave:
            barrier.depends_on(t)
        g.add(barrier, out=[("blk", i, j) for i in range(bi)
                            for j in range(bj)])
        prev_barrier = barrier
    return g
