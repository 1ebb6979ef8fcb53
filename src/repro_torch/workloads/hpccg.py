"""HPCCG — High Performance Computing Conjugate Gradients mini-app.

CG over a 3D chimney domain decomposed into row blocks.  Each iteration:

    SpMV   q ← A·p        (one task per row block; memory-bound)
    DOT    α ← pᵀq        (block partials + one reduction task)
    AXPY   x ← x + αp ; r ← r − αq   (one task per block)
    DOT    β ← rᵀr        (block partials + reduction)
    AXPY   p ← r + βp

The reductions serialize the iteration (the low-parallelism phases the
prediction policy exploits).  Paper Table 2 reports 15 000 instances: 75
iterations × 40 blocks × (2 SpMV-ish + 2 axpy + 1 partial) ≈ 15 k.
"""

from __future__ import annotations

import random

from ..runtime.task import Task, TaskGraph
from .common import memory_time

__all__ = ["build_hpccg"]


def build_hpccg(iterations: int = 75, blocks: int = 40,
                rows_per_block: int = 16_384, seed: int = 0,
                with_payload: bool = False) -> TaskGraph:
    rng = random.Random(seed)
    g = TaskGraph()
    nnz_per_row = 27                      # 3D 27-point stencil
    spmv_bytes = rows_per_block * nnz_per_row * 12.0   # val + col idx
    vec_bytes = rows_per_block * 8.0

    payload = None
    if with_payload:
        import numpy as np
        a = np.ones(4096)

        def payload():  # noqa: ANN202
            (a * 1.0001).sum()

    def task(kind: str, nbytes: float, in_: list, out: list) -> Task:
        t = Task(kind, cost=nbytes / 1e6, fn=payload,
                 service_time=memory_time(nbytes, rng))
        return g.add(t, in_=in_, out=out)

    for it in range(iterations):
        for b in range(blocks):
            # SpMV reads the halo of p (dep on previous p-update barrier)
            task("spmv", spmv_bytes, in_=[("p", b)], out=[("q", b)])
        for b in range(blocks):
            task("dot_partial", 2 * vec_bytes,
                 in_=[("p", b), ("q", b)], out=[("pq", b)])
        task("reduce", blocks * 16.0,
             in_=[("pq", b) for b in range(blocks)], out=["alpha"])
        for b in range(blocks):
            task("axpy", 3 * vec_bytes,
                 in_=["alpha", ("q", b)], out=[("x", b), ("r", b)])
        for b in range(blocks):
            task("dot_partial", vec_bytes, in_=[("r", b)], out=[("rr", b)])
        task("reduce", blocks * 16.0,
             in_=[("rr", b) for b in range(blocks)], out=["beta"])
        for b in range(blocks):
            task("axpy", 2 * vec_bytes,
                 in_=["beta", ("r", b)], out=[("p", b)])
    return g
