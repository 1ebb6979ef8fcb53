"""Tiled Cholesky factorization task graph (right-looking variant).

The classic four-kernel DAG over a ``p × p`` grid of ``b × b`` tiles:

    for k in 0..p-1:
        POTRF A[k,k]
        for i in k+1..p-1:          TRSM  A[i,k] ← A[k,k]
        for i in k+1..p-1:          SYRK  A[i,i] ← A[i,k]
        for i,j (k<j<i):            GEMM  A[i,j] ← A[i,k], A[j,k]

Dependencies are expressed through the in/out *data tokens* of
:class:`~repro.runtime.task.TaskGraph` — exactly how OmpSs-2 users write
it.  Cost clauses are the kernel flop counts (the natural ``cost`` filler
an application developer knows): POTRF b³/3, TRSM b³, SYRK b³, GEMM 2 b³.

* **coarse** (paper: 600 instances): p=14, b=2048 → 560 tasks, each
  O(10 ms).  Too few instances per type for timing predictions — the
  paper's count-based fallback engages (Table 2 shows "NA").
* **fine** (paper: 3·10⁶ instances): p scaled so tasks are O(10 µs).
"""

from __future__ import annotations

import random

from ..runtime.task import Task, TaskGraph
from .common import compute_time

__all__ = ["build_cholesky", "cholesky_task_count"]


def cholesky_task_count(p: int) -> int:
    return p + 2 * (p * (p - 1) // 2) + p * (p - 1) * (p - 2) // 6


def build_cholesky(grain: str = "coarse", p: int | None = None,
                   tile: int | None = None, seed: int = 0,
                   with_payload: bool = False) -> TaskGraph:
    if grain == "coarse":
        p = 14 if p is None else p          # 560 tasks ≈ paper's 600
        tile = 2048 if tile is None else tile
    elif grain == "fine":
        p = 40 if p is None else p          # 10 660 tasks (scaled-down 3e6)
        tile = 384 if tile is None else tile  # ~1.6 ms GEMM-unit tasks
    else:
        raise ValueError(f"grain must be coarse|fine, got {grain!r}")
    rng = random.Random(seed)
    g = TaskGraph()
    b3 = float(tile) ** 3

    payload = None
    if with_payload:
        import numpy as np
        n = min(tile, 64)
        mat = np.eye(n) * n + np.ones((n, n))

        def payload():  # noqa: ANN202 - tiny numpy kernel stand-in
            np.linalg.cholesky(mat)

    def add(kind: str, flops: float, in_: list, out: list) -> Task:
        t = Task(kind, cost=flops / 1e6, fn=payload,
                 service_time=compute_time(flops, rng))
        g.add(t, in_=in_, out=out)
        return t

    for k in range(p):
        add("potrf", b3 / 3, in_=[], out=[(k, k)])
        for i in range(k + 1, p):
            add("trsm", b3, in_=[(k, k)], out=[(i, k)])
        for i in range(k + 1, p):
            add("syrk", b3, in_=[(i, k)], out=[(i, i)])
            for j in range(k + 1, i):
                add("gemm", 2 * b3, in_=[(i, k), (j, k)], out=[(i, j)])
    return g
