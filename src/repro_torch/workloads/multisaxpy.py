"""MultiSAXPY — repeated blocked SAXPY (BLAS-1) generations.

Each generation runs one SAXPY task per block followed by a ``taskwait``
(as in the OmpSs-2 reference benchmark), so parallelism ramps down to zero
at every generation boundary — the fine-grained churn the paper's policies
differ on.  Fine-grained: many small blocks (paper: 10⁵ instances);
coarse: fewer, larger blocks (paper: 2·10⁴).
"""

from __future__ import annotations

import random

from ..runtime.task import Task, TaskGraph
from .common import memory_time

__all__ = ["build_multisaxpy"]


def build_multisaxpy(grain: str = "coarse", generations: int | None = None,
                     blocks: int | None = None,
                     block_elems: int | None = None, seed: int = 0,
                     with_payload: bool = False) -> TaskGraph:
    if grain == "fine":
        generations = 250 if generations is None else generations
        blocks = 400 if blocks is None else blocks          # 100 000 tasks
        block_elems = 409_600 if block_elems is None else block_elems  # ~1 ms
    elif grain == "coarse":
        generations = 50 if generations is None else generations
        blocks = 400 if blocks is None else blocks          # 20 000 tasks
        block_elems = 2_097_152 if block_elems is None else block_elems  # ~5 ms
    else:
        raise ValueError(f"grain must be coarse|fine, got {grain!r}")
    rng = random.Random(seed)
    g = TaskGraph()
    nbytes = block_elems * 4.0 * 3          # y ← a·x + y (2 reads, 1 write)

    payload = None
    if with_payload:
        import numpy as np
        x = np.ones(block_elems, dtype=np.float32)
        y = np.zeros(block_elems, dtype=np.float32)

        def payload():  # noqa: ANN202
            y.__iadd__(2.0 * x)

    prev_wait: Task | None = None
    for gen in range(generations):
        wave: list[Task] = []
        for b in range(blocks):
            t = Task("saxpy", cost=nbytes / 1e6, fn=payload,
                     service_time=memory_time(nbytes, rng))
            if prev_wait is not None:
                t.depends_on(prev_wait)
            g.add(t, in_=[("y", b)], out=[("y", b)])
            wave.append(t)
        taskwait = Task("taskwait", cost=0.01, service_time=5e-7,
                        fn=(lambda: None) if with_payload else None)
        for t in wave:
            taskwait.depends_on(t)
        g.add(taskwait)
        prev_wait = taskwait
    return g
