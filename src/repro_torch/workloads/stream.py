"""STREAM — memory-bandwidth triad, highly parallel and balanced.

Independent ``a ← b + s·c`` block tasks, repeated for ``rounds`` rounds
(block-wise chained like the reference STREAM loop).  Used concurrently
with Gauss-Seidel in the paper's DLB experiments: STREAM soaks up the CPUs
Gauss-Seidel cannot use at the tail of each wavefront step.
"""

from __future__ import annotations

import random

from ..runtime.task import Task, TaskGraph
from .common import memory_time

__all__ = ["build_stream"]


def build_stream(rounds: int = 40, blocks: int = 750,
                 block_elems: int = 131_072, seed: int = 0,
                 with_payload: bool = False) -> TaskGraph:
    rng = random.Random(seed)
    g = TaskGraph()
    nbytes = block_elems * 8.0 * 3

    payload = None
    if with_payload:
        import numpy as np
        b = np.ones(block_elems)
        c = np.ones(block_elems)

        def payload():  # noqa: ANN202
            (b + 2.0 * c).sum()

    for r in range(rounds):
        for blk in range(blocks):
            t = Task("triad", cost=nbytes / 1e6, fn=payload,
                     service_time=memory_time(nbytes, rng, jitter=0.05))
            g.add(t, in_=[("a", blk)], out=[("a", blk)])
    return g
