"""Straggler detection — the monitoring infrastructure's per-worker EMAs
applied to step times.

A worker whose EMA'd step time exceeds ``threshold ×`` the median of the
fleet is flagged; the trainer drains it (its data shard is re-assigned —
same mechanics as an elastic shrink) and optionally re-admits it after
``cooldown`` healthy probes.  At 1000+ nodes this is the difference
between fleet throughput tracking the median machine vs. the slowest.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.monitoring import EMA

__all__ = ["StragglerMonitor"]


@dataclass
class StragglerMonitor:
    threshold: float = 1.5
    min_samples: int = 4
    cooldown: int = 3
    _emas: dict[int, EMA] = field(default_factory=dict)
    _cool: dict[int, int] = field(default_factory=dict)
    drained: set[int] = field(default_factory=set)

    def observe(self, worker: int, step_time: float) -> None:
        self._emas.setdefault(worker, EMA(decay=0.3, warmup=2)) \
            .update(step_time)
        if worker in self.drained:
            # probe while drained: count healthy observations
            if not self.is_straggler(worker):
                self._cool[worker] = self._cool.get(worker, 0) + 1
                if self._cool[worker] >= self.cooldown:
                    self.drained.discard(worker)
                    self._cool.pop(worker, None)
            else:
                self._cool[worker] = 0

    def median(self) -> float | None:
        vals = sorted(e.value for e in self._emas.values()
                      if e.reliable(self.min_samples))
        if not vals:
            return None
        return vals[len(vals) // 2]

    def is_straggler(self, worker: int) -> bool:
        med = self.median()
        e = self._emas.get(worker)
        if med is None or e is None or not e.reliable(self.min_samples):
            return False
        return e.value > self.threshold * med

    def mark(self, worker: int) -> None:
        """Externally flag a worker (e.g. a machine-conditions
        ``STRAGGLER`` perturbation observed by the runtime): drained
        immediately, re-admitted through the usual cooldown."""
        self.drained.add(worker)
        self._cool[worker] = 0

    def sweep(self) -> set[int]:
        """Flag-and-drain pass; returns newly drained workers."""
        new = set()
        for w in self._emas:
            if w not in self.drained and self.is_straggler(w):
                self.drained.add(w)
                self._cool[w] = 0
                new.add(w)
        return new
