# Frozen copy of src/repro_torch/workloads/arrivals.py at commit
# e3255417b9b9e53c6324b1f22731d5fa440e6b48, kept byte for byte below this
# header so that the benchmark's arrivals do not move when the program's do.
"""Arrival processes — open-workload release timelines.

The paper's premise is parallelism that *varies over time*, yet a closed
graph submitted at t=0 only exercises the shapes the DAG itself encodes.
An :class:`ArrivalProcess` generates the release times of an open
workload — bursts, lulls, diurnal ramps — so prediction/idle policies are
stress-tested through empty-then-bursty phases (the serving story of the
ROADMAP at task granularity).

All processes are explicitly seeded and wall-clock-free: ``times(n)``
builds a fresh ``random.Random(seed)`` every call, so the same process
object can be reused across runs/policies and always yields the same
timeline (the property the policy benchmarks rely on).
"""

from __future__ import annotations

import math
import random
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Sequence

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from ..runtime.task import Task

__all__ = [
    "ArrivalProcess",
    "FixedTimeline",
    "PoissonArrivals",
    "BurstArrivals",
    "DiurnalArrivals",
    "assign_release_times",
]


class ArrivalProcess(ABC):
    """Generates monotone non-decreasing release times (virtual seconds)."""

    @abstractmethod
    def times(self, n: int) -> list[float]:
        """Release times for ``n`` submissions, sorted ascending."""

    def assign(self, tasks: Iterable["Task"]) -> list[float]:
        """Stamp ``release_time`` onto ``tasks`` in order; returns times."""
        tasks = list(tasks)
        ts = self.times(len(tasks))
        for task, t in zip(tasks, ts):
            task.release_time = t
        return ts


@dataclass(frozen=True)
class FixedTimeline(ArrivalProcess):
    """Explicit release times (e.g. replayed from a recorded trace).

    If fewer times than tasks are given, the last time is repeated (the
    tail arrives together); an empty timeline releases everything at 0.
    """

    release_times: Sequence[float] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        ts = tuple(self.release_times)
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("release_times must be non-decreasing")
        object.__setattr__(self, "release_times", ts)

    def times(self, n: int) -> list[float]:
        ts = list(self.release_times[:n])
        if len(ts) < n:
            last = ts[-1] if ts else 0.0
            ts += [last] * (n - len(ts))
        return ts


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals at ``rate`` tasks/second from ``start``."""

    rate: float
    seed: int = 0
    start: float = 0.0

    def __post_init__(self) -> None:
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")

    def times(self, n: int) -> list[float]:
        rng = random.Random(self.seed)
        t = self.start
        out = []
        for _ in range(n):
            t += rng.expovariate(self.rate)
            out.append(t)
        return out


@dataclass(frozen=True)
class BurstArrivals(ArrivalProcess):
    """On/off process: ``burst_size`` tasks ``spacing`` apart, then an
    off-phase ``gap`` before the next burst — the shape that makes idle
    policies pay resume latency at every burst front and busy policies
    burn energy through every lull."""

    burst_size: int
    gap: float
    spacing: float = 0.0
    seed: int = 0
    jitter: float = 0.0   # ± fraction of gap/spacing, seeded

    def __post_init__(self) -> None:
        if self.burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        if self.gap < 0 or self.spacing < 0:
            raise ValueError("gap and spacing must be >= 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def times(self, n: int) -> list[float]:
        rng = random.Random(self.seed)

        def j(base: float) -> float:
            if self.jitter == 0.0 or base == 0.0:
                return base
            return base * rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)

        out: list[float] = []
        t = 0.0
        in_burst = 0
        for _ in range(n):
            out.append(t)
            in_burst += 1
            if in_burst >= self.burst_size:
                t += j(self.gap)
                in_burst = 0
            else:
                t += j(self.spacing)
        return out


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Nonhomogeneous Poisson with a sinusoidal rate ramp:

        rate(t) = low + (high - low) · (1 + sin(2πt/period - π/2)) / 2

    (starts at the ``low`` trough, peaks at ``period/2``) — the diurnal
    load shape of a user-facing service, via Lewis thinning."""

    period: float
    low_rate: float
    high_rate: float
    seed: int = 0

    def __post_init__(self) -> None:
        if self.period <= 0:
            raise ValueError("period must be > 0")
        if not 0 < self.low_rate <= self.high_rate:
            raise ValueError("need 0 < low_rate <= high_rate")

    def rate_at(self, t: float) -> float:
        phase = (1.0 + math.sin(2.0 * math.pi * t / self.period
                                - math.pi / 2.0)) / 2.0
        return self.low_rate + (self.high_rate - self.low_rate) * phase

    def times(self, n: int) -> list[float]:
        rng = random.Random(self.seed)
        out: list[float] = []
        t = 0.0
        while len(out) < n:
            t += rng.expovariate(self.high_rate)
            if rng.random() <= self.rate_at(t) / self.high_rate:
                out.append(t)
        return out


def assign_release_times(graph, process: ArrivalProcess | None,
                         ) -> list[float]:
    """Stamp a graph's tasks with ``process`` release times (in task
    order) and return them; a ``None`` process clears release times
    (closed-world graph)."""
    if process is None:
        for t in graph.tasks:
            t.release_time = None
        return [0.0] * len(graph.tasks)
    return process.assign(graph.tasks)
