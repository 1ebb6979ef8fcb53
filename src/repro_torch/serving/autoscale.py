"""Prediction-based replica autoscaling — Algorithm 1 applied to serving.

A serving deployment holds up to ``max_replicas`` engine replicas.  The
monitoring infrastructure aggregates request workloads (cost = prompt +
expected new tokens, normalized by measured service times into unitary
costs α) and a :class:`~repro.core.governor.ResourceGovernor` — built from
the same :class:`~repro.core.governor.GovernorSpec` that drives the
executors — computes the optimal replica count Δ at the prediction rate,
the serving twin of the paper's CPU manager:

* **busy**   — all replicas always hot (max throughput, max energy)
* **idle**   — replicas park the moment they have no work
* **prediction** — replicas track Δ

The target decision is made by the registered :class:`Policy` object
(``Policy.target``), not by branching on policy names, so any registered
policy works here unchanged.

Replica lifecycle costs (model load / cache warmup) play the role of the
paper's thread resume latency; the EDP trade-off reproduces Fig. 4's
story at serving granularity (``benchmarks/bench_serving.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.events import EventBus
from ..core.governor import GovernorSpec, ResourceGovernor
from ..core.monitoring import TaskMonitor
from ..core.prediction import PredictionConfig

__all__ = ["AutoScaler"]


@dataclass
class AutoScaler:
    monitor: TaskMonitor
    max_replicas: int
    policy: str = "prediction"          # any registered policy name
    min_replicas: int = 1
    rate_s: float = 0.05
    spec: GovernorSpec | None = None    # overrides the kwargs above
    #: runtime event bus (e.g. ``ServingEngine.bus``) — Δ decisions are
    #: published as PREDICTION events so serving traces record them
    bus: EventBus | None = None

    def __post_init__(self) -> None:
        if self.spec is None:
            self.spec = GovernorSpec(
                resources=self.max_replicas, policy=self.policy,
                min_resources=self.min_replicas,
                prediction=PredictionConfig(rate_s=self.rate_s),
                monitoring=True)
        else:
            # an explicit spec wins: keep the public fields in sync
            self.max_replicas = self.spec.resources
            self.min_replicas = self.spec.min_resources
            self.policy = self.spec.policy
            self.rate_s = self.spec.prediction.rate_s
        self.governor = ResourceGovernor(self.spec, monitor=self.monitor,
                                         bus=self.bus)
        self.predictor = self.governor.predictor

    def target(self, queued: int, active: int) -> int:
        """Replicas to keep hot, given current queue/active request counts."""
        return self.governor.target(queued, active)
