"""Elastic data parallelism driven by the paper's predictor.

The controller treats DP replicas the way the paper's CPU manager treats
cores: the *workload* is the backlog of pending global batches (each a
task with cost = tokens), α is the EMA'd per-replica step time, and
Algorithm 1 yields the replica count Δ for the next window.  Alg. 2's
poll/add hooks become ``on_step_done`` / ``on_batches_queued``.

Node failures are forced shrinks: the failed replica leaves the set and
the global batch is re-balanced over survivors (batch size per replica
grows; the gradient all-reduce group shrinks).  Growth re-admits
replicas up to Δ.  ``tests/test_elastic.py`` exercises shrink/regrow and
loss continuity across a failure.

Fault tolerance wiring (machine conditions): the controller can carry a
:class:`~repro.train.straggler.StragglerMonitor` (per-replica step-time
EMAs; flagged replicas are drained out of the active set and re-admitted
after the cooldown) and a
:class:`~repro.checkpoint.CheckpointManager`.  A ``CORE_FAIL``
perturbation mid-run (:meth:`apply_perturbation` /
:meth:`recover_from_failure`) shrinks to the survivors and rolls the
training state back to the latest checkpoint, so the trainer completes
with the surviving workers instead of dying with the core.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from ..core.conditions import Perturbation, PerturbationKind
from ..core.governor import GovernorSpec, ResourceGovernor
from ..core.prediction import PredictionConfig
from .straggler import StragglerMonitor

if TYPE_CHECKING:
    from ..checkpoint import CheckpointManager

__all__ = ["ElasticController", "ReplicaSet"]


@dataclass
class ReplicaSet:
    """Active replica ids + the batch split they own."""

    replicas: list[int]
    global_batch: int

    def shards(self) -> dict[int, int]:
        n = len(self.replicas)
        base = self.global_batch // n
        extra = self.global_batch % n
        return {r: base + (1 if i < extra else 0)
                for i, r in enumerate(self.replicas)}


class ElasticController:
    def __init__(self, max_replicas: int, global_batch: int,
                 policy: str = "prediction", rate_s: float = 1.0,
                 min_replicas: int = 1,
                 spec: GovernorSpec | None = None,
                 straggler: StragglerMonitor | None = None,
                 checkpoint: "CheckpointManager | None" = None) -> None:
        if spec is None:
            spec = GovernorSpec(
                resources=max_replicas, policy=policy,
                min_resources=min_replicas,
                prediction=PredictionConfig(rate_s=rate_s),
                monitoring=True)
        self.spec = spec
        self.max_replicas = spec.resources
        self.min_replicas = max(spec.min_resources, 1)
        self.policy = spec.policy
        self.governor = ResourceGovernor(spec)
        self.monitor = self.governor.monitor
        self.predictor = self.governor.predictor
        self.set = ReplicaSet(list(range(self.max_replicas)), global_batch)
        self.failed: set[int] = set()
        self._task_seq = 0
        self.resizes: list[tuple[int, int]] = []   # (step, new_count)
        self.straggler = straggler
        self.checkpoint = checkpoint
        self.restores: list[tuple[int, int]] = []  # (fail step, resume step)

    # -- workload hooks (Alg. 2's POLL/ADD analogues) -----------------------

    def on_batches_queued(self, n: int, tokens_per_batch: float) -> None:
        for _ in range(n):
            self._task_seq += 1
            self.monitor.on_task_ready(self._task_seq, "global_batch",
                                       tokens_per_batch)
            self.monitor.on_task_execute(self._task_seq, "global_batch",
                                         tokens_per_batch)

    def on_step_done(self, task_id_offset: int, tokens: float,
                     elapsed: float, replica: int | None = None) -> None:
        self.monitor.on_task_completed(task_id_offset, "global_batch",
                                       tokens, elapsed)
        if self.straggler is not None and replica is not None:
            self.straggler.observe(replica, elapsed)

    # -- membership ------------------------------------------------------------

    def fail_replica(self, rid: int, step: int) -> ReplicaSet:
        """Node loss: forced shrink + rebalance."""
        self.failed.add(rid)
        survivors = [r for r in self.set.replicas if r != rid]
        if len(survivors) < self.min_replicas:
            raise RuntimeError("lost too many replicas")
        self.set = ReplicaSet(survivors, self.set.global_batch)
        self.resizes.append((step, len(survivors)))
        return self.set

    def resize_to_prediction(self, step: int) -> ReplicaSet:
        """Ask the governor for the policy's replica target and apply it.

        The backlog of live global batches is the load signal; the
        governor ticks the predictor and lets the policy object decide
        (busy keeps everything, prediction tracks Δ) — no policy-name
        branching here."""
        want = self.governor.target(self.governor.live_load(), 0)
        want = max(self.min_replicas,
                   min(want, self.max_replicas - len(self.failed)))
        cur = self.set.replicas
        drained = (self.straggler.drained if self.straggler is not None
                   else ())
        if want < len(cur):
            new = cur[:want]
        elif want > len(cur):
            pool = [r for r in range(self.max_replicas)
                    if r not in self.failed and r not in cur
                    and r not in drained]
            new = cur + pool[:want - len(cur)]
        else:
            return self.set
        self.set = ReplicaSet(new, self.set.global_batch)
        self.resizes.append((step, len(new)))
        return self.set

    # -- fault tolerance (machine conditions) -------------------------------

    def sweep_stragglers(self, step: int) -> ReplicaSet:
        """Drain replicas the straggler monitor currently flags (their
        data shard re-balances over the rest — the same forced-shrink
        mechanics as a failure, but *re-admittable*: once the monitor's
        cooldown clears a drained replica, :meth:`resize_to_prediction`
        may grow back onto it).  A no-op without an attached monitor."""
        if self.straggler is None:
            return self.set
        self.straggler.sweep()
        drained = self.straggler.drained
        keep = [r for r in self.set.replicas if r not in drained]
        if len(keep) < self.min_replicas:
            return self.set   # refuse to drain below the floor
        if keep != self.set.replicas:
            self.set = ReplicaSet(keep, self.set.global_batch)
            self.resizes.append((step, len(keep)))
        return self.set

    def maybe_checkpoint(self, step: int, state, every: int = 1) -> bool:
        """Save ``state`` through the attached
        :class:`~repro.checkpoint.CheckpointManager` every ``every``
        steps; returns True when a save happened."""
        if self.checkpoint is None or step % every != 0:
            return False
        self.checkpoint.save(step, state)
        return True

    def recover_from_failure(self, rid: int, step: int, like_state):
        """``CORE_FAIL`` mid-run: shrink to the survivors and roll the
        training state back to the latest checkpoint.

        Returns ``(replica_set, state, resume_step)``.  Without an
        attached checkpoint manager (or before the first save) the live
        state continues forward — the shrink alone keeps the run alive.
        """
        rs = self.fail_replica(rid, step)
        if (self.checkpoint is None
                or self.checkpoint.latest_step() is None):
            return rs, like_state, step
        state, ck_step = self.checkpoint.restore(like_state)
        self.restores.append((step, ck_step))
        return rs, state, ck_step

    def apply_perturbation(self, p: Perturbation, step: int, state):
        """Map a machine-condition perturbation onto the replica fleet:
        ``CORE_FAIL`` → checkpoint-restore shrink, ``CORE_RECOVER`` →
        the replica rejoins the candidate pool (the next grow re-admits
        it), ``STRAGGLER`` → pre-seed the monitor's suspicion.  Returns
        ``(replica_set, state, resume_step)`` like
        :meth:`recover_from_failure`."""
        if p.kind is PerturbationKind.CORE_FAIL and p.core is not None \
                and p.core in self.set.replicas:
            return self.recover_from_failure(p.core, step, state)
        if p.kind is PerturbationKind.CORE_RECOVER and p.core is not None:
            self.failed.discard(p.core)
        elif (p.kind is PerturbationKind.STRAGGLER
              and self.straggler is not None and p.core is not None
              and p.slowdown is not None and p.slowdown > 1.0):
            self.straggler.mark(p.core)
            keep = [r for r in self.set.replicas if r != p.core]
            if len(keep) >= self.min_replicas and keep != self.set.replicas:
                self.set = ReplicaSet(keep, self.set.global_batch)
                self.resizes.append((step, len(keep)))
        return self.set, state, step
