"""Resource-management policies (paper §2, §3.2 — Algorithm 2).

A policy decides what a worker does when it polls for work and finds none
(``on_poll_empty``) and whether sleeping workers should be woken when new
work arrives (``workers_to_resume``).  The mechanics of idling/resuming are
owned by the executor's :class:`~repro.core.manager.WorkerManager`; policies
are pure decision logic so the same implementations drive the real threaded
executor, the discrete-event simulator, and the distributed elastic
controller.

Implemented policies:

* ``busy``        — OpenMP *active* / OmpSs-2 *busy*: spin forever.
* ``idle``        — OpenMP *passive* / OmpSs-2 *idle*: sleep immediately;
                    woken whenever tasks are added.
* ``hybrid``      — spin for a fixed budget, then sleep (OpenMP
                    ``OMP_WAIT_POLICY`` tuning).
* ``prediction``  — the paper's policy (Alg. 2): sleep only when the active
                    count δ exceeds the predicted optimum Δ; wake only while
                    δ < Δ.
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from typing import Callable, Mapping

from .prediction import CPUPredictor

__all__ = [
    "PollDecision",
    "Policy",
    "BusyPolicy",
    "IdlePolicy",
    "HybridPolicy",
    "PredictionPolicy",
    "HeteroPredictionPolicy",
]


class PollDecision(enum.Enum):
    SPIN = "spin"    # keep burning cycles, poll again
    IDLE = "idle"    # release the CPU until resumed
    LEND = "lend"    # give the CPU to the resource broker (sharing mode)


class Policy(ABC):
    """Decision logic consulted by executors.

    ``active``/``idle`` counts are supplied by the caller (they are owned
    by the worker manager and updated atomically there).
    """

    name: str = "abstract"
    #: whether the executor should drive predictor ticks for this policy
    uses_predictions: bool = False
    #: True ⇔ :meth:`on_poll_empty` ignores ``worker_id`` and
    #: ``spin_count`` — the decision is a pure function of ``active``.
    #: Lets tick-time re-evaluation loops stop at the first SPIN verdict
    #: (every remaining spinner would get the identical answer, and the
    #: skipped spin-count increments are unread by such policies).
    poll_uniform: bool = False
    #: True ⇔ :meth:`on_poll_empty` can never return anything but SPIN.
    #: Real-thread executors may then skip the per-empty-poll manager
    #: round-trip entirely (the spin counts such a policy never reads are
    #: the only state the skipped call would have touched).
    never_idles: bool = False

    @abstractmethod
    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        """Worker ``worker_id`` polled and the ready queue was empty.

        ``active`` is the current number of non-idle workers (δ);
        ``spin_count`` how many consecutive empty polls this worker has
        made since it last executed a task.
        """

    @abstractmethod
    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        """How many idle workers to wake after tasks were added.

        ``idle`` is the number of currently-sleeping workers and
        ``ready_tasks`` the number of tasks now ready.
        """

    def on_prediction_tick(self) -> None:  # pragma: no cover - default no-op
        """Called by the executor at the prediction rate (if enabled)."""

    def target(self, queued: int, active: int, n_resources: int) -> int:
        """Desired resource count for pull-style frontends (the serving
        autoscaler / elastic trainer ask this instead of running a worker
        loop).  Default: purely reactive — one resource per unit of load,
        capped at what we own (the idle policy's behaviour)."""
        return min(queued + active, n_resources)


class BusyPolicy(Policy):
    name = "busy"
    poll_uniform = True
    never_idles = True

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        return PollDecision.SPIN

    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        # Nothing ever sleeps under busy, but if the executor started some
        # workers idle, wake everything.
        return idle

    def target(self, queued: int, active: int, n_resources: int) -> int:
        return n_resources  # everything stays hot, load or not


class IdlePolicy(Policy):
    """Sleep on the first empty poll; wake (up to one worker per ready
    task) whenever work is added — OmpSs-2's idle policy is reactive:
    "as tasks are created, threads are resumed so they may poll once
    again"."""

    name = "idle"

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        return PollDecision.IDLE

    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        return min(idle, max(0, ready_tasks - active))


class HybridPolicy(Policy):
    """Spin for ``spin_budget`` consecutive empty polls, then idle.

    The budget is the static user-chosen rate the paper criticizes ("the
    chosen rate is a static value that cannot be changed at run-time").
    """

    name = "hybrid"

    def __init__(self, spin_budget: int = 100) -> None:
        if spin_budget < 1:
            raise ValueError("spin_budget must be >= 1")
        self.spin_budget = spin_budget

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        if spin_count < self.spin_budget:
            return PollDecision.SPIN
        return PollDecision.IDLE

    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        return min(idle, max(0, ready_tasks - active))


class PredictionPolicy(Policy):
    """The paper's policy — Algorithm 2.

    * Poll-empty + ``δ > Δ``  → idle this worker (δ is decremented by the
      manager as part of the idle transition).
    * Poll-empty + ``δ ≤ Δ``  → keep spinning (the prediction says this
      CPU will be needed within the next window).
    * Tasks added + ``δ < Δ`` → resume ``Δ − δ`` workers.

    Δ is refreshed by :meth:`on_prediction_tick` at the prediction rate
    ``f`` and read from the predictor's atomic.
    """

    name = "prediction"
    uses_predictions = True
    poll_uniform = True

    def __init__(self, predictor: CPUPredictor) -> None:
        self.predictor = predictor

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        if active > self.predictor.delta:
            return PollDecision.IDLE
        return PollDecision.SPIN

    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        want = self.predictor.delta - active
        if want <= 0:
            return 0
        return min(idle, want, ready_tasks)

    def on_prediction_tick(self) -> None:
        self.predictor.tick()

    def target(self, queued: int, active: int, n_resources: int) -> int:
        if queued + active <= 0:
            return 0  # no live work ⇒ scale to zero
        # Cap at what the frontend owns: the predictor may be configured
        # with allow_oversubscription (the DLB arrangement), but a
        # non-sharing pull-style frontend (autoscaler / elastic trainer)
        # cannot scale beyond its own resources.
        return min(self.predictor.delta, n_resources)


class HeteroPredictionPolicy(PredictionPolicy):
    """Frequency-aware prediction on heterogeneous cores.

    Like :class:`PredictionPolicy`, but the idle/spin decision is made
    per *core type* against the predictor's Δ_c split (fastest cores are
    filled first by :meth:`~repro.core.prediction.CPUPredictor.compute_plan`),
    so surplus capacity is parked on the right silicon ("park the E-cores
    last" vs "park the P-cores last" is the manager's park order; this
    policy decides *how many* of each type stay hot).  The recommended
    DVFS step per type is applied by the governor on every tick.

    With a single homogeneous core type every decision reduces to the
    parent class — the parity the tests pin down.

    The governor binds :meth:`bind_topology` after the worker manager
    exists; unbound (pull-style frontends), decisions fall back to the
    total-Δ logic.
    """

    name = "hetero-prediction"
    #: decisions depend on the polling worker's core type — NOT uniform
    poll_uniform = False

    def __init__(self, predictor: CPUPredictor) -> None:
        super().__init__(predictor)
        self._type_of: Callable[[int], str] | None = None
        self._active_by_type: Callable[[], Mapping[str, int]] | None = None

    def bind_topology(self, type_of: Callable[[int], str],
                      active_by_type: Callable[[], Mapping[str, int]],
                      ) -> None:
        """Wire worker→core-type mapping and the per-type active counts.

        ``active_by_type`` is called from inside the worker manager's
        lock (poll decisions happen there), so it must be the manager's
        *unlocked* reader.
        """
        self._type_of = type_of
        self._active_by_type = active_by_type

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        if self._type_of is None or self._active_by_type is None:
            return super().on_poll_empty(worker_id, active, spin_count)
        by_type = self.predictor.delta_by_type
        if not by_type:
            return super().on_poll_empty(worker_id, active, spin_count)
        ct = self._type_of(worker_id)
        if self._active_by_type().get(ct, 0) > by_type.get(ct, 0):
            return PollDecision.IDLE
        return PollDecision.SPIN

    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        if self._active_by_type is None:
            return super().workers_to_resume(active, idle, ready_tasks)
        by_type = self.predictor.delta_by_type
        if not by_type:
            return super().workers_to_resume(active, idle, ready_tasks)
        # Per-type deficit, not the total: a stale spinner on a slow
        # type must not mask a missing fast core — critical-path tasks
        # would otherwise land on the slow silicon.  (The manager wakes
        # in reverse park order, so fast types come back first; any
        # over-waking is trimmed at the next prediction tick.)
        counts = self._active_by_type()
        want = sum(max(0, d - counts.get(ct, 0))
                   for ct, d in by_type.items())
        if want <= 0:
            return 0
        return min(idle, want, ready_tasks)
