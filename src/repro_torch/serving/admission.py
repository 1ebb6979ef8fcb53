"""Overload protection primitives: admission control, circuit breaking,
and the power-cap brownout allowance.

These are pure, clock-injected decision objects — no wall clock, no
hidden state — shared by the live :class:`~repro.serving.engine.
ServingEngine` and the discrete-event
:class:`~repro.serving.simserving.SimServing` frontend, and unit-
testable without either.

* :class:`AdmissionController` answers "should this request enter the
  queue?" — shedding on queue depth and on deadline infeasibility
  (the prediction stack's estimated wait says the deadline is already
  lost, so the cheapest place to fail is *now*, before the request
  burns a slot).
* :class:`CircuitBreaker` is the classic three-state machine guarding
  one replica: CLOSED counts consecutive failures, OPEN quarantines
  until ``reset_after_s`` elapses, HALF_OPEN admits probe traffic and
  closes again after ``probe_successes`` clean completions (shape per
  the distributed-manager runtime's recovery/re-admission loop).
* :func:`cap_allowance` turns a facility power cap into the number of
  replicas that may run hot, assuming the worst case (every hot
  replica drawing active power) so compliance never depends on load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .slo import SLOClass

__all__ = ["AdmissionController", "CircuitBreaker", "cap_allowance"]


@dataclass(frozen=True)
class AdmissionController:
    """Shed-or-admit decisions for one serving frontend.

    ``max_queue_depth`` bounds the queue (None = unbounded; the caller
    decides between rejecting the newcomer and evicting a lower-
    priority victim).  The deadline check sheds a request whose
    estimated completion — now + estimated queue wait + its own
    estimated service — already overshoots its deadline by more than
    the ``slack`` factor allows.
    """

    max_queue_depth: int | None = None
    #: deadline-infeasibility safety factor: shed when the estimated
    #: completion exceeds ``deadline · slack`` past release (1.0 =
    #: shed exactly at infeasibility; > 1 tolerates estimate noise)
    slack: float = 1.0

    def __post_init__(self) -> None:
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.slack <= 0.0:
            raise ValueError("slack must be > 0")

    def shed_reason(self, *, now: float, queue_depth: int,
                    slo: SLOClass | None, submitted_at: float,
                    est_wait_s: float = 0.0,
                    est_service_s: float = 0.0) -> str | None:
        """None = admit; otherwise the shed reason ("queue"/"deadline").

        A "queue" verdict means the queue is full — the caller may
        still admit by evicting a lower-priority queued request.
        """
        if (self.max_queue_depth is not None
                and queue_depth >= self.max_queue_depth):
            return "queue"
        if slo is not None and slo.deadline_s is not None:
            eta = now + est_wait_s + est_service_s
            if eta > submitted_at + slo.deadline_s * self.slack:
                return "deadline"
        return None


class CircuitBreaker:
    """Three-state failure gate for one replica (clock-injected).

    CLOSED → (``failure_threshold`` consecutive failures, or
    :meth:`force_open` on a hard fault) → OPEN → (``reset_after_s``
    elapses) → HALF_OPEN → (``probe_successes`` consecutive successes)
    → CLOSED, or (any failure) → back to OPEN.

    The breaker never reads a clock: every transition is driven by the
    ``now`` its caller passes, so it is deterministic under virtual
    time and trivially unit-testable.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_after_s: float = 1.0,
                 probe_successes: int = 2) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_after_s < 0.0:
            raise ValueError("reset_after_s must be >= 0")
        if probe_successes < 1:
            raise ValueError("probe_successes must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self.probe_successes = probe_successes
        self._state = self.CLOSED
        self._failures = 0
        self._probes = 0
        self._opened_at = 0.0

    def state(self, now: float) -> str:
        """Current state — an elapsed OPEN cooldown transitions to
        HALF_OPEN here, so simply *asking* advances the machine."""
        if (self._state == self.OPEN
                and now - self._opened_at >= self.reset_after_s):
            self._state = self.HALF_OPEN
            self._probes = 0
        return self._state

    def allow(self, now: float) -> bool:
        """May the replica take traffic?  HALF_OPEN allows probes — the
        caller limits their concurrency (typically to one in flight)."""
        return self.state(now) != self.OPEN

    def record_success(self, now: float) -> None:
        if self.state(now) == self.HALF_OPEN:
            self._probes += 1
            if self._probes >= self.probe_successes:
                self._state = self.CLOSED
                self._failures = 0
        else:
            self._failures = 0

    def record_failure(self, now: float) -> None:
        st = self.state(now)
        if st == self.HALF_OPEN:
            self._open(now)
        else:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._open(now)

    def force_open(self, now: float) -> None:
        """Quarantine unconditionally (hard fault, e.g. CORE_FAIL)."""
        self._open(now)

    def _open(self, now: float) -> None:
        self._state = self.OPEN
        self._opened_at = now
        self._failures = 0
        self._probes = 0


def cap_allowance(cap_w: float,
                  draws: Sequence[tuple[float, float]]) -> int:
    """How many replicas may run hot under a ``cap_w`` power budget.

    ``draws`` lists, in wake-priority order (fastest first), each live
    replica's ``(active_watts, idle_watts)``.  The budget is charged
    worst-case: every hot replica at full active draw, every parked one
    at its idle floor — so the allowance is load-independent and a
    compliant schedule can never be pushed over the cap by a burst.
    """
    budget = cap_w - sum(idle for _, idle in draws)
    n = 0
    for active, idle in draws:
        step = active - idle
        if step > budget + 1e-12:
            break
        budget -= step
        n += 1
    return n
