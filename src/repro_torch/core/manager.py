"""The CPU/worker manager — the mechanics side of Algorithm 2.

:class:`WorkerManager` owns the worker state machine (ACTIVE / SPIN / IDLE /
LENT), the active count ``δ`` and the idle set.  It consults a
:class:`~repro.core.policies.Policy` for every decision, so the same code
drives the real :class:`~repro.runtime.thread_executor.ThreadExecutor`, the
discrete-event :class:`~repro.runtime.sim.SimExecutor` and (with workers
reinterpreted as device replicas) the distributed
:class:`~repro.train.elastic.ElasticController`.

The manager is deliberately *passive*: it mutates state and reports which
workers must be resumed/idled, but the executor owns the actual blocking /
wakeup primitives (condition variables live, event queue simulated).

Heterogeneous machines: the manager may know each worker's core type
(``core_type_of``) and a **park order** over type names.  Parking-order
types are trimmed first when Δ drops and woken last when work arrives
("park the E-cores last" keeps the efficient cores hot; "park the
P-cores last" keeps the fast ones).  Without a topology both orderings
are identity, so homogeneous behaviour is unchanged.

All transitions are guarded by one lock; the paper stores ``Δ`` in an atomic
and updates ``δ`` "in a thread-safe manner" — this lock is that atomicity.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Sequence

from ..analysis import guarded_by
from .energy import CoreState, EnergyMeter
from .events import EventBus, EventKind, RuntimeEvent
from .policies import Policy, PollDecision

__all__ = ["WorkerState", "WorkerManager"]


class WorkerState(enum.Enum):
    ACTIVE = "active"   # executing a task
    SPIN = "spin"       # polling for work
    IDLE = "idle"       # released its CPU (paper: idle(thread))
    LENT = "lent"       # CPU lent to another runtime via the broker


_ENERGY_STATE = {
    WorkerState.ACTIVE: CoreState.ACTIVE,
    WorkerState.SPIN: CoreState.SPIN,
    WorkerState.IDLE: CoreState.IDLE,
    WorkerState.LENT: CoreState.OFF,
}

# Per-member attribute mirror of _ENERGY_STATE: `state._energy` is a
# plain attribute load, where a dict lookup pays enum.__hash__ (a
# Python-level call) once per worker transition on the hot path.
for _ws, _cs in _ENERGY_STATE.items():
    _ws._energy = _cs


@guarded_by("_states", "_spin_counts", "_n_active", "_n_idle",
            "_n_active_by_type", "idles", "resumes")
class WorkerManager:
    """Tracks δ (active workers) and applies policy decisions atomically."""

    def __init__(self, n_workers: int, policy: Policy,
                 clock: Callable[[], float],
                 energy: EnergyMeter | None = None,
                 worker_ids: list[int] | None = None,
                 bus: EventBus | None = None,
                 core_type_of: Callable[[int], str] | None = None,
                 park_order: Sequence[str] | None = None) -> None:
        self.policy = policy
        self.clock = clock
        self.energy = energy
        self.bus = bus
        self.core_type_of = core_type_of
        # Lower rank ⇒ parked earlier and woken later.  Unknown types
        # rank last (parked last / woken first).
        self._park_rank = ({name: i for i, name in enumerate(park_order)}
                           if park_order is not None else {})
        ids = worker_ids if worker_ids is not None else list(range(n_workers))
        self._lock = threading.Lock()
        self._states: dict[int, WorkerState] = {
            w: WorkerState.SPIN for w in ids}
        self._spin_counts: dict[int, int] = {w: 0 for w in ids}
        # δ maintained incrementally — poll decisions used to recount the
        # whole state dict on every empty poll (O(workers) per event on
        # the simulator hot path).
        self._n_active = len(ids)
        self._n_idle = 0
        self._n_active_by_type: dict[str, int] = {}
        if core_type_of is not None:
            for w in ids:
                ct = core_type_of(w)
                self._n_active_by_type[ct] = \
                    self._n_active_by_type.get(ct, 0) + 1
        # Transition counters (observability / paper overhead discussion).
        self.idles = 0
        self.resumes = 0
        # Optional per-worker wake callback (see set_waker) — set once
        # before the workers start, then only read.
        self._waker: Callable[[int], None] | None = None

    def set_waker(self, waker: Callable[[int], None] | None) -> None:
        """Register a per-worker wake callback.

        When set, :meth:`notify_added` invokes ``waker(worker_id)`` for
        each worker it transitions IDLE → SPIN, *after* releasing the
        manager lock — targeted wakes (one event set per resumed worker)
        instead of the executor broadcasting ``notify_all`` to every
        parked thread.  The callback runs on the notifying thread and
        must not call back into the manager.
        """
        self._waker = waker

    # -- introspection -------------------------------------------------------

    @property
    def n_workers(self) -> int:
        with self._lock:
            return len(self._states)

    @property
    def active(self) -> int:
        """δ — workers currently holding a CPU (executing or spinning)."""
        return self._n_active

    def _active_locked(self) -> int:
        return self._n_active

    def active_by_type(self) -> dict[str, int]:
        """δ split per core type ({} without a ``core_type_of``;
        zero-count types are pruned)."""
        with self._lock:
            return {ct: n for ct, n in self._n_active_by_type.items()
                    if n > 0}

    def _active_by_type_locked(self) -> dict[str, int]:
        # The live counter dict (may carry zero entries) — read-only for
        # callers; the hetero policy's bound reader uses .get() lookups.
        return self._n_active_by_type

    @property
    def idle_workers(self) -> list[int]:
        with self._lock:
            return [w for w, s in self._states.items()
                    if s is WorkerState.IDLE]

    def state(self, worker_id: int) -> WorkerState:
        with self._lock:
            return self._states[worker_id]

    def state_of(self, worker_id: int) -> WorkerState | None:
        """Current state, or None for unknown workers — a single dict
        probe, unlike :meth:`states` which copies the whole map."""
        return self._states.get(worker_id)

    def states(self) -> dict[int, WorkerState]:
        with self._lock:
            return dict(self._states)

    def spinning(self, exclude: "set[int] | frozenset[int]" = frozenset(),
                 ) -> list[int]:
        """Spinning workers (minus ``exclude``) in wake/dispatch order —
        one pass under the lock instead of a states() copy + filter."""
        with self._lock:
            out = [w for w, s in self._states.items()
                   if s is WorkerState.SPIN and w not in exclude]
        return self.wake_first(out)

    def iter_spinning(self, exclude: "set[int] | frozenset[int]"
                      = frozenset()):
        """Lazy :meth:`spinning` for single-threaded dispatch loops that
        usually consume one or two workers out of dozens.  The caller
        may flip the state of *yielded* workers between yields (value
        mutations keep dict iteration valid) but must not add or remove
        workers.  Falls back to the materialized list on park-ordered
        (heterogeneous) managers, where wake order needs the full sort.
        """
        if self._park_rank:
            yield from self.spinning(exclude)
            return
        spin = WorkerState.SPIN
        for w, s in self._states.items():
            if s is spin and w not in exclude:
                yield w

    def states_items_unlocked(self):
        """Live ``(worker, state)`` view WITHOUT taking the lock.

        Sanctioned for single-threaded drivers only (the sim event loop
        owns every thread that touches its manager): ``_states`` is a
        declared guarded field, and this accessor is the one documented
        escape hatch — external code must not reach into the dict
        directly.  Keys are fixed after construction on this path and
        ``poll_empty`` mutates values only, so iteration is safe.
        """
        return self._states.items()

    @property
    def park_ordered(self) -> bool:
        """True when a heterogeneous park order was configured.  Set
        once at construction and immutable, so the unlocked read is
        safe from any thread."""
        return bool(self._park_rank)

    # -- ordering ------------------------------------------------------------

    def _rank(self, worker_id: int) -> int:
        if self.core_type_of is None or not self._park_rank:
            return 0
        return self._park_rank.get(self.core_type_of(worker_id),
                                   len(self._park_rank))

    def park_first(self, workers: list[int]) -> list[int]:
        """``workers`` sorted for trimming: lowest park rank first
        (stable — identity without a topology)."""
        if not self._park_rank:
            return workers
        return sorted(workers, key=self._rank)

    def wake_first(self, workers: list[int]) -> list[int]:
        """``workers`` sorted for waking/dispatch: highest park rank
        first (stable — identity without a topology)."""
        if not self._park_rank:
            return workers
        return sorted(workers, key=lambda w: -self._rank(w))

    # -- transitions ---------------------------------------------------------

    _HOLDING = (WorkerState.ACTIVE, WorkerState.SPIN)

    # analysis: caller-locks
    def _count(self, worker_id: int, prev: WorkerState | None,
               state: WorkerState | None) -> None:
        """Incrementally maintain δ, the idle count and the per-type
        split across one worker's ``prev → state`` transition (None ⇒
        absent)."""
        if prev is WorkerState.IDLE:
            self._n_idle -= 1
        if state is WorkerState.IDLE:
            self._n_idle += 1
        held = prev in self._HOLDING
        holds = state in self._HOLDING
        if held is holds:
            return
        d = 1 if holds else -1
        self._n_active += d
        if self.core_type_of is not None:
            ct = self.core_type_of(worker_id)
            self._n_active_by_type[ct] = \
                self._n_active_by_type.get(ct, 0) + d

    def _set(self, worker_id: int, state: WorkerState) -> None:  # analysis: caller-locks
        # Hot path (two transitions per simulated task): the counter
        # maintenance is _count() inlined, and the bus pre-check reads
        # the cached interest union directly instead of paying a method
        # call per transition.
        prev = self._states.get(worker_id)
        if prev is state:
            return
        self._states[worker_id] = state
        if prev is WorkerState.IDLE:
            self._n_idle -= 1
        elif state is WorkerState.IDLE:
            self._n_idle += 1
        held = prev in self._HOLDING
        if held is not (state in self._HOLDING):
            d = -1 if held else 1
            self._n_active += d
            if self.core_type_of is not None:
                ct = self.core_type_of(worker_id)
                self._n_active_by_type[ct] = \
                    self._n_active_by_type.get(ct, 0) + d
        if self.energy is not None:
            self.energy.set_state(worker_id, state._energy, self.clock())
        bus = self.bus
        if bus is not None:
            interest = bus.interest
            if interest is None or interest:
                self._publish_state(bus, worker_id, prev, state)

    def _publish_state(self, bus: EventBus, worker_id: int,
                       prev: WorkerState | None,
                       state: WorkerState) -> None:
        if bus.interested(EventKind.WORKER_STATE):
            bus.publish(RuntimeEvent(
                kind=EventKind.WORKER_STATE, time=self.clock(),
                worker_id=worker_id,
                data={"state": state.value,
                      "prev": prev.value if prev else None}))

    def _apply_poll_decision_locked(self, worker_id: int,
                                    decision: PollDecision) -> None:
        """The one IDLE/LEND transition path (poll_empty and
        reevaluate_spinners used to diverge on spin-count resets and
        transition counting)."""
        if decision is PollDecision.IDLE:
            self._set(worker_id, WorkerState.IDLE)
            self._spin_counts[worker_id] = 0
            self.idles += 1
        elif decision is PollDecision.LEND:
            self._set(worker_id, WorkerState.LENT)
            self._spin_counts[worker_id] = 0

    def task_started(self, worker_id: int) -> None:
        with self._lock:
            self._spin_counts[worker_id] = 0
            self._set(worker_id, WorkerState.ACTIVE)

    def task_finished(self, worker_id: int) -> None:
        with self._lock:
            self._set(worker_id, WorkerState.SPIN)

    def poll_empty(self, worker_id: int,
                   spin_count_override: int | None = None) -> PollDecision:
        """Worker polled, queue empty — Alg. 2 lines 2–10.

        Returns the decision; IDLE/LEND transitions are applied (δ
        decremented) before returning, so a concurrent poller sees the
        updated δ.  ``spin_count_override`` lets the discrete-event
        simulator fast-forward a spin budget (N empty polls collapse into
        one event) without emitting N calls.
        """
        with self._lock:
            if spin_count_override is not None:
                count = spin_count_override
                self._spin_counts[worker_id] = count
            else:
                count = self._spin_counts[worker_id] + 1
                self._spin_counts[worker_id] = count
            decision = self.policy.on_poll_empty(
                worker_id, self._n_active, count)
            if decision is not PollDecision.SPIN:
                # SPIN applies no transition; skip the apply call on the
                # (dominant) keep-spinning outcome
                self._apply_poll_decision_locked(worker_id, decision)
            return decision

    def notify_added(self, ready_tasks: int) -> list[int]:
        """Tasks were added — Alg. 2 lines 11–19.

        Returns the worker ids transitioned IDLE → SPIN; the executor must
        actually wake them (condition variable / sim event), unless a
        :meth:`set_waker` callback is registered — then each woken id is
        delivered to it here, after the lock is released, and the caller
        may ignore the return value.  On heterogeneous machines the wake
        order follows the park order in reverse (fastest-to-park woken
        last).
        """
        with self._lock:
            n_idle = self._n_idle
            if n_idle == 0:
                return []
            # Ask the policy first (it only needs the counts — all
            # implementations are pure decision logic) and build the
            # ordered idle list only when somebody actually wakes:
            # prediction-rate ticks with δ ≥ Δ used to pay a full
            # state-map scan just to wake nobody.
            n = self.policy.workers_to_resume(
                self._n_active, n_idle, ready_tasks)
            if n <= 0:
                return []
            idle = self.wake_first([w for w, s in self._states.items()
                                    if s is WorkerState.IDLE])
            woken = idle[:n]
            for w in woken:
                self._set(w, WorkerState.SPIN)
                self._spin_counts[w] = 0
                self.resumes += 1
        # Outside the lock: by now every woken worker's transition is
        # visible, so a worker whose wake event fires re-checks its
        # state and finds SPIN — no missed wakeup, no lock held while
        # signalling.
        waker = self._waker
        if waker is not None:
            for w in woken:
                waker(w)
        return woken

    def reevaluate_spinners(self) -> list[int]:
        """After a prediction tick lowered Δ, ask the policy about every
        spinning worker again (the paper's threads re-check ``δ > Δ`` on
        their next poll; in the simulator this is the equivalent hook).

        Returns workers transitioned out of SPIN (idled or lent), park
        order first.
        """
        parked = []
        with self._lock:
            spinning = self.park_first(
                [w for w, s in self._states.items()
                 if s is WorkerState.SPIN])
            for w in spinning:
                decision = self.policy.on_poll_empty(
                    w, self._active_locked(), self._spin_counts[w])
                self._apply_poll_decision_locked(w, decision)
                if decision in (PollDecision.IDLE, PollDecision.LEND):
                    parked.append(w)
        return parked

    # -- broker hooks (DLB) ---------------------------------------------------

    def add_worker(self, worker_id: int, power=None,
                   core_type: str = "") -> None:
        """A borrowed CPU arrived from the broker; it starts spinning.

        ``power``/``core_type`` carry the borrowed core's identity on
        heterogeneous machines so its energy is billed correctly."""
        with self._lock:
            prev = self._states.get(worker_id)
            self._states[worker_id] = WorkerState.SPIN
            self._count(worker_id, prev, WorkerState.SPIN)
            self._spin_counts[worker_id] = 0
            if self.energy is not None:
                self.energy.add_core(worker_id, CoreState.SPIN,
                                     self.clock(), power=power,
                                     core_type=core_type)

    def remove_worker(self, worker_id: int) -> None:
        """A borrowed CPU was reclaimed by its owner.

        The core's energy timeline is closed with an OFF transition —
        the owner accounts for it from here on; without this, a returned
        CPU kept accruing SPIN power in the borrower's meter until
        ``finish()``.
        """
        with self._lock:
            if worker_id in self._states and self.energy is not None:
                self.energy.set_state(worker_id, CoreState.OFF,
                                      self.clock())
            prev = self._states.pop(worker_id, None)
            if prev is not None:
                self._count(worker_id, prev, None)
            self._spin_counts.pop(worker_id, None)

    def reclaim(self, worker_id: int) -> None:
        """Owner got its lent CPU back (LENT → SPIN)."""
        with self._lock:
            if self._states.get(worker_id) is WorkerState.LENT:
                self._set(worker_id, WorkerState.SPIN)
                self._spin_counts[worker_id] = 0
