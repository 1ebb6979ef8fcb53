"""Ready-queue scheduler with dependency tracking.

Publishes the task lifecycle (submitted / ready / execute / completed /
arrived) as :class:`~repro.core.events.RuntimeEvent`\\ s on an
:class:`~repro.core.events.EventBus` for external observers (trace
recorders, dashboards).  The :class:`~repro.core.monitoring.TaskMonitor`
is **driven directly** — it sees exactly the transitions of paper Fig. 2
through plain method calls (one batched call per completion), so
monitored-but-untraced runs build no event objects at all.  FIFO within a
queue; thread-safe by default.

``threadsafe=False`` returns a :class:`_SeqScheduler` — the same
scheduler minus every lock round-trip, for single-threaded drivers (the
discrete-event simulator owns the only thread that ever touches it).
Both modes run the identical submit/poll/complete logic in the identical
order, which the fast-path parity tests pin bit-for-bit.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterable

from ..analysis import guarded_by, lock_free
from ..core.events import QUIET_INTEREST as _QUIET
from ..core.events import EventBus, EventKind, RuntimeEvent
from ..core.monitoring import TaskMonitor
from .task import Task

__all__ = ["Scheduler"]


@guarded_by("_ready", "_pending", "_ready_count")
class Scheduler:
    def __new__(cls, monitor: TaskMonitor | None = None,
                bus: EventBus | None = None,
                clock: Callable[[], float] | None = None,
                threadsafe: bool = True) -> "Scheduler":
        if cls is Scheduler and not threadsafe:
            return super().__new__(_SeqScheduler)
        return super().__new__(cls)

    def __init__(self, monitor: TaskMonitor | None = None,
                 bus: EventBus | None = None,
                 clock: Callable[[], float] | None = None,
                 threadsafe: bool = True) -> None:
        self.bus = bus if bus is not None else EventBus()
        self.clock = clock if clock is not None else (lambda: 0.0)
        self.monitor = monitor
        if monitor is not None:
            # The scheduler feeds its monitor directly (one batched call
            # per completion — no per-event RuntimeEvent construction or
            # bus dispatch).  A monitor subscription on this scheduler's
            # own bus — before or after construction — is absorbed so
            # the pair wired both ways still counts every lifecycle
            # event exactly once.
            monitor.unsubscribe(self.bus)
            monitor.mark_direct_driven(self.bus)
        self._lock = threading.Lock()
        self._ready: deque[Task] = deque()
        self._pending = 0          # submitted, not yet completed
        self._ready_count = 0

    def _publish(self, kind: EventKind, task: Task, *,
                 worker_id: int | None = None,
                 elapsed: float | None = None) -> None:
        """Publish one lifecycle event IF some subscriber wants the kind.

        The single interest check lives here (callers used to pre-check
        and ``_publish`` checked again); kind-specific payloads (dep ids,
        parent links) are built after the check, so hot paths with no
        interested subscriber allocate nothing.
        """
        if not self.bus.interested(kind):
            return
        if kind is EventKind.TASK_SUBMITTED:
            data = {"deps": [d.task_id for d in task.deps],
                    "parent": task.parent.task_id if task.parent else None,
                    "release_time": task.release_time}
        elif kind is EventKind.TASK_COMPLETED:
            data = {"parent": task.parent.task_id if task.parent else None}
        else:
            data = {}
        self.bus.publish(RuntimeEvent(
            kind=kind, time=self.clock(), task_id=task.task_id,
            type_name=task.type_name, cost=task.cost, worker_id=worker_id,
            elapsed=elapsed, data=data))

    # -- submission ------------------------------------------------------

    def submit(self, task: Task) -> bool:
        """Register a task; returns True if it became ready immediately."""
        with self._lock:
            return self._submit_core(task)

    def submit_all(self, tasks: Iterable[Task]) -> int:
        """Submit many tasks; returns how many became ready.

        One lock acquisition for the whole batch (this used to take and
        release the lock once per task — measurable on 10k+-task closed
        graphs)."""
        n = 0
        submit = self._submit_core
        with self._lock:
            for t in tasks:
                if submit(t):
                    n += 1
        return n

    def _submit_core(self, task: Task) -> bool:  # analysis: caller-locks
        """Dependency wiring + ready-queue insert (caller holds the lock
        in threadsafe mode; the sequential scheduler calls it bare)."""
        self._pending += 1
        unmet = 0
        for d in task.deps:
            if not d.done:
                unmet += 1
                d.successors.append(task)
        task.unmet = unmet
        # A quiet bus (no subscriber wants any kind) skips even the
        # _publish calls.
        quiet = self.bus.interest == _QUIET
        if not quiet:
            self._publish(EventKind.TASK_SUBMITTED, task)
        if unmet == 0:
            self._ready.append(task)
            self._ready_count += 1
            monitor = self.monitor
            if monitor is not None:
                monitor.on_task_ready(task.task_id, task.type_name,
                                      task.cost)
            if not quiet:
                self._publish(EventKind.TASK_READY, task)
            return True
        return False

    # -- polling -----------------------------------------------------------

    def poll(self, worker_id: int | None = None) -> Task | None:
        with self._lock:
            if not self._ready:
                return None
            task = self._ready.popleft()
            self._ready_count -= 1
        monitor = self.monitor
        if monitor is not None:
            monitor.on_task_execute(task.task_id, task.type_name, task.cost)
        if self.bus.interest != _QUIET:
            self._publish(EventKind.TASK_EXECUTE, task, worker_id=worker_id)
        return task

    def complete(self, task: Task, elapsed: float,
                 worker_id: int | None = None) -> list[Task]:
        """Mark done; returns tasks that *became ready* as a result."""
        with self._lock:
            newly_ready = self._complete_core(task, elapsed, worker_id)
        if self.bus.interest != _QUIET:
            self._publish(EventKind.TASK_COMPLETED, task,
                          worker_id=worker_id, elapsed=elapsed)
        return newly_ready

    # analysis: caller-locks
    def _complete_core(self, task: Task, elapsed: float,
                       worker_id: int | None) -> list[Task]:
        task.done = True
        self._pending -= 1
        newly_ready: list[Task] = []
        for s in task.successors:
            s.unmet -= 1
            if s.unmet == 0:
                self._ready.append(s)
                newly_ready.append(s)
        self._ready_count += len(newly_ready)
        if newly_ready and self.bus.interested(EventKind.TASK_READY):
            for s in newly_ready:
                self._publish(EventKind.TASK_READY, s)
        monitor = self.monitor
        if monitor is not None:
            # One lock acquisition for the whole completion batch: the
            # newly-ready successors first, then the completion itself —
            # the exact order the per-event path produced.
            monitor.completion_batch(
                task, elapsed, worker_id,
                task.parent.task_id if task.parent else None,
                newly_ready)
        return newly_ready

    def requeue(self, task: Task) -> None:
        """Put an *executing* task back at the head of the ready queue —
        the core running it died (machine conditions).  The inverse of
        :meth:`poll`: ready count grows, the monitor reverses its
        executing → ready accounting, and a fresh ``TASK_READY`` is
        published so recorded traces show the re-queue (the later
        re-execution publishes its own EXECUTE/COMPLETED pair)."""
        with self._lock:
            self._ready.appendleft(task)
            self._ready_count += 1
        self._requeue_tail(task)

    def _requeue_tail(self, task: Task) -> None:  # analysis: caller-locks
        monitor = self.monitor
        if monitor is not None:
            monitor.on_task_abort(task.task_id, task.type_name, task.cost)
        if self.bus.interest != _QUIET:
            self._publish(EventKind.TASK_READY, task)

    # -- state ---------------------------------------------------------------

    @property
    def ready_count(self) -> int:
        with self._lock:
            return self._ready_count

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def drained(self) -> bool:
        with self._lock:
            return self._pending == 0


@lock_free
class _SeqScheduler(Scheduler):
    """Single-threaded fast path: identical logic, zero lock round-trips.

    Built via ``Scheduler(..., threadsafe=False)``.  Every hot method is
    re-bound to the bare core (no ``with self._lock``), and the state
    accessors read the counters as plain attributes — callers like
    ``SimCluster._dispatch`` stop paying a lock acquire/release per
    ready-count peek.

    Lock-freedom is a contract, not a convenience: exactly one thread
    may ever drive an instance.  In debug builds (``python`` without
    ``-O``) the first mutating call binds the owning thread and any call
    from a different thread raises, so misuse fails loudly instead of
    corrupting counters.
    """

    def __init__(self, *args: object, **kwargs: object) -> None:
        super().__init__(*args, **kwargs)  # type: ignore[arg-type]
        self._owner_ident: int | None = None

    def _assert_owner(self) -> None:
        ident = threading.get_ident()
        owner = self._owner_ident
        if owner is None:
            self._owner_ident = ident
        elif owner != ident:
            raise RuntimeError(
                "Scheduler(threadsafe=False) is single-threaded by "
                f"contract: owned by thread {owner}, called from "
                f"{ident}. Use threadsafe=True for multi-thread access.")

    def submit(self, task: Task) -> bool:
        if __debug__:
            self._assert_owner()
        return self._submit_core(task)

    def submit_all(self, tasks: Iterable[Task]) -> int:
        if __debug__:
            self._assert_owner()
        n = 0
        submit = self._submit_core
        for t in tasks:
            if submit(t):
                n += 1
        return n

    def poll(self, worker_id: int | None = None) -> Task | None:
        if __debug__:
            self._assert_owner()
        if not self._ready:
            return None
        task = self._ready.popleft()
        self._ready_count -= 1
        monitor = self.monitor
        if monitor is not None:
            monitor.on_task_execute(task.task_id, task.type_name, task.cost)
        if self.bus.interest != _QUIET:
            self._publish(EventKind.TASK_EXECUTE, task, worker_id=worker_id)
        return task

    def complete(self, task: Task, elapsed: float,
                 worker_id: int | None = None) -> list[Task]:
        if __debug__:
            self._assert_owner()
        newly_ready = self._complete_core(task, elapsed, worker_id)
        if self.bus.interest != _QUIET:
            self._publish(EventKind.TASK_COMPLETED, task,
                          worker_id=worker_id, elapsed=elapsed)
        return newly_ready

    def requeue(self, task: Task) -> None:
        if __debug__:
            self._assert_owner()
        self._ready.appendleft(task)
        self._ready_count += 1
        self._requeue_tail(task)

    @property
    def ready_count(self) -> int:
        return self._ready_count

    @property
    def pending(self) -> int:
        return self._pending

    def drained(self) -> bool:
        return self._pending == 0
