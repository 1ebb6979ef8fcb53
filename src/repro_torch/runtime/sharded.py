"""Sharded ready queues for the real-thread executor (the fast lane).

:class:`ShardedScheduler` is the multi-threaded hot-path twin of
:class:`~repro.runtime.scheduler.Scheduler`: same submit/poll/complete
contract, same monitor wiring, same lifecycle events — but the single
ready deque + one-lock-per-transition discipline is replaced by the
structure Myrmics-style runtimes use once centralized queue access stops
scaling:

* **per-worker shards** — each worker owns a deque it pushes and pops
  **LIFO** (a completed task's successors run next on the same worker,
  cache-warm, with zero lock traffic);
* **work stealing** — a worker whose shard is empty first drains the
  **global queue** (external submissions / cross-shard handoff), then
  steals **FIFO** from a victim chosen by scan order starting at its own
  id + 1 (stealing the oldest entry takes the work its owner is
  furthest from running);
* **batched monitoring** — workers buffer their monitor transitions
  locally and flush whole batches through
  :meth:`~repro.core.monitoring.TaskMonitor.flush_ops` (one monitor lock
  acquisition per ~``flush_batch`` transitions instead of one each);
* **per-stream event sequencing** — every published lifecycle event is
  stamped with a monotonic per-stream ``seq`` (one stream per worker,
  one for the submit side), so
  :meth:`~repro.trace.TraceRecorder.merged_events` can reconstruct the
  canonical order at flush time and a threaded trace stays replayable.

Why the shards need no lock: CPython's deque ``append`` / ``pop`` /
``popleft`` are single-bytecode-atomic under the GIL, so owner (LIFO
end) and thieves (FIFO end) never corrupt the structure; an
``IndexError`` on a racing pop is the miss signal, not an error.  The
one lock (``_lock``) guards only the *dependency bookkeeping* —
``_pending``, ``task.unmet`` / ``task.successors`` / ``task.done``
wiring — where a lost update would wedge the graph: ``unmet -= 1`` is
three bytecodes and genuinely races without it.

Accepted (and bounded) relaxations versus the single-lock scheduler:

* monitor aggregates may transiently observe a stolen successor's
  *execute* before the completion that readied it (different workers'
  buffers flush independently); the aggregates are sums/EMAs, so totals
  converge exactly and the skew is bounded by ``flush_batch``;
* ``ready_count`` sums deque lengths without a lock — a heuristic input
  (wake decisions, anti-starvation ticks), never a termination signal;
  ``drained()`` reads ``_pending`` under the lock.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterable

from ..analysis import guarded_by, single_writer
from ..core.events import QUIET_INTEREST as _QUIET
from ..core.events import EventBus, EventKind, RuntimeEvent
from ..core.monitoring import OP_COMPLETE, OP_EXECUTE, TaskMonitor
from .task import Task

__all__ = ["ShardedScheduler"]

#: monitor transitions buffered per worker before a flush (a task
#: contributes two: execute + complete) — large enough to amortize the
#: monitor lock, small enough that prediction ticks (≥ 1 ms apart) see
#: near-fresh workload totals at real task rates
DEFAULT_FLUSH_BATCH = 32


@single_writer("ops", "seq", "steals")
class _WorkerShard:
    """One worker's slice of the scheduler: its ready deque, its monitor
    op buffer, and its event-stream counters.

    ``ops``/``seq``/``steals`` are single-writer (the owning worker;
    ``flush_all`` touches ``ops`` only after the workers are joined).
    ``queue`` is deliberately *not* declared single-writer: the owner
    pushes/pops the LIFO end while thieves pop the FIFO end — safe
    because each access is one atomic deque operation, never a
    read-modify-write.
    """

    __slots__ = ("queue", "ops", "seq", "steals")

    def __init__(self) -> None:
        self.queue: deque[Task] = deque()
        self.ops: list[tuple] = []
        self.seq = 0
        self.steals = 0


@guarded_by("_pending", "_seq_submit")
class ShardedScheduler:
    """Work-stealing ready-queue scheduler for N real worker threads."""

    def __init__(self, n_workers: int, monitor: TaskMonitor | None = None,
                 bus: EventBus | None = None,
                 clock: Callable[[], float] | None = None,
                 flush_batch: int = DEFAULT_FLUSH_BATCH) -> None:
        if n_workers < 1:
            raise ValueError("need at least one worker shard")
        if flush_batch < 1:
            raise ValueError("flush_batch must be >= 1")
        self.bus = bus if bus is not None else EventBus()
        self.clock = clock if clock is not None else (lambda: 0.0)
        self.monitor = monitor
        if monitor is not None:
            # Same direct-drive absorption as Scheduler: a monitor
            # subscription on this bus would double-count every
            # lifecycle event the buffers already deliver.
            monitor.unsubscribe(self.bus)
            monitor.mark_direct_driven(self.bus)
        self.flush_batch = flush_batch
        self._lock = threading.Lock()
        self._shards = [_WorkerShard() for _ in range(n_workers)]
        #: external submissions + any ready task no worker owns yet;
        #: workers drain it FIFO before stealing
        self._global: deque[Task] = deque()
        self._pending = 0          # submitted, not yet completed
        self._seq_submit = 0       # submit-side event stream counter

    # -- events ----------------------------------------------------------

    def _publish_submit(self, kind: EventKind, task: Task) -> None:  # analysis: caller-locks
        """Submit-side publish, sequenced under ``_lock`` (concurrent
        submitters share the one submit stream)."""
        if not self.bus.interested(kind):
            return
        if kind is EventKind.TASK_SUBMITTED:
            data = {"deps": [d.task_id for d in task.deps],
                    "parent": task.parent.task_id if task.parent else None,
                    "release_time": task.release_time}
        else:
            data = {}
        seq = self._seq_submit
        self._seq_submit = seq + 1
        self.bus.publish(RuntimeEvent(
            kind=kind, time=self.clock(), task_id=task.task_id,
            type_name=task.type_name, cost=task.cost, seq=seq, data=data))

    def _publish_worker(self, kind: EventKind, task: Task,
                        shard: _WorkerShard, worker_id: int,
                        elapsed: float | None = None) -> None:
        """Worker-side publish, sequenced from the worker's own stream
        counter (single-writer — no lock needed)."""
        if not self.bus.interested(kind):
            return
        if kind is EventKind.TASK_COMPLETED:
            data = {"parent": task.parent.task_id if task.parent else None}
        else:
            data = {}
        seq = shard.seq
        shard.seq = seq + 1
        self.bus.publish(RuntimeEvent(
            kind=kind, time=self.clock(), task_id=task.task_id,
            type_name=task.type_name, cost=task.cost, worker_id=worker_id,
            elapsed=elapsed, seq=seq, data=data))

    # -- submission ------------------------------------------------------

    def submit(self, task: Task) -> bool:
        """Register a task; returns True if it became ready immediately."""
        return bool(self._submit_batch((task,)))

    def submit_all(self, tasks: Iterable[Task]) -> int:
        """Submit many tasks; returns how many became ready."""
        return len(self._submit_batch(tasks))

    def _submit_batch(self, tasks: Iterable[Task]) -> list[Task]:
        """Wire dependencies under the lock; expose the ready ones on the
        global queue only *after* their monitor readies are recorded, so
        no worker can execute a task the monitor never saw enter."""
        quiet = self.bus.interest == _QUIET
        ready: list[Task] = []
        with self._lock:
            for task in tasks:
                self._pending += 1
                unmet = 0
                for d in task.deps:
                    if not d.done:
                        unmet += 1
                        d.successors.append(task)
                task.unmet = unmet
                if not quiet:
                    self._publish_submit(EventKind.TASK_SUBMITTED, task)
                if unmet == 0:
                    ready.append(task)
                    if not quiet:
                        self._publish_submit(EventKind.TASK_READY, task)
        if ready:
            monitor = self.monitor
            if monitor is not None:
                monitor.ready_batch(ready)
            self._global.extend(ready)
        return ready

    # -- polling ---------------------------------------------------------

    def poll(self, worker_id: int) -> Task | None:
        """Pop the next task for ``worker_id``: own shard LIFO, then the
        global queue, then steal.  Lock-free on every path.

        Every probe is length-checked before the pop: spinning workers
        call this millions of times against empty queues, and a raised
        ``IndexError`` costs ~20× the truth test.  The check can go
        stale (a thief drains the queue between test and pop), so the
        pop still catches — the exception is the rare race, not the
        common miss.
        """
        shard = self._shards[worker_id]
        task = None
        q = shard.queue
        if q:
            try:
                task = q.pop()
            except IndexError:
                pass
        if task is None:
            task = self._poll_cold(worker_id, shard)
            if task is None:
                return None
        if self.monitor is not None:
            ops = shard.ops
            ops.append((OP_EXECUTE, task.task_id, task.type_name, task.cost))
            if len(ops) >= self.flush_batch:
                self._flush(shard)
        if self.bus.interest != _QUIET:
            self._publish_worker(EventKind.TASK_EXECUTE, task, shard,
                                 worker_id)
        return task

    def _poll_cold(self, worker_id: int,
                   shard: _WorkerShard) -> Task | None:
        g = self._global
        if g:
            try:
                return g.popleft()
            except IndexError:
                pass
        shards = self._shards
        n = len(shards)
        for i in range(1, n):
            vq = shards[(worker_id + i) % n].queue
            if vq:
                try:
                    task = vq.popleft()
                except IndexError:
                    continue
                shard.steals += 1
                return task
        return None

    def complete(self, task: Task, elapsed: float,
                 worker_id: int) -> list[Task]:
        """Mark done; returns tasks that *became ready* as a result.

        Newly-ready successors are pushed onto the completer's own shard
        (LIFO — they run next, cache-warm) *after* their READY events are
        published, so a thief can never record an EXECUTE that precedes
        the READY in wall time.
        """
        with self._lock:
            task.done = True
            self._pending -= 1
            newly_ready: list[Task] = []
            for s in task.successors:
                s.unmet -= 1
                if s.unmet == 0:
                    newly_ready.append(s)
        shard = self._shards[worker_id]
        if self.monitor is not None:
            ops = shard.ops
            ops.append((OP_COMPLETE, task, elapsed, worker_id,
                        task.parent.task_id if task.parent else None,
                        newly_ready))
            if len(ops) >= self.flush_batch:
                self._flush(shard)
        if self.bus.interest != _QUIET:
            for s in newly_ready:
                self._publish_worker(EventKind.TASK_READY, s, shard,
                                     worker_id)
            self._publish_worker(EventKind.TASK_COMPLETED, task, shard,
                                 worker_id, elapsed=elapsed)
        if newly_ready:
            shard.queue.extend(newly_ready)
        return newly_ready

    # -- monitor flushing ------------------------------------------------

    def _flush(self, shard: _WorkerShard) -> None:
        ops = shard.ops
        shard.ops = []
        self.monitor.flush_ops(ops)

    def flush_worker(self, worker_id: int) -> None:
        """Drain this worker's monitor buffer (no-op when empty) — called
        on every empty poll, so an out-of-work worker's last transitions
        reach the monitor before it spins or parks."""
        if self.monitor is None:
            return
        shard = self._shards[worker_id]
        if shard.ops:
            self._flush(shard)

    def flush_all(self) -> None:
        """Backstop drain of every buffer.  Single-threaded callers only
        (``close()`` after joining the workers): ``ops`` buffers are
        single-writer and must not be flushed out from under a live
        owner."""
        if self.monitor is None:
            return
        for shard in self._shards:
            if shard.ops:
                self._flush(shard)

    # -- state -----------------------------------------------------------

    @property
    def ready_count(self) -> int:
        """Approximate ready-task count (lock-free deque length sums) —
        a wake-heuristic input, not a termination signal."""
        n = len(self._global)
        for s in self._shards:
            n += len(s.queue)
        return n

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    @property
    def steals(self) -> int:
        """Total successful steals across all workers (observability)."""
        return sum(s.steals for s in self._shards)

    def drained(self) -> bool:
        with self._lock:
            return self._pending == 0
