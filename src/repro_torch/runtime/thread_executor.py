"""Real threaded executor.

Runs task graphs with actual Python threads — the correctness twin of the
simulator (same governor-assembled WorkerManager / Policy / TaskMonitor
objects).  Python's GIL means no true parallel speedup on this host; the
executor exists to validate the concurrency logic (locking, idle/resume
protocol, monitor event ordering) under real preemption, and to measure
the *real* bookkeeping overhead of the monitoring infrastructure
(``benchmarks/bench_overhead.py`` / ``bench_threadperf.py``).

The whole resource stack is declared by a
:class:`~repro.core.governor.GovernorSpec` and assembled by
:class:`~repro.core.governor.ResourceGovernor`; the executor owns the
threads, the per-worker wake events and the scheduler.

Hot-path structure (the PR-5 discipline on real threads):

* ready queues are **sharded per worker** with work stealing
  (:class:`~repro.runtime.sharded.ShardedScheduler`) — poll and the
  successor handoff are lock-free;
* monitor updates are **buffered per worker** and flushed in batches
  (one ``TaskMonitor`` lock acquisition per ~32 transitions);
* idle workers park on a **per-worker** ``threading.Event`` and are
  woken *individually* by the manager's targeted waker — no
  ``notify_all`` broadcast, no 50 ms wake-poll;
* the spin loop of a never-idling policy (``busy``) skips the per-poll
  manager round-trip entirely.

Two execution modes share the worker loop:

* **closed** — :meth:`run` submits a whole graph at t=0 and drains it
  (the classic batch mode; with ``arrivals`` the graph is instead
  released over wall time from the arrival timeline);
* **open** — :meth:`start` spawns workers with no work, :meth:`submit`
  feeds tasks incrementally from any thread, and :meth:`close` waits for
  arrivals to stop and the queue to drain (termination = closed ∧
  drained).  :meth:`submit` after :meth:`close` raises — the task could
  never run.

All task lifecycle, worker state and prediction events are published on
``self.bus`` — attach a :class:`~repro.trace.TraceRecorder` to record a
run for deterministic what-if replay in the simulator (worker-side
events carry per-stream sequence stamps; the recorder merge-sorts them
back into canonical order at flush time).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

from ..analysis import guarded_by
from ..core.energy import PowerModel
from ..core.events import EventBus
from ..core.governor import (DEFAULT_MIN_SAMPLES, GovernorReport,
                             GovernorSpec, ResourceGovernor)
from ..core.manager import WorkerState
from ..core.policies import PollDecision
from ..core.prediction import PredictionConfig
from ..workloads.arrivals import ArrivalProcess
from .sharded import ShardedScheduler
from .task import Task, TaskGraph

__all__ = ["ThreadExecutor", "ExecutorReport"]

#: kept as an alias so downstream code reads one schema everywhere
ExecutorReport = GovernorReport

#: belt-and-suspenders re-check interval for a parked worker — the
#: targeted wake event is the real signal (plus the ≥1 ms ticker's
#: anti-starvation resume path); a timeout firing means both were
#: missed, and the executor counts it (see ``wake_timeouts``)
_IDLE_RECHECK_S = 0.5

#: spin pacing: a worker that keeps missing yields the GIL bare for the
#: first N polls (immediate pickup of fresh work), then naps briefly
#: between polls.  The lock-free poll made a spin iteration so short
#: that N spinners hot-yielding starved the threads with actual work of
#: GIL time (the old globally-locked poll throttled spinners by
#: *blocking* them); the nap restores that pacing with a bounded,
#: explicit cost — worst-case extra pickup latency is one nap.
_SPIN_YIELDS = 10
_SPIN_NAP_S = 50e-6


@guarded_by("_submitted_total", lock="_submit_lock")
class ThreadExecutor:
    def __init__(self, n_workers: int | None = None, policy: str = "busy",
                 spec: GovernorSpec | None = None,
                 monitoring: bool | None = None,
                 prediction_rate_s: float = 1e-3,
                 spin_budget: int = 100,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 power: PowerModel | None = None,
                 bus: EventBus | None = None) -> None:
        if spec is None:
            if n_workers is None:
                raise ValueError("need n_workers (or a GovernorSpec)")
            if n_workers < 1:
                raise ValueError("need at least one worker")
            spec = GovernorSpec(
                resources=n_workers, policy=policy,
                prediction=PredictionConfig(rate_s=prediction_rate_s,
                                            min_samples=min_samples),
                spin_budget=spin_budget, monitoring=monitoring, power=power)
        self.spec = spec
        self.n_workers = spec.resources
        self.policy_name = spec.policy
        self._t0 = time.perf_counter()
        self.bus = bus if bus is not None else EventBus()
        self.governor = ResourceGovernor(spec, clock=self._clock,
                                         bus=self.bus)
        if self.governor.sharing:
            raise ValueError(
                "LEND policies need a broker-aware executor (use the "
                "simulator for DLB experiments)")
        self.monitor = self.governor.monitor
        self.predictor = self.governor.predictor
        self.policy = self.governor.policy
        self.energy = self.governor.energy
        self.manager = self.governor.manager
        self.scheduler = ShardedScheduler(self.n_workers, self.monitor,
                                          bus=self.bus, clock=self._clock)
        # Alg. 1 uses spec.prediction.rate_s for its workload math, but a
        # real-time ticker thread cannot honor microsecond rates (the
        # simulator's 50 µs default would busy-loop a core); floor the
        # wall-clock tick interval at 1 ms.
        self.prediction_rate_s = max(spec.prediction.rate_s, 1e-3)
        # Per-worker park/wake events: the manager's targeted waker sets
        # exactly the resumed worker's event (Event construction is
        # fine here — the executor's own lock discipline covers only
        # _submit_lock; Events park, they do not guard state).
        self._wake = {w: threading.Event() for w in range(self.n_workers)}
        self.manager.set_waker(self._wake_worker)
        # Diagnostics: a parked worker that resumed via the 0.5 s
        # re-check timeout instead of its wake event (or shutdown).
        # Single-writer per slot (the owning worker).
        self._wake_timeouts = [0] * self.n_workers
        self._shutdown = False
        # Open-workload mode: while the run is "open", a drained queue
        # does NOT terminate the workers — more submissions may arrive.
        self._closing = False
        self._threads: list[threading.Thread] = []
        self._ticker_thread: threading.Thread | None = None
        self._t_start: float | None = None
        self._submit_lock = threading.Lock()
        self._submitted_total = 0

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def _wake_worker(self, worker_id: int) -> None:
        self._wake[worker_id].set()

    @property
    def wake_timeouts(self) -> int:
        """How many times a parked worker resumed via the re-check
        timeout rather than a targeted wake — 0 on a healthy run whose
        idle stretches are shorter than the re-check interval (the
        missed-wakeup regression signal)."""
        return sum(self._wake_timeouts)

    # -- worker loop -----------------------------------------------------------

    def _worker(self, wid: int) -> None:
        scheduler = self.scheduler
        governor = self.governor
        manager = self.manager
        busy_spin = self.policy.never_idles
        wake = self._wake[wid]
        misses = 0
        while True:
            task = scheduler.poll(wid)
            if task is not None:
                misses = 0
                governor.on_task_started(wid)
                t0 = time.perf_counter()
                if task.fn is not None:
                    task.fn()
                elif task.service_time is not None:
                    time.sleep(task.service_time)
                elapsed = time.perf_counter() - t0
                governor.on_task_finished(wid)
                newly = scheduler.complete(task, elapsed, worker_id=wid)
                if newly and not busy_spin:
                    # Never-idling policies have nobody to wake (no
                    # worker ever parks), so skip the per-completion
                    # manager round-trip; successors are already visible
                    # on this worker's shard for everyone to steal.
                    self._on_work_added()
                if self._closing and scheduler.drained():
                    self._finish()
                continue
            # Out of work (from this shard's view): the monitor must not
            # run stale while we spin or park.
            scheduler.flush_worker(wid)
            if self._shutdown:
                return
            misses += 1
            if busy_spin:
                # Never-idling policy: the decision is always SPIN, so
                # skip the per-poll manager lock round-trip.
                time.sleep(0 if misses <= _SPIN_YIELDS else _SPIN_NAP_S)
                continue
            decision = governor.on_poll_empty(wid)
            if decision is PollDecision.SPIN:
                time.sleep(0 if misses <= _SPIN_YIELDS else _SPIN_NAP_S)
                continue
            if decision is PollDecision.IDLE:
                # Park on our own event.  Clearing *before* the state
                # check makes the race benign in both directions: a wake
                # that lands before the clear has already made the SPIN
                # transition visible (the waker runs after the manager
                # lock is released), so the check breaks the loop; one
                # that lands after the clear trips wait() immediately.
                wake.clear()
                while (manager.state_of(wid) is WorkerState.IDLE
                       and not self._shutdown):
                    if wake.wait(timeout=_IDLE_RECHECK_S):
                        wake.clear()
                    else:
                        self._wake_timeouts[wid] += 1
                continue
            raise RuntimeError(
                "LEND decisions need a broker-aware executor (use the "
                "simulator for DLB experiments)")

    def _on_work_added(self) -> None:
        # The manager's targeted waker (set_waker) delivers the actual
        # wakes — one Event.set per resumed worker, not notify_all.
        self.governor.on_tasks_added(self.scheduler.ready_count)

    def _finish(self) -> None:
        self._shutdown = True
        for ev in self._wake.values():
            ev.set()   # unpark everyone so they can observe shutdown

    def _ticker(self) -> None:
        while not self._shutdown:
            time.sleep(self.prediction_rate_s)
            if self._shutdown:
                return
            self.governor.tick()
            if self.policy.uses_predictions:
                self.governor.reevaluate_spinners()
            # Anti-starvation: if ready work exists, apply the resume path.
            if self.scheduler.ready_count > 0:
                self._on_work_added()

    # -- open-workload API ----------------------------------------------------

    def start(self) -> "ThreadExecutor":
        """Spawn workers with no work yet; feed them via :meth:`submit`.

        The run stays open — workers park/spin through empty phases per
        policy — until :meth:`close` is called.
        """
        if self._threads:
            raise RuntimeError("executor already started")
        self._threads = [threading.Thread(target=self._worker, args=(w,),
                                          name=f"worker-{w}", daemon=True)
                         for w in range(self.n_workers)]
        self._ticker_thread = threading.Thread(target=self._ticker,
                                               name="ticker", daemon=True)
        self._t_start = time.perf_counter()
        # Re-epoch the clock: the energy meter has been integrating SPIN
        # power since construction, but the run starts now — otherwise an
        # executor built ahead of its first submission (the natural open-
        # mode shape) reports energy over a window makespan never covers.
        self._t0 = self._t_start
        for t in self._threads:
            t.start()
        self._ticker_thread.start()
        return self

    def submit(self, work: Task | TaskGraph | Iterable[Task]) -> int:
        """Incrementally submit a task, a graph, or an iterable of tasks;
        returns how many became ready immediately.  Thread-safe; callable
        before :meth:`start` (work queues up) or while running — but not
        once :meth:`close` has been called (the run is draining; the
        submission would sit in the queue forever)."""
        if self._closing:
            raise RuntimeError(
                "submit() after close(): the executor is draining and no "
                "worker will ever run this task")
        if isinstance(work, Task):
            tasks: list[Task] = [work]
        elif isinstance(work, TaskGraph):
            tasks = work.tasks
        else:
            tasks = list(work)
        with self._submit_lock:
            self._submitted_total += len(tasks)
        n_ready = self.scheduler.submit_all(tasks)
        if n_ready:
            self._on_work_added()
        return n_ready

    def close(self) -> GovernorReport:
        """No more submissions: wait until drained, stop workers, report.

        Termination = arrivals exhausted (the caller stopped submitting)
        ∧ queue drained — the open-workload contract.
        """
        if not self._threads:
            raise RuntimeError("executor was never started")
        self._closing = True
        if self.scheduler.drained():
            self._finish()
        for t in self._threads:
            t.join()
        assert self._ticker_thread is not None
        self._ticker_thread.join()
        assert self._t_start is not None
        makespan = time.perf_counter() - self._t_start
        # Workers flush their buffers on the way out; this backstop
        # covers buffers a crashed task's thread left behind.
        self.scheduler.flush_all()
        self.governor.finish(self._clock())
        return self.governor.report(makespan=makespan,
                                    tasks_fallback=self._submitted_total)

    # -- public API -----------------------------------------------------------------

    def run(self, graph: TaskGraph,
            arrivals: ArrivalProcess | None = None) -> GovernorReport:
        """Execute ``graph`` to completion and report.

        Without ``arrivals`` this is the closed-world batch mode (whole
        graph submitted at t=0) — unless tasks carry pre-stamped
        ``release_time``\\ s (e.g. a replayed trace), which are honored
        exactly like the simulator honors them.  With ``arrivals``,
        tasks are released over wall time following the process timeline
        — an open-workload run on real threads.
        """
        if not graph.tasks:
            # A graph with no tasks is already drained: report without
            # spawning workers (a worker-side shutdown could otherwise
            # never trigger — it only fires on task completion).
            self.governor.finish(self._clock())
            return self.governor.report(makespan=0.0)
        if arrivals is not None:
            timed = list(zip(graph.tasks, arrivals.assign(graph.tasks)))
        else:
            timed = [(t, t.release_time or 0.0) for t in graph.tasks]
            timed.sort(key=lambda p: p[1])   # pre-stamped order is free
        if timed[-1][1] <= 0.0:
            # Submit before flagging the drain — submit() refuses work
            # once _closing is set, and no worker is running yet.
            self.submit(graph)
            self._closing = True
            self.start()
            return self.close()
        # Open mode: this thread plays the arrival timeline in real time.
        self.start()
        t_begin = time.perf_counter()
        for task, rt in timed:
            delay = rt - (time.perf_counter() - t_begin)
            if delay > 0:
                time.sleep(delay)
            self.submit(task)
        return self.close()
