"""Monitoring infrastructure (paper §3.1, Fig. 2).

Tracks, per task type ``j``:

* the **unitary cost** ``α_j`` — an exponentially-weighted average of
  ``measured_time / cost`` over completed instances (rolling window that
  weights recent samples more, per the paper);
* the **workload accounting** ``W_{i,j}`` — the accumulated *cost* of live
  instances per runtime status ``i ∈ {ready, executing}``;
* the **instance counts** ``M_j`` of live instances;
* **prediction accuracy** statistics (paper Table 2).

Executing tasks must not account for their whole predicted time once they
are deep into their execution; the paper handles this through the
parent–child link: when a child finishes, its measured time is subtracted
from the parent's outstanding predicted time.  We implement the same
mechanism (``on_task_completed`` walks the parent link).

Thread-safety: events are aggregated per *worker* into local buffers and
flushed into the shared aggregates at task-completion boundaries, mirroring
the paper's "outside the critical path" design.  A single lock guards the
shared aggregates; buffers keep the lock hold time O(1) per task.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Callable

from ..analysis import guarded_by
from .events import EventBus, EventKind, RuntimeEvent

__all__ = [
    "EMA",
    "TypeMetrics",
    "HeteroTypeSnapshot",
    "TaskMonitor",
    "AccuracyReport",
    "DEFAULT_MIN_SAMPLES",
    "OP_EXECUTE",
    "OP_COMPLETE",
]

#: op tags for the buffered-op batches :meth:`TaskMonitor.flush_ops`
#: consumes (built by per-worker producers, e.g. the sharded scheduler)
OP_EXECUTE = 0
OP_COMPLETE = 1

#: The one repo-wide default for "how many completed samples before a
#: type's unitary cost α_j is trusted" (Alg. 1's reliability threshold).
#: Every stack assembled through :class:`~repro.core.governor.GovernorSpec`
#: inherits it via ``PredictionConfig.min_samples`` — it replaces the old
#: inconsistent defaults (4 in the executors, 3 in the elastic/serving
#: controllers).
DEFAULT_MIN_SAMPLES = 4


class EMA:
    """Exponential moving average with sample-count warmup.

    The paper: "normalized metrics are computed using a rolling window,
    which weights past metrics by their occurrence — the more recent these
    previous metrics are, the more weight they have".  During warmup
    (< ``warmup`` samples) we use the plain mean so the very first noisy
    samples do not dominate.
    """

    __slots__ = ("decay", "warmup", "_value", "_count", "_mean", "_m2")

    def __init__(self, decay: float = 0.25, warmup: int = 8) -> None:
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = decay
        self.warmup = warmup
        self._value: float = 0.0
        self._count: int = 0
        self._mean: float = 0.0  # running mean (also feeds variance)
        self._m2: float = 0.0

    def update(self, sample: float) -> None:
        self._count += 1
        delta = sample - self._mean
        self._mean += delta / self._count
        self._m2 += delta * (sample - self._mean)
        if self._count <= self.warmup:
            self._value = self._mean
        else:
            self._value += self.decay * (sample - self._value)

    @property
    def value(self) -> float:
        return self._value

    @property
    def count(self) -> int:
        return self._count

    @property
    def stddev(self) -> float:
        if self._count < 2:
            return 0.0
        return math.sqrt(self._m2 / (self._count - 1))

    def reliable(self, min_samples: int) -> bool:
        return self._count >= min_samples


@dataclass
class TypeMetrics:
    """Aggregated metrics for one task type (the ``j`` index of Alg. 1)."""

    name: str
    unitary_cost: EMA = field(default_factory=EMA)
    #: per-core-type unitary costs α_{j,c} — an E-core's elapsed/cost is
    #: systematically larger than a P-core's, so mixing them in one EMA
    #: biases the prediction on asymmetric machines
    per_core: dict[str, EMA] = field(default_factory=dict)
    # Live workload accounting, in *cost units* (multiplied by α_j on read).
    ready_cost: float = 0.0
    executing_cost: float = 0.0
    ready_instances: int = 0
    executing_instances: int = 0
    # Accuracy accounting (paper Table 2).
    acc_sum: float = 0.0
    acc_count: int = 0
    completed: int = 0
    #: instances that left the system without executing to completion
    #: (admission shed, queue eviction, deadline/retry-budget exhaustion)
    shed: int = 0

    @property
    def live_instances(self) -> int:
        return self.ready_instances + self.executing_instances

    @property
    def live_cost(self) -> float:
        return self.ready_cost + self.executing_cost


@dataclass(frozen=True)
class HeteroTypeSnapshot:
    """Per-task-type Alg.-1 inputs with the per-core-type α split.

    ``alpha_by_core`` maps core-type name → (α_{j,c}, sample count,
    reliable) for every core type that has completed samples.
    """

    name: str
    live_cost: float
    alpha: float
    live_instances: int
    reliable: bool
    alpha_by_core: dict[str, tuple[float, int, bool]]


@dataclass(frozen=True)
class AccuracyReport:
    """Per-type and overall prediction accuracy (reproduces Table 2)."""

    per_type: dict[str, tuple[int, float]]  # type -> (#instances, avg %)
    instances: int
    average_pct: float | None  # None ⇔ "NA" (no timing predictions made)


@guarded_by("_types", "_outstanding", "_predicted_at_start",
            "_subscribed_buses", "_direct_buses", "version",
            "_core_type_of", "_freq_of", "_suspect_of")
class TaskMonitor:
    """The shared monitoring module (paper Fig. 2, left box)."""

    def __init__(self, decay: float = 0.25, warmup: int = 8,
                 min_samples: int = DEFAULT_MIN_SAMPLES) -> None:
        self._lock = threading.Lock()
        self._types: dict[str, TypeMetrics] = {}
        self._decay = decay
        self._warmup = warmup
        self.min_samples = min_samples
        # Outstanding *predicted seconds* per live task id — used for the
        # parent–child subtraction and for accuracy accounting.
        self._outstanding: dict[int, float] = {}
        self._predicted_at_start: dict[int, float] = {}
        self._subscribed_buses: list[EventBus] = []
        # Buses whose lifecycle events already reach this monitor through
        # a direct driver (a Scheduler) — subscribing to one of these
        # would double-count, so subscribe() no-ops on them.
        self._direct_buses: list[EventBus] = []
        #: mutation counter bumped by every lifecycle update — lets the
        #: predictor skip recomputing Alg. 1 on ticks that fire inside
        #: an unchanged window (pure function of the snapshot)
        self.version = 0
        # Worker id → core-type name; set by topology-aware frontends so
        # completion events feed the per-(type × core-type) α_{j,c}.
        self._core_type_of: Callable[[int], str] | None = None
        self._freq_of: Callable[[int], float] | None = None
        # Worker id → "is this core a suspected straggler?"; set by
        # condition-aware frontends.  Samples from suspect cores are
        # excluded from the α EMAs — one sick core must not poison the
        # global cost model (throttled cores need no exclusion: their
        # dilation is already corrected by the frequency term).
        self._suspect_of: Callable[[int], bool] | None = None

    def set_core_type_of(self, fn: Callable[[int], str] | None,
                         freq_of: Callable[[int], float] | None = None,
                         ) -> None:
        """Teach the monitor which core type each worker id runs on —
        and, on DVFS machines, which frequency step, so α_{j,c} samples
        are normalized to full speed (a sample measured at q=0.75 bakes
        in the 1/q dilation; feeding it back raw would double-count the
        slowdown against the planner's own /q and oscillate)."""
        with self._lock:
            self._core_type_of = fn
            self._freq_of = freq_of

    def set_suspect_of(self, fn: Callable[[int], bool] | None) -> None:
        """Teach the monitor which worker ids are suspected stragglers
        (see :class:`~repro.core.conditions.MachineConditions`); their
        completion samples skip the α EMAs."""
        with self._lock:
            self._suspect_of = fn

    # -- event-bus subscription -------------------------------------------
    # The monitor is ONE subscriber on the runtime event bus, not the
    # hard-wired callback target of the scheduler: anything that can see
    # the bus (trace recorders, live dashboards) observes exactly the
    # same lifecycle stream the monitor aggregates.

    _LIFECYCLE_KINDS = (EventKind.TASK_READY, EventKind.TASK_EXECUTE,
                        EventKind.TASK_COMPLETED)

    def mark_direct_driven(self, bus: EventBus) -> None:
        """Record that a producer on ``bus`` (a Scheduler) feeds this
        monitor directly: a later :meth:`subscribe` on the same bus
        no-ops instead of double-counting every lifecycle event — the
        same safety the old monitor-as-subscriber wiring got from
        subscribe()'s idempotence."""
        with self._lock:
            if not any(b is bus for b in self._direct_buses):
                self._direct_buses.append(bus)

    def subscribe(self, bus: EventBus) -> "TaskMonitor":
        """Attach this monitor to ``bus`` (idempotent per bus — e.g. a
        governor-owned monitor handed to a Scheduler that shares the
        same bus must not double-count events; a bus already direct-
        driven by a Scheduler is a no-op for the same reason)."""
        with self._lock:
            if any(b is bus for b in self._subscribed_buses):
                return self
            if any(b is bus for b in self._direct_buses):
                return self
            self._subscribed_buses.append(bus)
        bus.subscribe(self._on_event, kinds=self._LIFECYCLE_KINDS)
        return self

    def unsubscribe(self, bus: EventBus) -> None:
        """Detach from ``bus`` (no-op if not subscribed) — run teardown
        for per-run monitors sharing a longer-lived bus."""
        with self._lock:
            if not any(b is bus for b in self._subscribed_buses):
                return
            self._subscribed_buses = [b for b in self._subscribed_buses
                                      if b is not bus]
        bus.unsubscribe(self._on_event)

    def _on_event(self, ev: RuntimeEvent) -> None:
        if ev.task_id is None or ev.type_name is None or ev.cost is None:
            raise ValueError(
                f"malformed {ev.kind.value} event: task_id, type_name "
                f"and cost are required, got {ev!r}")
        if ev.kind is EventKind.TASK_READY:
            self.on_task_ready(ev.task_id, ev.type_name, ev.cost)
        elif ev.kind is EventKind.TASK_EXECUTE:
            self.on_task_execute(ev.task_id, ev.type_name, ev.cost)
        elif ev.kind is EventKind.TASK_COMPLETED:
            core_type = (self._core_type_of(ev.worker_id)
                         if (self._core_type_of is not None
                             and ev.worker_id is not None) else None)
            freq = (self._freq_of(ev.worker_id)
                    if (self._freq_of is not None
                        and ev.worker_id is not None) else 1.0)
            suspect = (self._suspect_of(ev.worker_id)
                       if (self._suspect_of is not None
                           and ev.worker_id is not None) else False)
            self.on_task_completed(ev.task_id, ev.type_name, ev.cost,
                                   ev.elapsed if ev.elapsed is not None
                                   else 0.0,
                                   parent_id=ev.data.get("parent"),
                                   core_type=core_type, freq=freq,
                                   suspect=suspect)

    # -- type helpers ------------------------------------------------------

    def _metrics(self, type_name: str) -> TypeMetrics:  # analysis: caller-locks
        m = self._types.get(type_name)
        if m is None:
            m = TypeMetrics(name=type_name,
                            unitary_cost=EMA(self._decay, self._warmup))
            self._types[type_name] = m
        return m

    def type_names(self) -> list[str]:
        with self._lock:
            return list(self._types)

    # -- lifecycle events --------------------------------------------------
    # Event methods take (task_id, type_name, cost) rather than a Task
    # object so the monitor has no dependency on the runtime layer.

    def on_task_ready(self, task_id: int, type_name: str, cost: float) -> None:
        """Task became ready (dependencies satisfied / created ready)."""
        with self._lock:
            self._ready_locked(task_id, type_name, cost)

    def _ready_locked(self, task_id: int, type_name: str,
                      cost: float) -> None:
        self.version += 1
        m = self._types.get(type_name)
        if m is None:
            m = self._metrics(type_name)
        m.ready_cost += cost
        m.ready_instances += 1
        # Record the prediction that Alg. 1 would make for this task
        # right now; accuracy is evaluated against it on completion.
        # (EMA reads inlined — once per task on the hot path.)
        ema = m.unitary_cost
        if ema._count >= self.min_samples:
            predicted = cost * ema._value
            self._outstanding[task_id] = predicted
            self._predicted_at_start[task_id] = predicted

    def on_task_execute(self, task_id: int, type_name: str, cost: float) -> None:
        """Task moved ready → executing."""
        with self._lock:
            self._execute_locked(task_id, type_name, cost)

    def _execute_locked(self, task_id: int, type_name: str,
                        cost: float) -> None:
        self.version += 1
        m = self._types.get(type_name)
        if m is None:
            m = self._metrics(type_name)
        m.ready_cost -= cost
        m.ready_instances -= 1
        m.executing_cost += cost
        m.executing_instances += 1

    def on_task_completed(self, task_id: int, type_name: str, cost: float,
                          elapsed: float,
                          parent_id: int | None = None,
                          core_type: str | None = None,
                          freq: float = 1.0,
                          suspect: bool = False) -> None:
        """Task finished; fold the measured time into the aggregates.

        ``freq`` is the DVFS step the task ran at: the per-core α_{j,c}
        stores the full-speed cost (``elapsed · freq``), keeping the
        planner's capacity math frequency-independent.  ``suspect``
        marks a sample from a suspected-straggler core: its timing is
        excluded from the α EMAs (accuracy accounting stays honest)."""
        with self._lock:
            self._completed_locked(task_id, type_name, cost, elapsed,
                                   parent_id, core_type, freq, suspect)

    def on_task_shed(self, task_id: int, type_name: str,
                     cost: float) -> None:
        """A *ready* task left the system without executing (shed by
        admission control, evicted from a full queue, or abandoned after
        its deadline/retry budget ran out): reverse the ready
        registration and drop its outstanding prediction — shed work
        must stop inflating Δ, and a prediction that was never given a
        chance to run must not poison the accuracy statistics.  A task
        shed *mid-execution* goes through :meth:`on_task_abort` first
        (executing → ready), then here (ready → gone)."""
        with self._lock:
            self.version += 1
            m = self._types.get(type_name)
            if m is None:
                m = self._metrics(type_name)
            m.ready_cost -= cost
            m.ready_instances -= 1
            m.shed += 1
            self._predicted_at_start.pop(task_id, None)
            self._outstanding.pop(task_id, None)

    def shed_instances(self) -> int:
        with self._lock:
            return sum(m.shed for m in self._types.values())

    def on_task_abort(self, task_id: int, type_name: str,
                      cost: float) -> None:
        """An *executing* task was torn off its core (core failure) and
        requeued: reverse the executing → ready transition so the live
        workload accounting matches the scheduler's ready queue.  The
        prediction recorded at the original ready stands — the eventual
        re-execution completes against it."""
        with self._lock:
            self.version += 1
            m = self._types.get(type_name)
            if m is None:
                m = self._metrics(type_name)
            m.executing_cost -= cost
            m.executing_instances -= 1
            m.ready_cost += cost
            m.ready_instances += 1

    def _completed_locked(self, task_id: int, type_name: str, cost: float,
                          elapsed: float, parent_id: int | None,
                          core_type: str | None, freq: float,
                          suspect: bool = False) -> None:
        self.version += 1
        m = self._types.get(type_name)
        if m is None:
            m = self._metrics(type_name)
        m.executing_cost -= cost
        m.executing_instances -= 1
        m.completed += 1
        if elapsed > 0.0 and cost > 0.0 and not suspect:
            m.unitary_cost.update(elapsed / cost)
            if core_type is not None:
                ema = m.per_core.get(core_type)
                if ema is None:
                    ema = m.per_core[core_type] = EMA(self._decay,
                                                      self._warmup)
                ema.update(elapsed * freq / cost)
        # Accuracy (Table 2): compare against prediction-at-ready.
        predicted = self._predicted_at_start.pop(task_id, None)
        self._outstanding.pop(task_id, None)
        if predicted is not None and predicted > 0.0 and elapsed > 0.0:
            acc = 100.0 * (1.0 - abs(predicted - elapsed)
                           / max(predicted, elapsed))
            m.acc_sum += acc
            m.acc_count += 1
        # Parent–child link: the child's measured time no longer
        # belongs to the parent's outstanding predicted time.
        if parent_id is not None and parent_id in self._outstanding:
            self._outstanding[parent_id] = max(
                0.0, self._outstanding[parent_id] - elapsed)

    def completion_batch(self, task, elapsed: float,
                         worker_id: int | None,
                         parent_id: int | None, newly_ready) -> None:
        """Fold one completion plus the tasks it made ready into the
        aggregates under a *single* lock acquisition — the hot-path entry
        the :class:`~repro.runtime.scheduler.Scheduler` drives directly
        (per-event bus dispatch paid one event object + one lock
        round-trip for each of the 1 + N transitions).

        ``task``/``newly_ready`` items are duck-typed (``task_id``,
        ``type_name``, ``cost`` attributes) so the monitor keeps no
        dependency on the runtime layer.  Readies are applied *before*
        the completion — the same order the per-event path produced
        (successors enter the ready queue before the finisher's α
        update), which parity tests pin bit-for-bit.
        """
        core_type = (self._core_type_of(worker_id)
                     if (self._core_type_of is not None
                         and worker_id is not None) else None)
        freq = (self._freq_of(worker_id)
                if (self._freq_of is not None
                    and worker_id is not None) else 1.0)
        suspect = (self._suspect_of(worker_id)
                   if (self._suspect_of is not None
                       and worker_id is not None) else False)
        with self._lock:
            for t in newly_ready:
                self._ready_locked(t.task_id, t.type_name, t.cost)
            self._completed_locked(task.task_id, task.type_name, task.cost,
                                   elapsed, parent_id, core_type, freq,
                                   suspect)

    def ready_batch(self, tasks) -> None:
        """Fold many just-became-ready tasks in under a *single* lock
        acquisition — the submit-side twin of :meth:`completion_batch`
        (a whole-graph ``submit_all`` used to pay one monitor lock
        round-trip per ready root).  Items are duck-typed like
        :meth:`completion_batch`'s."""
        with self._lock:
            for t in tasks:
                self._ready_locked(t.task_id, t.type_name, t.cost)

    def flush_ops(self, ops) -> None:
        """Apply one worker's *buffered* lifecycle ops under a single
        lock acquisition — the multi-threaded generalization of
        :meth:`completion_batch` that the sharded real-thread scheduler
        drives: each worker accumulates its execute/complete transitions
        locally and hands a batch over at flush points, so N spinning
        workers stop serializing on this lock once per transition.

        ``ops`` entries are tuples tagged by their first element:

        * ``(OP_EXECUTE, task_id, type_name, cost)`` — ready → executing;
        * ``(OP_COMPLETE, task, elapsed, worker_id, parent_id,
          newly_ready)`` — one completion plus the tasks it made ready
          (applied readies-first, exactly like :meth:`completion_batch`).

        Because each worker flushes independently, ops from *different*
        workers may be applied out of their global wall-clock order (a
        stolen successor's execute can land before the completion that
        readied it); the aggregates are sums and EMAs, so they converge
        to the identical totals, and the transient skew is bounded by
        the flush batch size.
        """
        with self._lock:
            core_type_of = self._core_type_of
            freq_of = self._freq_of
            suspect_of = self._suspect_of
            for op in ops:
                if op[0] == OP_EXECUTE:
                    self._execute_locked(op[1], op[2], op[3])
                else:
                    _, task, elapsed, worker_id, parent_id, newly = op
                    for t in newly:
                        self._ready_locked(t.task_id, t.type_name, t.cost)
                    core_type = (core_type_of(worker_id)
                                 if (core_type_of is not None
                                     and worker_id is not None) else None)
                    freq = (freq_of(worker_id)
                            if (freq_of is not None
                                and worker_id is not None) else 1.0)
                    suspect = (suspect_of(worker_id)
                               if (suspect_of is not None
                                   and worker_id is not None) else False)
                    self._completed_locked(task.task_id, task.type_name,
                                           task.cost, elapsed, parent_id,
                                           core_type, freq, suspect)

    # -- snapshot for the predictor (Alg. 1 inputs) --------------------------

    def workload_snapshot(self, min_samples: int | None = None) -> list[
            tuple[str, float, float, int, bool]]:
        """Return ``[(type, W_ready+W_exec (cost units), α_j, M_j, reliable)]``.

        ``reliable`` is False while a type has too few completed samples to
        trust its unitary cost — Alg. 1 then falls back to counting tasks
        (the paper's "go-to approach when task timing predictions are not
        available").
        """
        k = self.min_samples if min_samples is None else min_samples
        out = []
        with self._lock:
            for name, m in self._types.items():
                # inlined live_instances/live_cost/EMA reads — this runs
                # once per prediction tick with the lock held
                live = m.ready_instances + m.executing_instances
                if live <= 0:
                    continue
                ema = m.unitary_cost
                out.append((
                    name,
                    m.ready_cost + m.executing_cost,
                    ema._value,
                    live,
                    ema._count >= k,
                ))
        return out

    def workload_snapshot_hetero(self, min_samples: int | None = None,
                                 ) -> list[HeteroTypeSnapshot]:
        """Like :meth:`workload_snapshot`, with the per-core-type α split
        the heterogeneous predictor needs (Δ_c fills fastest cores first
        using α_{j,c} normalized by core speed)."""
        k = self.min_samples if min_samples is None else min_samples
        out = []
        with self._lock:
            for name, m in self._types.items():
                if m.live_instances <= 0:
                    continue
                out.append(HeteroTypeSnapshot(
                    name=name,
                    live_cost=m.live_cost,
                    alpha=m.unitary_cost.value,
                    live_instances=m.live_instances,
                    reliable=m.unitary_cost.reliable(k),
                    alpha_by_core={c: (e.value, e.count, e.reliable(k))
                                   for c, e in m.per_core.items()},
                ))
        return out

    def fold_gamma(self, k: int, rate_s: float, count_based_only: bool,
                   limit: float | None) -> tuple[float, int]:
        """Fused Algorithm-1 γ accumulation — one pass over the live
        types under one lock, no snapshot list.  This is the predictor's
        per-tick hot path; :meth:`workload_snapshot` remains the
        observable (list-building) form.

        Returns ``(γ, total_live_instances)``.  ``limit`` is the
        paper's early-exit bound (``while γ < N_CPUs``); None disables
        it (oversubscribing DLB mode).  Term order and arithmetic match
        :meth:`~repro.core.prediction.CPUPredictor.compute_delta`'s
        original snapshot loop exactly.
        """
        gamma = 0.0
        total = 0
        with self._lock:
            for m in self._types.values():
                live = m.ready_instances + m.executing_instances
                if live <= 0:
                    continue
                total += live
                if limit is not None and gamma >= limit:
                    continue
                ema = m.unitary_cost
                if count_based_only or ema._count < k:
                    gamma += live
                else:
                    gamma += ((m.ready_cost + m.executing_cost)
                              * ema._value) / rate_s
        return gamma, total

    def outstanding_seconds(self, min_samples: int | None = None) -> tuple[float, int, int]:
        """Aggregate (predicted_seconds, live_instances, unreliable_instances).

        ``predicted_seconds`` covers only types with reliable α_j.
        """
        pred = 0.0
        live = 0
        unreliable = 0
        for _, w, alpha, m_j, ok in self.workload_snapshot(min_samples):
            live += m_j
            if ok:
                pred += w * alpha
            else:
                unreliable += m_j
        return pred, live, unreliable

    # -- reporting -----------------------------------------------------------

    def unitary_cost(self, type_name: str,
                     core_type: str | None = None) -> float | None:
        with self._lock:
            m = self._types.get(type_name)
            if m is None:
                return None
            ema = (m.unitary_cost if core_type is None
                   else m.per_core.get(core_type))
            if ema is None or ema.count == 0:
                return None
            return ema.value

    def accuracy_report(self) -> AccuracyReport:
        with self._lock:
            per_type: dict[str, tuple[int, float]] = {}
            total_acc = 0.0
            total_n = 0
            for name, m in self._types.items():
                if m.acc_count:
                    per_type[name] = (m.acc_count, m.acc_sum / m.acc_count)
                    total_acc += m.acc_sum
                    total_n += m.acc_count
            return AccuracyReport(
                per_type=per_type,
                instances=total_n,
                average_pct=(total_acc / total_n) if total_n else None,
            )

    def completed_instances(self) -> int:
        with self._lock:
            return sum(m.completed for m in self._types.values())

    def live_instances(self) -> int:
        """Total live (ready + executing) instances across all types —
        the load signal pull-style frontends hand to ``target()``."""
        with self._lock:
            return sum(m.live_instances for m in self._types.values())
