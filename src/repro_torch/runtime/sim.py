"""Discrete-event simulator (virtual time) for policy dynamics.

The container has one physical core; the paper's machines have 48/64.  The
simulator executes task graphs against a :class:`MachineModel` in virtual
time, driving the *real* policy / manager / monitor / predictor / broker
code (the same objects used by the threaded executor), so policy behaviour
— idle/resume churn, spin energy, DLB call counts, prediction dynamics —
is reproduced deterministically.

Event model (no poll storms):

* Workers entering ``SPIN`` poll **once**; an empty poll either parks them
  (busy/prediction: they are woken by work arrival or a prediction tick)
  or schedules a single ``SPIN_EXPIRE`` event (hybrid-style budgets are
  collapsed into one event via ``spin_count_override``).
* Work arrival dispatches to spinning workers instantly (the "instant
  reaction" of busy polling), then applies Alg. 2 resumes (with
  ``resume_latency``), then DLB acquisition for sharing policies.
* Prediction ticks fire every ``f`` virtual seconds, re-evaluating
  spinning workers (trim) and idle workers (grow) — §3.1: "the current
  number of CPUs can progressively be trimmed or increased to meet the
  prediction".

Spin time is integrated continuously by the :class:`EnergyMeter` (a parked
spinning worker burns ``P_spin`` for the whole interval), so avoiding poll
events does not distort energy.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, replace
from typing import Any

from ..core.arbiter import AppPlan, ClusterArbiter
from ..core.conditions import (ConditionTimeline, MachineConditions,
                               Perturbation, PerturbationKind)
from ..core.energy import PowerModel
from ..core.events import EventBus, EventKind, RuntimeEvent
from ..core.governor import (DEFAULT_MIN_SAMPLES, GovernorReport,
                             GovernorSpec, ResourceGovernor)
from ..core.manager import WorkerState
from ..core.policies import PollDecision
from ..core.prediction import DEFAULT_PREDICTION_RATE_S, PredictionConfig
from ..core.sharing import ResourceBroker
from ..core.topology import CoreTopology
from ..workloads.arrivals import ArrivalProcess
from .cluster import ClusterModel
from .machine import MachineModel
from .scheduler import Scheduler
from .task import Task, TaskGraph

__all__ = ["SimJobSpec", "SimReport", "SimCluster", "SimExecutor"]

#: kept as an alias so downstream code reads one schema everywhere
SimReport = GovernorReport

# Event kinds (sorted lexically only via seq tiebreak; kind order irrelevant)
# _FAULT/_THROTTLE/_POWER fire machine-condition perturbations (fail /
# recover / straggle, thermal caps, power caps) from a ConditionTimeline.
(_FINISH, _TICK, _RESUME, _SPIN_EXPIRE, _ARRIVE,
 _FAULT, _THROTTLE, _POWER) = range(8)

_heappush = heapq.heappush


@dataclass
class SimJobSpec:
    """Declarative description of one job in the cluster.

    The resource stack is described by ``governor`` (a
    :class:`~repro.core.governor.GovernorSpec`); the flat kwargs below it
    remain as conveniences and are folded into a spec when ``governor``
    is not given.
    """

    name: str
    graph: TaskGraph
    policy: str = "busy"            # any registered policy name
    cpus: list[int] | None = None   # global cpu ids owned by the job
    monitoring: bool | None = None  # default: on iff policy needs it
    prediction_rate_s: float = DEFAULT_PREDICTION_RATE_S
    spin_budget: int = 100
    min_samples: int = DEFAULT_MIN_SAMPLES
    power: PowerModel | None = None
    governor: GovernorSpec | None = None  # overrides the kwargs above
    #: open-workload mode: release tasks over virtual time instead of
    #: submitting the whole graph at t=0.  The process stamps
    #: ``Task.release_time`` in task order; tasks that already carry a
    #: release time (e.g. a replayed trace) are honored when this is None.
    arrivals: ArrivalProcess | None = None
    #: runtime event bus shared with trace recorders; None ⇒ per-job bus
    bus: EventBus | None = None
    #: multi-node clusters: the app's home node (None ⇒ the node of the
    #: first owned cpu, or node 0 with default cpus).  Ignored on flat
    #: machines and 1-node clusters.
    node: int | None = None

    def governor_spec(self, n_cpus: int) -> GovernorSpec:
        if self.governor is not None:
            if self.governor.resources != n_cpus:
                # The cluster allocation wins; clamp min_resources (unused
                # by the simulator) so the resize cannot fail validation.
                return replace(
                    self.governor, resources=n_cpus,
                    min_resources=min(self.governor.min_resources, n_cpus))
            return self.governor
        return GovernorSpec(
            resources=n_cpus, policy=self.policy,
            prediction=PredictionConfig(rate_s=self.prediction_rate_s,
                                        min_samples=self.min_samples),
            spin_budget=self.spin_budget, monitoring=self.monitoring,
            power=self.power)


class _SimJob:
    __slots__ = (
        "cluster", "spec", "name", "graph", "bus", "cpus", "governor",
        "monitor", "scheduler", "predictor", "policy", "energy",
        "manager", "sharing", "rate_s", "epoch", "waking", "borrowed",
        "t_done", "monitor_events", "arrivals_pending", "spin_budget",
        "home", "mm", "socket_penalty", "transfers", "transfer_seconds",
        "migrations", "pending_moves", "running", "failed")

    def __init__(self, cluster: "SimCluster", spec: SimJobSpec,
                 cpus: list[int]) -> None:
        self.cluster = cluster
        self.spec = spec
        self.name = spec.name
        self.graph = spec.graph
        cm = cluster.cluster_model
        multi = cluster._multi
        #: home node + home machine: every latency constant and service
        #: time this job pays comes from its own node's machine model
        #: (identical to ``cluster.machine`` on flat/1-node clusters)
        self.home = (spec.node if spec.node is not None
                     else (cm.node_of(cpus[0]) if multi else 0))
        self.mm = cm.nodes[self.home] if multi else cluster.machine
        machine = self.mm
        # A job-private bus is namespaced with the job name, so a trace
        # recorder attached to several jobs' buses yields one combined,
        # per-app-splittable multi-app trace.  An externally provided
        # bus keeps whatever namespace its creator chose.  Multi-node
        # buses additionally stamp the home node (and worker sockets on
        # multi-socket nodes) onto every event.
        if spec.bus is not None:
            self.bus = spec.bus
        elif multi:
            self.bus = EventBus(
                app=spec.name, node=self.home,
                socket_of=(cm.socket_of if any(
                    m.topology().n_sockets > 1 for m in cm.nodes)
                    else None))
        else:
            self.bus = EventBus(app=spec.name)
        gspec = spec.governor_spec(len(cpus))
        if machine.core_types is not None and gspec.topology is None:
            # asymmetric machine: hand the topology to the whole stack
            # (per-type monitoring/energy, speed-aware Δ, park order).
            # A job pinned to a cpu subset gets a *sliced* topology so
            # its power accounting matches the per-core service speeds
            # the machine applies; the id list is grouped by type so the
            # governor's positional mapping lines up with the machine's.
            # Global cpu ids wrap per node on multi-node clusters.
            topo = machine.topology()
            loc = cm.local_id if multi else (lambda c: c)
            if len(cpus) == machine.n_cores:
                gspec = replace(gspec, topology=topo)
            else:
                rank = {t.name: i for i, t in enumerate(topo.types)}
                cpus = sorted(cpus,
                              key=lambda c: (rank[topo.type_of(loc(c))], c))
                counts: dict[str, int] = {}
                for c in cpus:
                    ct = topo.type_of(loc(c))
                    counts[ct] = counts.get(ct, 0) + 1
                sliced = CoreTopology(types=tuple(
                    replace(t, count=counts[t.name])
                    for t in topo.types if t.name in counts))
                gspec = replace(gspec, topology=sliced)
        elif multi and gspec.topology is None:
            # Homogeneous node on a multi-node cluster: hand the stack
            # an explicit single-type topology so borrowed remote cores
            # can be announced under their locality-tier type name
            # ("core@n<k>") and the monitor learns per-tier costs —
            # the hetero machinery on one type reproduces the
            # homogeneous algorithms decision-for-decision.
            gspec = replace(gspec,
                            topology=CoreTopology.homogeneous(len(cpus)))
        self.cpus = cpus
        self.governor = ResourceGovernor(
            gspec, clock=lambda: cluster.now,
            worker_ids=list(cpus), t0=cluster.now, bus=self.bus)
        self.monitor = self.governor.monitor
        self.scheduler = Scheduler(self.monitor, bus=self.bus,
                                   clock=lambda: cluster.now,
                                   threadsafe=cluster.threadsafe)
        self.predictor = self.governor.predictor
        self.policy = self.governor.policy
        self.energy = self.governor.energy
        self.manager = self.governor.manager
        self.sharing = self.governor.sharing
        self.rate_s = self.governor.spec.prediction.rate_s
        self.epoch: dict[int, int] = {c: 0 for c in cpus}
        self.waking: set[int] = set()
        self.borrowed: set[int] = set()
        self.t_done: float | None = None
        self.monitor_events = 0
        #: tasks released over time that have not been submitted yet —
        #: an open job is done only when arrivals are exhausted AND the
        #: scheduler drained.
        self.arrivals_pending = 0
        #: hoisted once — ``getattr(policy, "spin_budget", ...)`` sat on
        #: the per-empty-poll path
        self.spin_budget: int | None = getattr(self.policy, "spin_budget",
                                               None)
        #: home machine's cross-socket dilation, pre-resolved (None when
        #: inert: single-socket node or penalty 1.0 — the common case
        #: pays one attribute load per task start, nothing more)
        self.socket_penalty: float | None = (
            machine.remote_socket_penalty
            if (machine.remote_socket_penalty != 1.0
                and machine.topology().n_sockets > 1) else None)
        self.transfers = 0
        self.transfer_seconds = 0.0
        self.migrations = 0
        #: cores granted to an in-flight migration while EXECUTING; they
        #: move (old → new global id) at their next task boundary
        self.pending_moves: dict[int, int] | None = None
        #: machine conditions only (both stay empty otherwise): the task
        #: each core is executing (so a CORE_FAIL can re-queue it) and
        #: this job's currently failed owned cores (dict, not set — the
        #: determinism lint forbids set iteration)
        self.running: dict[int, Task] = {}
        self.failed: dict[int, bool] = {}

    @property
    def done(self) -> bool:
        return self.arrivals_pending == 0 and self.scheduler.drained()

    def spinning_workers(self) -> list[int]:
        # wake_first order: on heterogeneous machines ready work is
        # dispatched to the fastest spinning cores first (identity order
        # on homogeneous machines)
        return self.manager.spinning(exclude=self.waking)


class SimCluster:
    """Event loop over one machine shared by one or more jobs.

    ``threadsafe=False`` (the default — the event loop is the only
    thread that ever touches the per-job schedulers) selects the
    lock-free sequential :class:`~repro.runtime.scheduler.Scheduler`
    fast path; ``threadsafe=True`` runs the locked reference scheduler
    instead.  Both paths execute the identical decision logic in the
    identical order — ``tests/test_simperf.py`` pins byte-identical
    traces and bit-identical reports across the two for every
    registered policy.
    """

    def __init__(self, machine: MachineModel | ClusterModel,
                 broker: ResourceBroker | None = None,
                 threadsafe: bool = False,
                 conditions: ConditionTimeline | None = None) -> None:
        if isinstance(machine, ClusterModel):
            #: the locality hierarchy; a 1-node cluster takes the flat
            #: single-machine paths end to end (byte parity with the
            #: equivalent MachineModel by construction)
            self.cluster_model: ClusterModel | None = machine
            self._multi = machine.n_nodes > 1
            machine = machine.nodes[0]
        else:
            self.cluster_model = None
            self._multi = False
        self.machine = machine
        self.broker = broker
        self.threadsafe = threadsafe
        self.arbiter: ClusterArbiter | None = None
        if broker is not None:
            if self._multi:
                cm = self.cluster_model
                assert cm is not None
                if (not broker.typed and any(
                        m.core_types is not None for m in cm.nodes)):
                    # asymmetric node(s): per-type pool accounting over
                    # the global core-id space
                    broker.set_core_type_of(cm.type_of)
                self.arbiter = ClusterArbiter(broker, cluster=cm)
            else:
                topo = None
                if machine.core_types is not None:
                    # per-core-type pool accounting: a P-core lent must
                    # not come back as an E-core grant
                    if not broker.typed:
                        broker.set_core_type_of(machine.topology().type_of)
                    topo = machine.topology()
                self.arbiter = ClusterArbiter(broker, topology=topo)
        #: machine-condition timeline + live view.  An EMPTY (or absent)
        #: timeline leaves both None: every conditions gate below stays
        #: closed and the run is byte-identical to the pre-conditions
        #: simulator.
        self.timeline = conditions if conditions else None
        self._cond: MachineConditions | None = (
            MachineConditions(conditions) if conditions else None)
        #: machine-wide power-cap compliance: per-job meters can only
        #: judge their *own* draw against the cap, so a 48 W machine
        #: split between two 24 W tenants would look compliant per
        #: meter.  The drain loop integrates the summed draw across all
        #: jobs against the active cap at every virtual-time advance
        #: (piecewise-constant between events, so this is exact).
        self._machine_cap: float | None = None
        self.machine_cap_violation_s = 0.0
        self.now = 0.0
        #: per-task fast path: homogeneous machines divide service times
        #: by one constant (None on machines with typed cores and on
        #: multi-node clusters, where locality costs are per-task)
        self._flat_speed = (machine.core_speed
                            if machine.core_types is None
                            and not self._multi else None)
        # Flattened heap entries (t, seq, kind, a, b, c, d): pushing one
        # event allocates a single tuple — no nested payload tuple — and
        # the unique seq tiebreak guarantees comparisons never reach the
        # (unorderable) job/task objects behind it.
        self._heap: list[tuple] = []
        self._seq = itertools.count()
        self._next_seq = self._seq.__next__
        self.jobs: dict[str, _SimJob] = {}
        self._undone = 0
        #: events drained by the last :meth:`run` (throughput metric for
        #: ``benchmarks/bench_simperf.py``)
        self.events_processed = 0

    # -- setup ----------------------------------------------------------------

    def add_job(self, spec: SimJobSpec) -> _SimJob:
        cpus = spec.cpus
        if cpus is None:
            if self._multi:
                assert self.cluster_model is not None
                cpus = list(self.cluster_model.cores_of(
                    spec.node if spec.node is not None else 0))
            else:
                base = sum(len(j.cpus) for j in self.jobs.values())
                cpus = list(range(base, base + self.machine.n_cores))
        job = _SimJob(self, spec, list(cpus))
        if self._cond is not None:
            job.governor.attach_conditions(self._cond)
        self.jobs[spec.name] = job
        if self.broker is not None:
            self.broker.register_job(spec.name, list(job.cpus))
            assert self.arbiter is not None
            self.arbiter.register(spec.name, job.governor, node=job.home)
        return job

    def _push(self, t: float, kind: int, a: Any = None, b: Any = None,
              c: Any = None, d: Any = None) -> None:
        _heappush(self._heap, (t, self._next_seq(), kind, a, b, c, d))

    # -- main loop --------------------------------------------------------------

    def run(self, max_events: int = 50_000_000) -> dict[str, SimReport]:
        if self.timeline is not None:
            # Perturbations are scheduled before the t=0 submissions so
            # a time-0 condition is in force before any task starts.
            for p in self.timeline:
                k = p.kind
                if k is PerturbationKind.POWER_CAP:
                    self._push(p.time, _POWER, p)
                elif k is PerturbationKind.THERMAL_THROTTLE:
                    self._push(p.time, _THROTTLE, p)
                else:
                    self._push(p.time, _FAULT, p)
        for job in self.jobs.values():
            self._submit_or_schedule(job)
        for job in self.jobs.values():
            self._dispatch(job)
        for job in self.jobs.values():
            for w in job.spinning_workers():
                self._poll(job, w)
            if job.policy.uses_predictions:
                self._push(self.now + job.rate_s, _TICK, job)
        # Specialized drain loop: heappop and the bound handlers are
        # hoisted into locals, dispatch is a kind-indexed if/elif over
        # ints, and termination is a counter decremented when a job
        # drains (`all(j.done ...)` re-walked every job per event).
        self._undone = sum(1 for j in self.jobs.values() if not j.done)
        events = 0
        heap = self._heap
        pop = heapq.heappop
        on_finish = self._on_finish
        on_tick = self._on_tick
        on_resume = self._on_resume
        on_spin_expire = self._on_spin_expire
        on_arrive = self._on_arrive
        on_fault = self._on_fault
        on_throttle = self._on_throttle
        on_power = self._on_power
        cond_on = self._cond is not None
        cond_jobs = list(self.jobs.values())
        while heap and self._undone:
            events += 1
            if events > max_events:
                raise RuntimeError("simulator exceeded max_events")
            t, _, kind, a, b, c, d = pop(heap)
            if cond_on:
                cap = self._machine_cap
                if cap is not None and t > self.now:
                    # completed jobs are excluded: their runtime has
                    # exited, and their meters froze at the final
                    # (possibly all-spinning) draw
                    watts = 0.0
                    for j in cond_jobs:
                        if j.t_done is None:
                            watts += j.energy.watts
                    if watts > cap + 1e-12:
                        self.machine_cap_violation_s += t - self.now
            self.now = t
            if kind == _FINISH:
                on_finish(a, b, c, d)
            elif kind == _RESUME:
                on_resume(a, b)
            elif kind == _TICK:
                on_tick(a)
            elif kind == _SPIN_EXPIRE:
                on_spin_expire(a, b, c)
            elif kind == _ARRIVE:
                on_arrive(a, b)
            elif kind == _FAULT:
                on_fault(a)
            elif kind == _THROTTLE:
                on_throttle(a)
            else:
                on_power(a)
        self.events_processed = events
        reports = {}
        for job in self.jobs.values():
            if not job.done:
                raise RuntimeError(
                    f"job {job.name!r} deadlocked with "
                    f"{job.scheduler.pending} pending tasks")
            t_end = job.t_done if job.t_done is not None else self.now
            job.energy.finish(t_end)
            reports[job.name] = self._report(job)
        return reports

    def _report(self, job: _SimJob) -> SimReport:
        return job.governor.report(
            name=job.name,
            tasks_fallback=len(job.graph.tasks),
            dlb_calls=(self.broker.job_calls(job.name)
                       if self.broker else 0),
            monitor_events=job.monitor_events,
            sharing=(self.arbiter.stats[job.name].as_dict()
                     if self.arbiter is not None else None),
            node=job.home if self._multi else None,
            transfers=job.transfers,
            transfer_seconds=job.transfer_seconds,
            migrations=job.migrations,
        )

    def _submit_or_schedule(self, job: _SimJob) -> None:
        """Closed tasks go to the scheduler at t=0 (one batched
        ``submit_all``); tasks with a release time (from
        ``spec.arrivals`` or pre-stamped, e.g. by a replayed trace)
        become ``_ARRIVE`` events on the virtual timeline."""
        if job.spec.arrivals is not None:
            job.spec.arrivals.assign(job.graph.tasks)
        now = self.now
        closed = []
        for task in job.graph.tasks:
            rt = task.release_time
            if rt is None or rt <= now:
                closed.append(task)
            else:
                job.arrivals_pending += 1
                self._push(rt, _ARRIVE, job, task)
        if closed:
            job.scheduler.submit_all(closed)

    # -- event handlers -----------------------------------------------------------

    def _on_arrive(self, job: _SimJob, task: Task) -> None:
        job.arrivals_pending -= 1
        if job.bus.interested(EventKind.TASK_ARRIVED):
            job.bus.publish(RuntimeEvent(
                kind=EventKind.TASK_ARRIVED, time=self.now,
                task_id=task.task_id, type_name=task.type_name,
                cost=task.cost))
        became_ready = job.scheduler.submit(task)
        if became_ready:
            self._work_added(job)

    def _on_finish(self, job: _SimJob, cpu: int, task: Task,
                   elapsed: float) -> None:
        if self._cond is not None:
            # Under machine conditions the d slot carries (dur, epoch):
            # a CORE_FAIL mid-task bumped the core's epoch when it
            # re-queued the task, so the dead core's in-flight finish
            # pops here as stale and is dropped.
            elapsed, ep = elapsed
            if job.epoch.get(cpu) != ep:
                return
            job.running.pop(cpu, None)
        # successors consult this for cross-node transfer / cross-socket
        # penalty on the dependency edge; stamp before any dispatch
        task.completed_on = cpu
        job.manager.task_finished(cpu)
        newly = job.scheduler.complete(task, elapsed, worker_id=cpu)
        if job.monitor is not None:
            job.monitor_events += 3  # ready/execute/complete round trip
        # inline job.done (a property + drained() call per finish)
        if job.arrivals_pending == 0 and job.scheduler._pending == 0:
            job.t_done = self.now
            self._undone -= 1
            if self.broker is not None:
                # a finished app claims nothing: drop any fairness
                # reservation its last short acquire registered
                self.broker.register_demand(job.name, 0)
        pm = job.pending_moves
        if pm is not None and cpu in pm:
            # an in-flight migration was waiting for this core's task
            # boundary: move it now instead of polling on the old node
            self._move_core(job, cpu, pm.pop(cpu))
            if newly:
                self._work_added(job)
            return
        if newly:
            self._work_added(job)
        if job.manager.state_of(cpu) is not WorkerState.SPIN:
            # _work_added's instant dispatch already handed this worker a
            # new task (it was spinning the moment the queue refilled).
            return
        # Borrowed CPU honoring a reclaim flag returns at task boundary.
        if (self.broker is not None and cpu in job.borrowed
                and self.broker.cpu_must_return(cpu)):
            self._return_borrowed(job, cpu)
            return
        # LeWI-style eager acquisition happens at every task boundary while
        # ready work remains (this is what makes LeWI's call count explode
        # for fine-grained tasks — paper Table 3).  The call overhead
        # delays this worker's next poll.
        if (job.sharing and job.policy.eager_acquire
                and job.scheduler.ready_count > 0):
            assert self.broker is not None and self.arbiter is not None
            before = self.broker.job_calls(job.name)
            self.arbiter.execute(AppPlan(app=job.name, acquire=1,
                                         eager=True),
                                 lambda c: self._hand_cpu_to(job, c))
            n_calls = self.broker.job_calls(job.name) - before
            if n_calls:
                self._push(self.now + n_calls * job.mm.dlb_call_overhead,
                           _RESUME, job, cpu)
                return
        self._poll(job, cpu)

    def _on_tick(self, job: _SimJob) -> None:
        # inline job.done — this gate runs once per tick
        if job.arrivals_pending == 0 and job.scheduler._pending == 0:
            return  # stop rescheduling; lets the loop terminate
        job.governor.tick()
        # Trim: re-evaluate spinning workers against the fresh Δ, in
        # park order (spinning_workers is wake/dispatch-ordered — using
        # it here would park the fastest cores first).  With ready work
        # queued the loop body is a guaranteed immediate break, so skip
        # building the spinner list at all.
        if job.scheduler.ready_count == 0:
            uniform = job.policy.poll_uniform
            mgr = job.manager
            if not job.sharing and not mgr.park_ordered:
                # Homogeneous non-sharing trim: park order is dict order
                # and decisions can only SPIN (value mutation of the
                # visited key — iteration-safe) or IDLE, so the spinner
                # list need not be materialized.  With a uniform policy
                # the loop typically stops at the very first verdict —
                # this path runs once per tick, the hottest line of
                # tick-dominated sims.
                waking = job.waking
                spin = WorkerState.SPIN
                poll_empty = mgr.poll_empty
                for w, s in mgr.states_items_unlocked():
                    if s is not spin or w in waking:
                        continue
                    decision = poll_empty(w)
                    if decision is PollDecision.SPIN and uniform:
                        break
            else:
                for w in mgr.park_first(job.spinning_workers()):
                    if job.scheduler.ready_count > 0:
                        break
                    decision = mgr.poll_empty(w)
                    if decision is PollDecision.LEND:
                        self._lend(job, w)
                    elif decision is PollDecision.SPIN and uniform:
                        # uniform policies answer SPIN identically for
                        # every remaining spinner (δ unchanged by SPIN)
                        break
        # Grow: resume idle workers / acquire broker CPUs — one call.
        ready = job.scheduler.ready_count
        if ready > 0:
            self._resume_workers(job, job.manager.notify_added(ready))
        if job.sharing:
            # Centralized acquisition: the arbiter peeks DLB's free-CPU
            # counter (cheap shared-memory read, not a DLB call) before
            # paying for an acquisition round-trip, and splits the
            # request per core type on heterogeneous machines.
            assert self.arbiter is not None
            plan = self.arbiter.plan_tick(job.name, job.manager.active,
                                          job.scheduler.ready_count)
            if plan is not None:
                self.arbiter.execute(plan,
                                     lambda c: self._hand_cpu_to(job, c))
        self._push(self.now + job.rate_s, _TICK, job)

    def _on_resume(self, job: _SimJob, cpu: int) -> None:
        job.waking.discard(cpu)
        if job.manager.state_of(cpu) is WorkerState.SPIN:
            self._poll(job, cpu)

    def _on_spin_expire(self, job: _SimJob, cpu: int, epoch: int) -> None:
        if job.epoch.get(cpu) != epoch:
            return  # stale: worker ran a task / changed state meanwhile
        if job.manager.state_of(cpu) is not WorkerState.SPIN:
            return
        if job.scheduler.ready_count > 0:
            return  # work arrived; dispatch already handled it
        budget = job.spin_budget if job.spin_budget is not None else 1
        decision = job.manager.poll_empty(cpu, spin_count_override=budget)
        if decision is PollDecision.LEND:
            self._lend(job, cpu)

    # -- machine-condition handlers -----------------------------------------------

    def _publish_perturbation(self, p: Perturbation) -> None:
        """Record the perturbation as a runtime event (once per distinct
        bus — jobs sharing an external bus must not duplicate it) so
        traces of perturbed runs round-trip through the replayer."""
        seen: dict[int, bool] = {}
        for job in self.jobs.values():
            bus = job.bus
            if id(bus) in seen:
                continue
            seen[id(bus)] = True
            if bus.interested(EventKind.PERTURBATION):
                bus.publish(RuntimeEvent(
                    kind=EventKind.PERTURBATION, time=self.now,
                    data=p.to_dict()))

    def _owner_of(self, cpu: int) -> _SimJob | None:
        for job in self.jobs.values():
            if cpu in job.cpus:
                return job
        return None

    def _note_failed(self, job: _SimJob, cpu: int, failed: bool) -> None:
        if failed:
            job.failed[cpu] = True
        else:
            job.failed.pop(cpu, None)
        job.governor.set_failed_workers(list(job.failed))

    def _on_fault(self, p: Perturbation) -> None:
        cond = self._cond
        assert cond is not None
        cond.apply(p)
        self._publish_perturbation(p)
        if p.kind is PerturbationKind.STRAGGLER:
            # nothing structural: _start dilates subsequent durations on
            # the slow core and the monitor skips its suspect samples
            return
        c = p.core
        assert c is not None
        if p.kind is PerturbationKind.CORE_FAIL:
            # Whoever currently holds the core live (owner or borrower)
            # loses it; an in-flight task is re-queued at the head of
            # the ready queue and re-executed on a surviving core.
            holder = None
            for job in self.jobs.values():
                st = job.manager.state_of(c)
                if st is not None and st is not WorkerState.LENT:
                    holder = job
                    break
            if holder is not None:
                task = holder.running.pop(c, None)
                holder.epoch[c] = holder.epoch.get(c, 0) + 1
                holder.waking.discard(c)
                # closes the core's energy timeline (OFF) from any state
                holder.manager.remove_worker(c)
                holder.borrowed.discard(c)
                if task is not None:
                    holder.scheduler.requeue(task)
            if self.broker is not None:
                self.broker.fail_core(c)
            owner = self._owner_of(c)
            if owner is not None:
                if (owner is not holder
                        and owner.manager.state_of(c) is not None):
                    # the owner kept a LENT registration for a core that
                    # was borrowed out — retire it too
                    owner.epoch[c] = owner.epoch.get(c, 0) + 1
                    owner.manager.remove_worker(c)
                self._note_failed(owner, c, True)
            if holder is not None and holder.scheduler.ready_count > 0:
                self._work_added(holder)
        else:  # CORE_RECOVER
            if self.broker is not None:
                self.broker.recover_core(c)
            owner = self._owner_of(c)
            if owner is None:
                return
            self._note_failed(owner, c, False)
            if owner.t_done is not None:
                return  # job already finished; nothing to resume
            # re-adopt under its true identity (type-correct α/energy),
            # waking after the usual resume latency
            if not self._multi:
                ct = (self.machine.topology().core_type_at(c)
                      if self.machine.core_types is not None else None)
            else:
                cm = self.cluster_model
                assert cm is not None
                src = cm.node_of(c)
                ct = cm.nodes[src].topology().core_type_at(
                    c - cm.base_of(src))
            owner.governor.adopt_worker(c, core_type=ct)
            owner.epoch[c] = owner.epoch.get(c, 0) + 1
            owner.waking.add(c)
            self._push(self.now + owner.mm.resume_latency, _RESUME,
                       owner, c)

    def _on_throttle(self, p: Perturbation) -> None:
        cond = self._cond
        assert cond is not None
        cond.apply(p)
        self._publish_perturbation(p)
        caps = cond.thermal_caps()
        for job in self.jobs.values():
            job.governor.apply_thermal(caps, now=self.now)

    def _on_power(self, p: Perturbation) -> None:
        cond = self._cond
        assert cond is not None
        cond.apply(p)
        self._publish_perturbation(p)
        self._machine_cap = p.watts
        for job in self.jobs.values():
            job.energy.set_power_cap(self.now, p.watts)
        if self.arbiter is not None:
            jobs = self.jobs
            active_w = max(j.energy.power_model.active
                           for j in jobs.values())
            self.arbiter.set_power_cap(
                p.watts,
                current_watts=lambda: sum(j.energy.watts
                                          for j in jobs.values()),
                core_active_w=active_w)

    # -- mechanics ----------------------------------------------------------------

    def _poll(self, job: _SimJob, cpu: int) -> None:
        task = job.scheduler.poll(worker_id=cpu)
        if task is not None:
            self._start(job, cpu, task)
            return
        decision = job.manager.poll_empty(cpu)
        if decision is PollDecision.SPIN:
            budget = job.spin_budget
            if budget is not None:
                job.epoch[cpu] += 1
                self._push(self.now + budget * job.mm.poll_interval,
                           _SPIN_EXPIRE, job, cpu, job.epoch[cpu])
        elif decision is PollDecision.LEND:
            self._lend(job, cpu)
        # IDLE: state transition already applied by the manager.

    def _start(self, job: _SimJob, cpu: int, task: Task) -> None:
        st = task.service_time
        if st is None:
            raise ValueError(
                f"task {task.type_name}#{task.task_id} has no service_time "
                "(required by the simulator)")
        job.epoch[cpu] += 1
        job.manager.task_started(cpu)
        flat = self._flat_speed
        if flat is not None and not job.governor._freq_cache:
            # homogeneous machine, no DVFS plan applied: service_time()
            # would resolve per-core speed and frequency to the same
            # constants on every single task
            dur = st / flat
        elif not self._multi:
            dur = self.machine.service_time(
                st, core=cpu, freq=job.governor.frequency_of(cpu))
            sp = job.socket_penalty
            if sp is not None:
                # cross-socket dependency: the task consumes data its
                # predecessor produced on the other NUMA domain
                topo = self.machine._topology
                sk = topo.socket_of(cpu)
                for dep in task.deps:
                    co = dep.completed_on
                    if co is not None and topo.socket_of(co) != sk:
                        dur *= sp
                        break
        else:
            # Multi-node: service time comes from the executing core's
            # own node, dilated by the remote penalty when that node is
            # not the app's home; cross-node dependency edges charge a
            # network transfer that delays the start but is NOT part of
            # the task's measured elapsed (wire time, not compute time).
            cm = self.cluster_model
            node = cm.node_of(cpu)
            nm = cm.nodes[node]
            dur = nm.service_time(
                st, core=cpu - cm.base_of(node),
                freq=job.governor.frequency_of(cpu))
            if node != job.home:
                dur *= cm.penalty(job.home, node)
            elif job.socket_penalty is not None:
                topo = nm._topology
                base = cm.base_of(node)
                sk = topo.socket_of(cpu - base)
                for dep in task.deps:
                    co = dep.completed_on
                    if (co is not None and cm.node_of(co) == node
                            and topo.socket_of(co - base) != sk):
                        dur *= job.socket_penalty
                        break
            xfer = 0.0
            src = node
            if cm.transfer_latency > 0.0:
                # transfers from several predecessors overlap on the
                # wire: the slowest edge gates the start
                for dep in task.deps:
                    co = dep.completed_on
                    if co is not None:
                        dn = cm.node_of(co)
                        if dn != node:
                            x = cm.transfer_time(dn, node)
                            if x > xfer:
                                xfer, src = x, dn
            if job.monitor is not None:
                dur += 3 * nm.monitor_event_overhead
            if xfer > 0.0:
                job.transfers += 1
                job.transfer_seconds += xfer
                if job.bus.interested(EventKind.TRANSFER):
                    job.bus.publish(RuntimeEvent(
                        kind=EventKind.TRANSFER, time=self.now,
                        task_id=task.task_id, worker_id=cpu,
                        elapsed=xfer,
                        data={"src": src, "dst": node}))
            cond = self._cond
            if cond is not None:
                dur *= cond.slowdown_of(cpu)
                job.running[cpu] = task
                self._push(self.now + xfer + dur, _FINISH, job, cpu, task,
                           (dur, job.epoch[cpu]))
            else:
                self._push(self.now + xfer + dur, _FINISH, job, cpu, task,
                           dur)
            return
        if job.monitor is not None:
            dur += 3 * self.machine.monitor_event_overhead
        cond = self._cond
        if cond is not None:
            # straggling cores silently dilate the task; the monitor
            # marks their samples suspect so α stays clean
            dur *= cond.slowdown_of(cpu)
            job.running[cpu] = task
            self._push(self.now + dur, _FINISH, job, cpu, task,
                       (dur, job.epoch[cpu]))
            return
        self._push(self.now + dur, _FINISH, job, cpu, task, dur)

    def _dispatch(self, job: _SimJob) -> None:
        """Hand ready tasks to spinning workers instantly.

        Spinners are consumed lazily: with R ready tasks only the first
        R spinning workers are ever visited — this loop used to
        re-filter and re-sort the whole state map (plus re-take the
        ready-count lock) once per handed-out task.  ``_start`` only
        flips the dispatched worker's own state, which keeps the lazy
        iteration valid.
        """
        sched = job.scheduler
        if sched.ready_count == 0:
            return
        for w in job.manager.iter_spinning(exclude=job.waking):
            task = sched.poll(worker_id=w)
            if task is None:
                return
            self._start(job, w, task)

    def _work_added(self, job: _SimJob) -> None:
        self._dispatch(job)
        ready = job.scheduler.ready_count
        if ready > 0:
            self._resume_workers(job, job.manager.notify_added(ready))
        if job.sharing:
            assert self.arbiter is not None
            plan = self.arbiter.plan_work_added(job.name,
                                                job.manager.active,
                                                job.scheduler.ready_count)
            if plan is not None:
                self.arbiter.execute(plan,
                                     lambda c: self._hand_cpu_to(job, c))

    def _resume_workers(self, job: _SimJob, woken: list[int]) -> None:
        for w in woken:
            job.waking.add(w)
            self._push(self.now + job.mm.resume_latency, _RESUME,
                       job, w)

    # -- DLB mechanics ---------------------------------------------------------------

    def _lend(self, job: _SimJob, cpu: int) -> None:
        assert self.arbiter is not None
        job.epoch[cpu] = job.epoch.get(cpu, 0) + 1
        was_borrowed = cpu in job.borrowed
        holder = self.arbiter.lend(job.name, cpu)
        if was_borrowed:
            job.borrowed.discard(cpu)
            # remove_worker closes the core's energy timeline (OFF)
            job.manager.remove_worker(cpu)
            if holder:
                self._hand_cpu_to(self.jobs[holder], cpu)
        # Owned CPU stays registered as LENT (energy OFF) in our manager.

    def _return_borrowed(self, job: _SimJob, cpu: int) -> None:
        assert self.arbiter is not None
        owner_name = self.arbiter.return_cpu(job.name, cpu)
        job.borrowed.discard(cpu)
        # remove_worker closes the core's energy timeline (OFF)
        job.manager.remove_worker(cpu)
        self._hand_cpu_to(self.jobs[owner_name], cpu)
        if (job.scheduler.ready_count > 0 and job.manager.active == 0
                and not job.waking):
            # The forced return took the job's LAST worker while work is
            # still queued (possible once ≥3 jobs trade CPUs: every
            # owned CPU lent away, the final borrowed one reclaimed).
            # Policies without a prediction tick (LeWI/hybrid) have no
            # other wake-up path, so this deadlocked N-app clusters:
            # claw capacity back through the broker — own lent CPUs
            # first, a reclaim flag if they are all borrowed out.
            self.arbiter.execute(
                AppPlan(app=job.name, acquire=job.scheduler.ready_count),
                lambda c: self._hand_cpu_to(job, c))

    def _hand_cpu_to(self, job: _SimJob, cpu: int) -> None:
        """CPU (re)arrives at ``job`` after the DLB hand-over latency
        (plus the network transfer when it crosses nodes)."""
        lat = job.mm.borrow_latency
        src = None
        if self._multi:
            cm = self.cluster_model
            src = cm.node_of(cpu)
            if src != job.home:
                lat += cm.transfer_time(src, job.home)
        if job.manager.state_of(cpu) is not None:
            job.manager.reclaim(cpu)
        else:
            job.borrowed.add(cpu)
            # announce the borrowed core's true identity so α_{j,c},
            # energy billing and DVFS lookups use the machine's type,
            # not the job's (possibly sliced) positional mapping
            if not self._multi:
                ct = (self.machine.topology().core_type_at(cpu)
                      if self.machine.core_types is not None else None)
            else:
                # cross-node borrows carry their locality tier in the
                # type name ("P@n1"): the monitor learns a separate
                # (task type × core type × tier) α for remote silicon —
                # its service times include the remote penalty — and
                # compute_plan never confuses it with home-node cores
                nm = self.cluster_model.nodes[src]
                ct = nm.topology().core_type_at(
                    cpu - self.cluster_model.base_of(src))
                if src != job.home:
                    ct = replace(ct, name=f"{ct.name}@n{src}", count=1)
            job.governor.adopt_worker(cpu, core_type=ct)
        job.epoch[cpu] = job.epoch.get(cpu, 0) + 1
        job.waking.add(cpu)
        self._push(self.now + lat, _RESUME, job, cpu)

    # -- whole-app migration -----------------------------------------------------

    def migrate_job(self, name: str, dst: int) -> None:
        """Explicit costed migration verb: move app ``name`` and every
        core it owns to free cores on node ``dst``.

        Each core pays ``migration_latency`` before resuming on the new
        node; cores mid-task move at their next task boundary (the
        cooperative-return discipline borrowed cores already follow).
        The app must be *settled*: no borrowed cores held and none of
        its own cores lent out — migrating IOUs would silently rewrite
        another app's accounting.
        """
        if not self._multi:
            raise ValueError("migrate_job needs a multi-node ClusterModel")
        cm = self.cluster_model
        assert cm is not None
        job = self.jobs[name]
        if dst == job.home:
            return
        if not 0 <= dst < cm.n_nodes:
            raise ValueError(f"node {dst} out of range [0, {cm.n_nodes})")
        if job.borrowed:
            raise ValueError(
                f"cannot migrate {name!r}: holding "
                f"{len(job.borrowed)} borrowed core(s)")
        if any(job.manager.state_of(c) is WorkerState.LENT
               for c in job.cpus):
            raise ValueError(
                f"cannot migrate {name!r}: some of its cores are "
                "lent out through the broker")
        used: set[int] = set()
        for j in self.jobs.values():
            used.update(j.cpus)
        free = [c for c in cm.cores_of(dst) if c not in used]
        if len(free) < len(job.cpus):
            raise ValueError(
                f"node {dst} has {len(free)} free core(s); "
                f"{name!r} needs {len(job.cpus)}")
        mapping = dict(zip(list(job.cpus), free))
        job.home = dst
        job.mm = cm.nodes[dst]
        job.socket_penalty = (
            job.mm.remote_socket_penalty
            if (job.mm.remote_socket_penalty != 1.0
                and job.mm.topology().n_sockets > 1) else None)
        job.migrations += 1
        job.bus.node = dst   # subsequent events carry the new home
        if self.arbiter is not None:
            self.arbiter.note_migration(name, dst)
        for old, new in mapping.items():
            if job.manager.state_of(old) is WorkerState.ACTIVE:
                if job.pending_moves is None:
                    job.pending_moves = {}
                job.pending_moves[old] = new
            else:
                self._move_core(job, old, new)

    def _move_core(self, job: _SimJob, old: int, new: int) -> None:
        """Re-home one owned core: retire ``old`` (its energy timeline
        closes OFF) and bring up ``new`` on the destination node after
        ``migration_latency``."""
        cm = self.cluster_model
        assert cm is not None
        job.epoch.pop(old, None)
        job.waking.discard(old)
        job.manager.remove_worker(old)
        job.cpus[job.cpus.index(old)] = new
        if self.broker is not None:
            self.broker.reassign_core(job.name, old, new)
        # always announce the type (for homogeneous nodes the synthetic
        # "core" type matches the injected job topology), so the new
        # worker's α/energy/park accounting lands under the right name
        ct = job.mm.topology().core_type_at(new - cm.base_of(job.home))
        job.governor.adopt_worker(new, core_type=ct)
        job.epoch[new] = job.epoch.get(new, 0) + 1
        job.waking.add(new)
        self._push(self.now + cm.migration_latency, _RESUME, job, new)


class SimExecutor:
    """Convenience wrapper: run ONE task graph under ONE policy.

    Reusable: each :meth:`run` builds a fresh per-run job spec with
    :func:`dataclasses.replace`, so no state (graph, arrivals) leaks
    across runs.  ``self.bus`` is stable across runs — attach a
    :class:`~repro.trace.TraceRecorder` to it before calling :meth:`run`.

    ``threadsafe=False`` (default) runs the lock-free sequential
    scheduler fast path; pass ``threadsafe=True`` for the locked
    reference (observationally identical — see README "Performance").
    ``self.last_events_processed`` records the event count of the last
    run (the throughput benchmarks' denominator).
    """

    def __init__(self, machine: MachineModel, policy: str = "busy",
                 n_cpus: int | None = None, monitoring: bool | None = None,
                 prediction_rate_s: float = DEFAULT_PREDICTION_RATE_S,
                 spin_budget: int = 100,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 power: PowerModel | None = None,
                 spec: GovernorSpec | None = None,
                 bus: EventBus | None = None,
                 threadsafe: bool = False,
                 conditions: ConditionTimeline | None = None) -> None:
        self.machine = machine
        self.threadsafe = threadsafe
        self.conditions = conditions
        self.last_events_processed = 0
        self.bus = bus if bus is not None else EventBus()
        if spec is not None:
            self.spec = SimJobSpec(name="job0", graph=TaskGraph(),
                                   cpus=list(range(spec.resources)),
                                   governor=spec, bus=self.bus)
        else:
            self.spec = SimJobSpec(
                name="job0", graph=TaskGraph(), policy=policy,
                cpus=list(range(n_cpus if n_cpus is not None
                                else machine.n_cores)),
                monitoring=monitoring, prediction_rate_s=prediction_rate_s,
                spin_budget=spin_budget, min_samples=min_samples,
                power=power, bus=self.bus)

    def run(self, graph: TaskGraph,
            arrivals: ArrivalProcess | None = None) -> SimReport:
        spec = replace(self.spec, graph=graph,
                       arrivals=(arrivals if arrivals is not None
                                 else self.spec.arrivals))
        cluster = SimCluster(self.machine, threadsafe=self.threadsafe,
                             conditions=self.conditions)
        cluster.add_job(spec)
        try:
            return cluster.run()[spec.name]
        finally:
            self.last_events_processed = cluster.events_processed
