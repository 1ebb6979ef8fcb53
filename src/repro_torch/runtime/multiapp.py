"""Multi-application co-scheduling frontend (multiprogramming).

:func:`run_multi_app` is the one-call entry point for the scenario the
paper's §2/§3.3 sharing story implies but the repo never had: N
applications — each with its own policy, monitor/predictor and arrival
process — co-scheduled on ONE machine through the
:class:`~repro.core.sharing.ResourceBroker`, with the
:class:`~repro.core.arbiter.ClusterArbiter` redistributing cores from
per-app predictions.  The result is a
:class:`~repro.core.arbiter.MultiAppReport`: per-app
:class:`~repro.core.governor.GovernorReport`\\ s plus cluster-level
fairness metrics (per-app slowdown vs. a solo run on the same CPU
partition, Jain fairness, aggregate EDP, total DLB calls).

Solo baselines: task graphs are single-use (the scheduler mutates task
state), so callers wanting slowdown metrics pass ``solo_graphs`` — a
second, freshly-built copy of each app's graph.  Each baseline runs
alone on the app's own CPU partition under the policy's registered
``solo_equivalent`` (dlb-lewi → idle, dlb-hybrid → hybrid,
dlb-prediction → prediction): a sharing policy with no co-tenant would
deadlock its lent CPUs, and the paper's "Single" configuration idles
unused CPUs too.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Mapping

from ..core.arbiter import ClusterArbiter, MultiAppReport
from ..core.governor import GovernorReport, policy_entry
from ..core.monitoring import TaskMonitor
from ..core.prediction import CPUPredictor, PredictionConfig
from ..core.sharing import ResourceBroker
from .cluster import ClusterModel
from .machine import MachineModel
from .sim import SimCluster, SimJobSpec
from .task import TaskGraph

__all__ = ["run_multi_app", "run_multi_node", "solo_job_spec",
           "predicted_demand"]


def solo_job_spec(spec: SimJobSpec, graph: TaskGraph) -> SimJobSpec:
    """``spec`` rewritten for a solo (fairness-baseline) run: fresh
    ``graph``, sharing policy swapped for its registry-declared solo
    equivalent, private bus."""
    if spec.governor is not None:
        entry = policy_entry(spec.governor.policy)
        gov = (replace(spec.governor, policy=entry.solo_equivalent)
               if entry.solo_equivalent else spec.governor)
        return replace(spec, graph=graph, governor=gov, bus=None)
    entry = policy_entry(spec.policy)
    solo_policy = entry.solo_equivalent or spec.policy
    return replace(spec, graph=graph, policy=solo_policy, bus=None)


def run_multi_app(machine: MachineModel, specs: Iterable[SimJobSpec], *,
                  broker: ResourceBroker | None = None,
                  solo_graphs: Mapping[str, TaskGraph] | None = None,
                  threadsafe: bool = False) -> MultiAppReport:
    """Co-schedule ``specs`` on ``machine`` through one broker/arbiter.

    Every spec must pin its CPU partition (``spec.cpus``) — silent
    overlapping defaults are exactly the class of bug multiprogramming
    runs cannot afford.  ``solo_graphs`` (app name → fresh graph copy)
    enables the slowdown/fairness metrics; apps without an entry simply
    have no baseline.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("run_multi_app needs at least one SimJobSpec")
    seen: set[int] = set()
    for spec in specs:
        if spec.cpus is None:
            raise ValueError(
                f"app {spec.name!r} has no cpus: multi-app runs require "
                "explicit, disjoint CPU partitions")
        overlap = seen & set(spec.cpus)
        if overlap:
            raise ValueError(
                f"app {spec.name!r} overlaps already-assigned cpus "
                f"{sorted(overlap)[:5]}")
        seen |= set(spec.cpus)
    if broker is None:
        broker = ResourceBroker()
    cluster = SimCluster(machine, broker=broker, threadsafe=threadsafe)
    for spec in specs:
        cluster.add_job(spec)
    reports = cluster.run()

    solo: dict[str, GovernorReport] = {}
    if solo_graphs:
        for spec in specs:
            graph = solo_graphs.get(spec.name)
            if graph is None:
                continue
            solo_cluster = SimCluster(machine, threadsafe=threadsafe)
            solo_cluster.add_job(solo_job_spec(spec, graph))
            solo[spec.name] = solo_cluster.run()[spec.name]
    return MultiAppReport.build(reports, broker.total_calls, solo or None)


def predicted_demand(spec: SimJobSpec) -> float:
    """Pre-run CPU-demand estimate for one app, from its *own*
    prediction machinery — the number the arbiter's ``"predicted"``
    placement packs nodes by.

    The whole graph is fed through a private
    :class:`~repro.core.monitoring.TaskMonitor` (every task's service
    time becomes a timing sample), the tasks are re-marked ready as live
    work, and one Algorithm-1 pass with the prediction window set to the
    graph's critical path yields Δ ≈ total work / critical path — the
    app's mean parallelism.  Costless relative to a run: no events, no
    simulator, O(tasks + edges).
    """
    tasks = spec.graph.tasks
    if not tasks:
        return 0.0
    monitor = TaskMonitor(min_samples=1)
    for t in tasks:
        st = t.service_time if t.service_time is not None else t.cost
        monitor.on_task_ready(t.task_id, t.type_name, t.cost)
        monitor.on_task_execute(t.task_id, t.type_name, t.cost)
        monitor.on_task_completed(t.task_id, t.type_name, t.cost, st)
    # critical path over the dependency DAG (iterative: graphs can be
    # deep chains)
    memo: dict[int, float] = {}
    for root in tasks:
        stack = [root]
        while stack:
            t = stack[-1]
            if t.task_id in memo:
                stack.pop()
                continue
            todo = [d for d in t.deps if d.task_id not in memo]
            if todo:
                stack.extend(todo)
                continue
            st = t.service_time if t.service_time is not None else t.cost
            memo[t.task_id] = st + max(
                (memo[d.task_id] for d in t.deps), default=0.0)
            stack.pop()
    critical = max(memo.values())
    if critical <= 0.0:
        return 1.0
    for t in tasks:
        monitor.on_task_ready(t.task_id, t.type_name, t.cost)
    predictor = CPUPredictor(
        monitor, n_cpus=len(tasks),
        config=PredictionConfig(rate_s=critical, min_samples=1))
    return float(predictor.tick())


def run_multi_node(cluster: ClusterModel, specs: Iterable[SimJobSpec], *,
                   placement: str | Mapping[str, int] = "predicted",
                   broker: ResourceBroker | None = None,
                   solo_graphs: Mapping[str, TaskGraph] | None = None,
                   threadsafe: bool = False) -> MultiAppReport:
    """Co-schedule ``specs`` across a multi-node :class:`ClusterModel`.

    ``placement`` is either a policy name handed to
    :meth:`~repro.core.arbiter.ClusterArbiter.place` (``"predicted"``
    packs by each app's :func:`predicted_demand`, ``"round-robin"``
    ignores demand) or an explicit app → node mapping.  Each node's
    cores are split evenly between the apps placed on it; a spec that
    pins ``cpus`` keeps them (its node derives from its first cpu).
    The report's ``placement`` field records the homes chosen.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("run_multi_node needs at least one SimJobSpec")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate app names: {names}")
    pinned = {s.name: list(s.cpus) for s in specs if s.cpus is not None}
    auto = [s for s in specs if s.cpus is None]
    if isinstance(placement, str):
        demands = {s.name: predicted_demand(s) for s in auto}
        homes = ClusterArbiter.place(
            demands, [m.n_cores for m in cluster.nodes], policy=placement)
    else:
        homes = {s.name: placement[s.name] for s in auto}
    for s in specs:
        if s.name in pinned:
            homes[s.name] = (s.node if s.node is not None
                             else cluster.node_of(pinned[s.name][0]))
    # Per-node even split of the cores not already pinned away.
    by_node: dict[int, list[SimJobSpec]] = {}
    for s in auto:
        by_node.setdefault(homes[s.name], []).append(s)
    taken = {c for cpus in pinned.values() for c in cpus}
    assigned: dict[str, list[int]] = dict(pinned)
    for node, node_specs in by_node.items():
        cores = [c for c in cluster.cores_of(node) if c not in taken]
        share = len(cores) // len(node_specs)
        if share == 0:
            raise ValueError(
                f"node {node} has {len(cores)} free core(s) for "
                f"{len(node_specs)} app(s)")
        for i, s in enumerate(node_specs):
            lo = i * share
            hi = lo + share if i < len(node_specs) - 1 else len(cores)
            assigned[s.name] = cores[lo:hi]
    run_specs = [replace(s, cpus=assigned[s.name], node=homes[s.name])
                 for s in specs]
    if broker is None:
        broker = ResourceBroker()
    sim = SimCluster(cluster, broker=broker, threadsafe=threadsafe)
    for s in run_specs:
        sim.add_job(s)
    reports = sim.run()

    solo: dict[str, GovernorReport] = {}
    if solo_graphs:
        for s in run_specs:
            graph = solo_graphs.get(s.name)
            if graph is None:
                continue
            solo_sim = SimCluster(cluster, threadsafe=threadsafe)
            solo_sim.add_job(solo_job_spec(s, graph))
            solo[s.name] = solo_sim.run()[s.name]
    return MultiAppReport.build(reports, broker.total_calls, solo or None,
                                placement=homes)
