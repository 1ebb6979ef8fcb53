"""Cluster-level co-scheduling arbiter — N applications, one machine.

The paper's resource-sharing story (§2, §3.3, Table 3) is about
co-located runtimes trading CPUs through DLB.  This module promotes that
from a simulator-internal mode into a first-class subsystem: each
application runs its own :class:`~repro.core.governor.ResourceGovernor`
(own policy, own TaskMonitor/CPUPredictor), and the
:class:`ClusterArbiter` turns each app's prediction into an explicit
:class:`AppPlan` — how many CPUs to acquire (per core type on
heterogeneous machines), whether to fall back to a reclaim — and applies
it through the :class:`~repro.core.sharing.ResourceBroker`.

Design split:

* the arbiter *decides and accounts* (plans, per-app share statistics);
* the frontend (the simulator, via :meth:`execute`'s ``hand_cpu``
  callback) *actuates* — it owns hand-over latencies and worker wiring.

With N=2 homogeneous apps the plans reduce exactly to the decisions the
two-job ``SimCluster`` DLB path has always made (pinned by the parity
test in ``tests/test_multiapp.py``); the arbiter's additions only engage
beyond that baseline: typed acquisition on asymmetric topologies, the
broker's least-recently-served fairness with ≥3 claimants, and the
cluster-wide fairness metrics of :class:`MultiAppReport`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Mapping

from .governor import GovernorReport, ResourceGovernor
from .sharing import ResourceBroker
from .topology import CoreTopology

if TYPE_CHECKING:  # runtime import would be circular (runtime -> core)
    from ..runtime.cluster import ClusterModel

__all__ = [
    "AppPlan",
    "AppShareStats",
    "ClusterArbiter",
    "MultiAppReport",
    "jain_fairness",
]


@dataclass(frozen=True)
class AppPlan:
    """One arbitration decision for one application.

    ``acquire`` is the total CPU request (the paper's Δ − δ);
    ``acquire_by_type`` optionally splits it per core type, fastest
    first, on heterogeneous machines.  ``eager`` marks LeWI-style
    per-thread acquisition (one broker call per CPU).  When the grant
    comes up short and the app still has CPUs lent out,
    ``reclaim_if_short`` triggers the owner-side reclaim flag.
    """

    app: str
    acquire: int = 0
    acquire_by_type: Mapping[str, int] | None = None
    eager: bool = False
    reclaim_if_short: bool = True


@dataclass
class AppShareStats:
    """Per-app CPU-flow counters maintained by the arbiter."""

    lends: int = 0      # CPUs this app released into the broker
    acquired: int = 0   # CPUs granted to this app by acquire()
    returns: int = 0    # borrowed CPUs handed back on a reclaim flag
    reclaims: int = 0   # reclaim rounds this app initiated
    #: pooled CPUs a short grant could NOT take because the locality
    #: guard (max_borrow_distance / remote-penalty-adjusted
    #: min_borrow_speed) refused them — the borrows the guard avoided
    guard_refusals: int = 0
    migrations: int = 0  # whole-app node migrations
    #: acquires the cluster-wide power budget refused (waking one more
    #: borrowed core would have pushed the joint draw over the cap)
    power_refusals: int = 0

    def as_dict(self) -> dict[str, int]:
        d = {"lends": self.lends, "acquired": self.acquired,
             "returns": self.returns, "reclaims": self.reclaims,
             "guard_refusals": self.guard_refusals,
             "migrations": self.migrations}
        if self.power_refusals:
            # serialized only when the power budget actually refused
            # something, so cap-free reports stay bit-identical
            d["power_refusals"] = self.power_refusals
        return d


class ClusterArbiter:
    """Prediction-driven core redistribution between co-located apps.

    One arbiter per machine/broker; every registered app brings its own
    governor.  All broker verbs issued on behalf of an app go through
    the arbiter so the per-app share statistics stay complete.
    """

    def __init__(self, broker: ResourceBroker,
                 topology: CoreTopology | None = None,
                 cluster: "ClusterModel | None" = None) -> None:
        self.broker = broker
        #: the *machine's* topology (typed brokers only) — apps own
        #: sliced views of it, but the pool can hold any machine type
        self.topology = topology
        #: the locality hierarchy (multi-node runs): enables the
        #: distance/remote-penalty borrow guards and near-first grants
        self.cluster = cluster
        self._governors: dict[str, ResourceGovernor] = {}
        self.stats: dict[str, AppShareStats] = {}
        #: app -> home node (0 on single-node clusters)
        self.homes: dict[str, int] = {}
        #: cluster-wide power budget (None = uncapped; see
        #: :meth:`set_power_cap`)
        self.power_cap_w: float | None = None
        self._current_watts: Callable[[], float] | None = None
        self._core_active_w: float = 1.0

    # -- power budget --------------------------------------------------------

    def set_power_cap(self, watts: float | None,
                      current_watts: Callable[[], float] | None = None,
                      core_active_w: float = 1.0) -> None:
        """Install (or lift) a cluster-wide power budget.

        The budget is a *shared* resource: before granting an acquire,
        :meth:`execute` checks that waking the requested cores — each
        estimated at ``core_active_w`` — still fits under the cap given
        the frontend-supplied ``current_watts()`` (the sum of every
        app's live meter draw).  Requests the budget cannot fit are
        trimmed and counted in the app's
        :attr:`AppShareStats.power_refusals`.
        """
        self.power_cap_w = watts
        if current_watts is not None:
            self._current_watts = current_watts
        if core_active_w > 0.0:
            self._core_active_w = core_active_w

    def _power_allowance(self, n_req: int) -> tuple[int, int]:
        """Clamp an ``n_req``-core acquire to the power headroom;
        returns ``(granted_budget, refused)``."""
        if (self.power_cap_w is None or self._current_watts is None
                or n_req <= 0):
            return n_req, 0
        headroom = self.power_cap_w - self._current_watts()
        allow = max(0, int(headroom / self._core_active_w + 1e-9))
        if allow >= n_req:
            return n_req, 0
        return allow, n_req - allow

    # -- registration --------------------------------------------------------

    def register(self, name: str, governor: ResourceGovernor,
                 node: int = 0) -> None:
        self._governors[name] = governor
        self.stats[name] = AppShareStats()
        self.homes[name] = node

    def note_migration(self, name: str, node: int) -> None:
        """The frontend migrated ``name`` to ``node``: update the home
        used by the locality guards and count the verb."""
        self.homes[name] = node
        self.stats[name].migrations += 1

    def apps(self) -> list[str]:
        return list(self._governors)

    def governor(self, name: str) -> ResourceGovernor:
        return self._governors[name]

    # -- placement -----------------------------------------------------------

    @staticmethod
    def place(demands: Mapping[str, float], capacities: list[float],
              policy: str = "predicted") -> dict[str, int]:
        """Whole-app → node placement.

        ``demands`` maps each app to its predicted CPU demand (each
        app's own predictor's estimate — see
        :func:`~repro.runtime.multiapp.predicted_demand`);
        ``capacities`` is per-node core capacity.

        * ``"round-robin"`` — app *i* (submission order) → node
          ``i % n``, blind to demand;
        * ``"predicted"`` — best-fit decreasing: heaviest app first onto
          the node with the most remaining capacity, so one node is not
          left running two heavy apps while another hosts two light
          ones.  Ties break toward the lower node id (deterministic).
        """
        n = len(capacities)
        if n == 0:
            raise ValueError("need at least one node")
        if policy == "round-robin":
            return {name: i % n for i, name in enumerate(demands)}
        if policy != "predicted":
            raise ValueError(f"unknown placement policy {policy!r}")
        remaining = list(capacities)
        out: dict[str, int] = {}
        order = sorted(demands, key=lambda a: (-demands[a], a))
        for name in order:
            node = max(range(n), key=lambda k: (remaining[k], -k))
            out[name] = node
            remaining[node] -= demands[name]
        return out

    # -- planning ------------------------------------------------------------

    def plan_tick(self, name: str, active: int,
                  ready_tasks: int) -> AppPlan | None:
        """Prediction-tick acquisition plan (centralized policies).

        One broker call per tick requests Δ − δ CPUs (paper §3.3); the
        free-CPU peek is a cheap shared-memory read, not a DLB call, so
        a plan is only emitted when the broker could plausibly deliver.
        Returns ``None`` when this app makes no request this tick.
        """
        gov = self._governors[name]
        policy = gov.policy
        if not gov.sharing or getattr(policy, "eager_acquire", True):
            return None
        target = policy.acquire_target(active, ready_tasks)
        if target <= 0:
            # demand evaporated: drop any stale fairness reservation so
            # pooled CPUs are not parked for an app that no longer asks
            self.broker.register_demand(name, 0)
            return None
        if (self.broker.pool_size() == 0
                and self.broker.lent_out(name) == 0):
            # Nothing to get — but a starved claimant must still record
            # its unmet demand (shared-memory write, not a DLB call), or
            # the least-recently-served reservation could never engage
            # for an app whose tick always fires after the pool drains.
            self.broker.register_demand(name, target)
            return None
        return AppPlan(app=name, acquire=target,
                       acquire_by_type=self._typed_targets(gov, target))

    def plan_work_added(self, name: str, active: int,
                        ready_tasks: int) -> AppPlan | None:
        """Work-arrival plan for eager (LeWI-style) policies: one broker
        call per requested CPU, no peek — the call overhead IS the cost
        the paper's Table 3 measures."""
        gov = self._governors[name]
        policy = gov.policy
        if not gov.sharing or not getattr(policy, "eager_acquire", False):
            return None
        target = policy.acquire_target(active, ready_tasks)
        if target <= 0:
            return None
        return AppPlan(app=name, acquire=target, eager=True)

    def _typed_targets(self, gov: ResourceGovernor,
                       target: int) -> dict[str, int] | None:
        """Per-core-type request split, fastest types first.

        Engages only when both sides speak types (typed broker + a
        predictor with a per-type plan) — homogeneous clusters keep the
        scalar path bit-for-bit.  The split covers the app's own typed
        demand Δ_c − δ_c; :meth:`execute` tops up any remainder with an
        untyped request, because in oversubscription mode surplus from a
        *different* core type is still surplus (a P-only app must be
        able to borrow pooled E-cores).
        """
        if not self.broker.typed or gov.predictor is None:
            return None
        by_type = gov.predictor.delta_by_type
        if not by_type or gov.topology is None:
            return None
        active_by_type = (gov.manager.active_by_type()
                          if gov.manager is not None else {})
        out: dict[str, int] = {}
        for ct in gov.topology.fastest_first():
            want = by_type.get(ct.name, 0) - active_by_type.get(ct.name, 0)
            if want > 0:
                out[ct.name] = want
        return out or None

    # -- locality guard ------------------------------------------------------

    def _locality_filter(self, name: str) -> tuple[
            Callable[[int], bool] | None, Callable[[int], float] | None]:
        """The ``(where, prefer)`` pair for ``name``'s broker acquires
        on a multi-node cluster — ``(None, None)`` on ≤1 node, keeping
        single-node pool order bit-for-bit.

        ``where`` refuses a foreign CPU when its node is farther than
        the spec's ``max_borrow_distance``, or when its *effective*
        speed for this app — own-node speed divided by the remote
        penalty — falls below ``min_borrow_speed`` × the app's slowest
        owned core (the same guard :meth:`_borrowable_types` applies by
        type, extended with the distance dilation: remote silicon that
        looks fast on paper can still be a losing borrow once the
        penalty is charged).  ``prefer`` sorts grants nearest-first.
        """
        cm = self.cluster
        if cm is None or cm.n_nodes <= 1:
            return None, None
        home = self.homes.get(name, 0)
        gov = self._governors[name]
        max_d = gov.spec.max_borrow_distance
        own = gov.topology
        home_m = cm.nodes[home]
        own_slowest = (min(t.speed for t in own.types) * home_m.core_speed
                       if own is not None else home_m.core_speed)
        floor = gov.spec.min_borrow_speed * own_slowest

        def where(cpu: int) -> bool:
            node = cm.node_of(cpu)
            if node == home:
                return True
            if max_d is not None and cm.distance[home][node] > max_d + 1e-12:
                return False
            eff = cm.speed_of(cpu) / cm.penalty(home, node)
            return eff >= floor - 1e-12

        def prefer(cpu: int) -> float:
            return cm.distance[home][cm.node_of(cpu)]

        return where, prefer

    # -- actuation -----------------------------------------------------------

    def execute(self, plan: AppPlan,
                hand_cpu: Callable[[int], None]) -> list[int]:
        """Apply ``plan`` against the broker; every granted CPU is
        delivered through ``hand_cpu`` (the frontend owns hand-over
        latency and worker adoption).  Returns the CPUs acquired (a
        reclaim's immediate returns are handed over but not listed)."""
        name = plan.app
        stats = self.stats[name]
        where, prefer = self._locality_filter(name)
        got: list[int] = []
        #: the classic paths reclaim *after* a short grant; the hetero
        #: path reclaims mid-flight (fast own silicon before slow
        #: foreign) so it opts out of the shared tail reclaim
        tail_reclaim = True
        # Cluster power budget: trim the request to what the joint draw
        # can absorb (no-op while no cap is installed).
        n_want, refused = self._power_allowance(plan.acquire)
        if refused:
            stats.power_refusals += refused
        if plan.eager:
            # LeWI-style: one broker call per CPU (per-thread acquisition).
            for _ in range(n_want):
                batch = self.broker.acquire(name, 1, where=where,
                                            prefer=prefer)
                if not batch:
                    break
                got.extend(batch)
        elif plan.acquire_by_type is None:
            got = self.broker.acquire(name, n_want, where=where,
                                      prefer=prefer) if n_want > 0 else []
        else:
            tail_reclaim = False
            # Heterogeneous path.  1) Own-type deficits first (fastest
            # types first, cheap typed peek gates each DLB call).
            want = n_want
            for ct, n in plan.acquire_by_type.items():
                if want <= 0:
                    break
                if self.broker.pool_size(ct) == 0:
                    continue
                batch = self.broker.acquire(name, min(n, want),
                                            core_type=ct, where=where,
                                            prefer=prefer)
                got.extend(batch)
                want -= len(batch)
            # 2) Reclaim our own (fast) silicon before borrowing foreign
            #    cores — and never re-issue a reclaim while the previous
            #    one still has return flags pending (each re-issue would
            #    be a paid DLB call that sets no new flag).
            if want > 0 and plan.reclaim_if_short:
                lent = self.broker.lent_out(name)
                if lent > 0:
                    if not self.broker.reclaim_pending(name):
                        stats.reclaims += 1
                        for cpu in self.broker.reclaim(name):
                            hand_cpu(cpu)
                    want -= lent   # own cores are on their way back
            # 3) Foreign top-up under the speed guard: never borrow
            #    silicon slower than min_borrow_speed × the app's
            #    slowest owned core (a barrier-bound app on P-cores must
            #    not dilate its critical path with E-core stragglers).
            if want > 0:
                for ct in self._borrowable_types(name):
                    if want <= 0:
                        break
                    if self.broker.pool_size(ct) == 0:
                        continue
                    batch = self.broker.acquire(name, want, core_type=ct,
                                                where=where, prefer=prefer)
                    got.extend(batch)
                    want -= len(batch)
            # typed acquires each overwrote the fairness counter with
            # their own shortfall; record the plan-level one
            self.broker.register_demand(name, want if want > 0 else 0)
        stats.acquired += len(got)
        if where is not None and len(got) < n_want:
            # A short locality-guarded grant: attribute up to the
            # shortfall to pooled CPUs the guard refused (vs. a
            # genuinely empty pool) — the borrows the guard avoided.
            stats.guard_refusals += min(n_want - len(got),
                                        self.broker.pool_rejected(where))
        for cpu in got:
            hand_cpu(cpu)
        if (tail_reclaim and len(got) < n_want
                and plan.reclaim_if_short
                and self.broker.lent_out(name) > 0):
            # Pool exhausted but our own CPUs are borrowed: flag a reclaim.
            stats.reclaims += 1
            for cpu in self.broker.reclaim(name):
                hand_cpu(cpu)
        return got

    def _borrowable_types(self, name: str) -> list[str]:
        """Machine core types ``name`` may borrow, fastest first, under
        its spec's ``min_borrow_speed`` guard (all types when the
        machine topology is unknown).  On a multi-node cluster with no
        single machine topology, the candidate set is the union of the
        node topologies (first occurrence wins per name — mixed-node
        clusters reuse type names only for identical silicon)."""
        gov = self._governors[name]
        if self.topology is not None:
            order = [t for t in self.topology.fastest_first()]
        elif self.cluster is not None:
            seen: dict[str, object] = {}
            for m in self.cluster.nodes:
                for t in m.topology().types:
                    seen.setdefault(t.name, t)
            order = sorted(seen.values(),
                           key=lambda t: (-t.speed, t.socket))
        else:
            return []
        own = gov.topology
        if own is None:
            return [t.name for t in order]
        floor = gov.spec.min_borrow_speed * min(t.speed for t in own.types)
        return [t.name for t in order if t.speed >= floor - 1e-12]

    # -- broker verbs (stat-keeping wrappers) --------------------------------

    def lend(self, name: str, cpu: int) -> str:
        """App releases ``cpu`` into the pool; returns the new holder
        (the owner on a pending reclaim hand-over, else "")."""
        self.stats[name].lends += 1
        return self.broker.lend(name, cpu)

    def return_cpu(self, name: str, cpu: int) -> str:
        """Borrower honors a reclaim flag at a task boundary; returns
        the owner's name."""
        self.stats[name].returns += 1
        return self.broker.return_cpu(name, cpu)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict[str, dict[str, int]]:
        """Cluster-wide view: per-app Δ, held CPUs, broker calls and
        share-flow counters (for dashboards/tests)."""
        out: dict[str, dict[str, int]] = {}
        for name, gov in self._governors.items():
            row = dict(self.stats[name].as_dict())
            row["calls"] = self.broker.job_calls(name)
            row["delta"] = (gov.predictor.delta
                            if gov.predictor is not None else 0)
            row["active"] = (gov.manager.active
                             if gov.manager is not None else 0)
            out[name] = row
        return out


# ---------------------------------------------------------------------------
# Cluster-level reporting
# ---------------------------------------------------------------------------


def jain_fairness(values: Mapping[str, float]) -> float:
    """Jain's fairness index over per-app values (1.0 = perfectly fair,
    1/N = one app gets everything).  Empty input ⇒ 1.0."""
    xs = [v for v in values.values() if v > 0]
    if not xs:
        return 1.0
    s = sum(xs)
    s2 = sum(x * x for x in xs)
    return (s * s) / (len(xs) * s2) if s2 > 0 else 1.0


@dataclass(frozen=True)
class MultiAppReport:
    """Aggregate + fairness metrics for one co-scheduled run.

    ``slowdown[app]`` is co-scheduled makespan / solo makespan on the
    same CPU partition (< 1.0 means the app *gained* from borrowing);
    ``fairness`` is Jain's index over per-app speedups (1/slowdown).
    ``aggregate_edp`` is Σ_app energy × cluster makespan — the
    cluster-operator's single-number cost of the co-schedule.
    """

    apps: dict[str, GovernorReport]
    makespan: float
    aggregate_energy: float
    aggregate_edp: float
    total_dlb_calls: int
    solo: dict[str, GovernorReport] = field(default_factory=dict)
    slowdown: dict[str, float] = field(default_factory=dict)
    fairness: float = 1.0
    #: app -> home node for multi-node runs (empty on one box)
    placement: dict[str, int] = field(default_factory=dict)

    @classmethod
    def build(cls, apps: Mapping[str, GovernorReport],
              total_dlb_calls: int,
              solo: Mapping[str, GovernorReport] | None = None,
              placement: Mapping[str, int] | None = None,
              ) -> "MultiAppReport":
        makespan = max((r.makespan for r in apps.values()), default=0.0)
        energy = sum(r.energy for r in apps.values())
        slowdown: dict[str, float] = {}
        if solo:
            for name, rep in apps.items():
                base = solo.get(name)
                if base is not None and base.makespan > 0:
                    slowdown[name] = rep.makespan / base.makespan
        speedups = {n: 1.0 / s for n, s in slowdown.items() if s > 0}
        return cls(
            apps=dict(apps),
            makespan=makespan,
            aggregate_energy=energy,
            aggregate_edp=energy * makespan,
            total_dlb_calls=total_dlb_calls,
            solo=dict(solo) if solo else {},
            slowdown=slowdown,
            fairness=jain_fairness(speedups),
            placement=dict(placement) if placement else {},
        )
