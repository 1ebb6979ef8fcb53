"""The unified resource governor — one declarative spec + policy registry
driving every monitoring→prediction→policy loop in the repo.

The paper contributes a single control loop (Algorithms 1–2): a
:class:`~repro.core.monitoring.TaskMonitor` aggregates per-type workload, a
:class:`~repro.core.prediction.CPUPredictor` turns it into the optimal
resource count Δ, and a :class:`~repro.core.policies.Policy` applies Δ to
idle/resume (or lend/acquire) decisions.  Four frontends reuse that loop at
different granularities — threads (``runtime.thread_executor``), simulated
cores (``runtime.sim``), DP training replicas (``train.elastic``) and
serving replicas (``serving.autoscale``) — and before this module each
wired the stack by hand with diverging defaults.

:class:`GovernorSpec` is the single declarative description of a stack
(resource count, policy + params, prediction config, power model,
monitoring toggle), :class:`ResourceGovernor` assembles and owns the
``TaskMonitor → CPUPredictor → Policy → WorkerManager → EnergyMeter``
pipeline behind one lifecycle surface, and the string→factory **policy
registry** (:func:`register_policy`) lets new policies plug in without
touching core or any frontend.

Frontends come in two shapes, both served by the same governor:

* **push/worker-loop** (executors): workers call ``on_task_started`` /
  ``on_task_finished`` / ``on_poll_empty`` / ``on_tasks_added``, a ticker
  calls ``tick()``; pass a ``clock`` so the worker-state half
  (:class:`~repro.core.manager.WorkerManager` +
  :class:`~repro.core.energy.EnergyMeter`) is built.
* **pull/target** (autoscaler, elastic trainer): the frontend feeds monitor
  events and periodically asks ``target(queued, active)`` for the desired
  replica count; no clock needed, no worker state is built.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Callable, Mapping

from .energy import CoreState, EnergyMeter, PowerModel
from .events import QUIET_INTEREST as _QUIET
from .events import EventBus, EventKind, RuntimeEvent
from .manager import WorkerManager
from .monitoring import DEFAULT_MIN_SAMPLES, AccuracyReport, TaskMonitor
from .policies import (BusyPolicy, HeteroPredictionPolicy, HybridPolicy,
                       IdlePolicy, Policy, PollDecision, PredictionPolicy)
from .prediction import CPUPredictor, PredictionConfig
from .sharing import DLBHybridPolicy, DLBPredictionPolicy, LeWIPolicy
from .topology import CoreTopology, CoreType

__all__ = [
    "GovernorSpec",
    "GovernorReport",
    "ResourceGovernor",
    "PolicyEntry",
    "register_policy",
    "registered_policies",
    "policy_entry",
    "DEFAULT_MIN_SAMPLES",
]


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyEntry:
    """Registry record for one policy name."""

    name: str
    factory: Callable[["GovernorSpec", CPUPredictor | None], Policy]
    #: the governor must build a CPUPredictor and pass it to the factory
    needs_predictor: bool = False
    #: DLB-style resource sharing: empty polls may LEND the CPU away and
    #: the predictor runs with oversubscription allowed (paper §3.3)
    sharing: bool = False
    #: the policy plans per core type: the governor synthesizes a
    #: single-type :class:`CoreTopology` when the spec carries none
    needs_topology: bool = False
    #: for sharing policies: the registered non-sharing policy that
    #: behaves identically when the app runs alone (no co-tenants to
    #: trade CPUs with) — the arbiter runs fairness baselines under it
    solo_equivalent: str | None = None


_REGISTRY: dict[str, PolicyEntry] = {}


def register_policy(name: str, *, needs_predictor: bool = False,
                    sharing: bool = False, needs_topology: bool = False,
                    solo_equivalent: str | None = None):
    """Decorator registering ``factory(spec, predictor) -> Policy``.

    Downstream code adds policies without touching core::

        @register_policy("my-policy", needs_predictor=True)
        def _my_policy(spec, predictor):
            return MyPolicy(predictor, **spec.policy_params)
    """
    def deco(factory):
        _REGISTRY[name] = PolicyEntry(name=name, factory=factory,
                                      needs_predictor=needs_predictor,
                                      sharing=sharing,
                                      needs_topology=needs_topology,
                                      solo_equivalent=solo_equivalent)
        return factory
    return deco


def registered_policies() -> list[str]:
    """All registered policy names (sorted) — includes DLB policies."""
    return sorted(_REGISTRY)


def policy_entry(name: str) -> PolicyEntry:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise ValueError(
            f"unknown policy {name!r}; registered policies: "
            + ", ".join(registered_policies()))
    return entry


# -- built-in policies (paper §2/§3.2 + §3.3) --------------------------------


@register_policy("busy")
def _busy(spec: "GovernorSpec", predictor: CPUPredictor | None) -> Policy:
    return BusyPolicy()


@register_policy("idle")
def _idle(spec: "GovernorSpec", predictor: CPUPredictor | None) -> Policy:
    return IdlePolicy()


@register_policy("hybrid")
def _hybrid(spec: "GovernorSpec", predictor: CPUPredictor | None) -> Policy:
    return HybridPolicy(spin_budget=spec.spin_budget)


@register_policy("prediction", needs_predictor=True)
def _prediction(spec: "GovernorSpec",
                predictor: CPUPredictor | None) -> Policy:
    assert predictor is not None
    return PredictionPolicy(predictor)


@register_policy("hetero-prediction", needs_predictor=True,
                 needs_topology=True)
def _hetero_prediction(spec: "GovernorSpec",
                       predictor: CPUPredictor | None) -> Policy:
    assert predictor is not None
    return HeteroPredictionPolicy(predictor)


@register_policy("dlb-lewi", sharing=True, solo_equivalent="idle")
def _dlb_lewi(spec: "GovernorSpec",
              predictor: CPUPredictor | None) -> Policy:
    return LeWIPolicy()


@register_policy("dlb-hybrid", sharing=True, solo_equivalent="hybrid")
def _dlb_hybrid(spec: "GovernorSpec",
                predictor: CPUPredictor | None) -> Policy:
    return DLBHybridPolicy(spin_budget=spec.spin_budget)


@register_policy("dlb-prediction", needs_predictor=True, sharing=True,
                 solo_equivalent="prediction")
def _dlb_prediction(spec: "GovernorSpec",
                    predictor: CPUPredictor | None) -> Policy:
    assert predictor is not None
    return DLBPredictionPolicy(predictor)


# ---------------------------------------------------------------------------
# Declarative spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GovernorSpec:
    """Declarative description of one governor stack.

    The same spec drives every frontend: ``resources`` means worker
    threads in the executor, cores in the simulator, and replicas in the
    elastic trainer / serving autoscaler.
    """

    #: number of resources (threads / cores / replicas) owned — required,
    #: so no frontend can silently run on a forgotten default (e.g. a
    #: 1-core simulation of a 48-core machine)
    resources: int
    #: registered policy name (see :func:`registered_policies`)
    policy: str = "busy"
    #: Algorithm 1 configuration (rate f, min_samples, fallbacks).
    #: ``prediction.min_samples`` is the single source of truth for the
    #: sample-count threshold — :data:`DEFAULT_MIN_SAMPLES` (= 4)
    #: everywhere, replacing the old 4-vs-3 split between executors and
    #: the elastic/serving controllers.
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    #: consecutive empty polls before hybrid-style policies stop spinning
    spin_budget: int = 100
    #: force monitoring on/off; None ⇒ on iff the policy needs predictions
    monitoring: bool | None = None
    #: energy proxy model (None ⇒ default PowerModel)
    power: PowerModel | None = None
    #: floor for ``target()`` while load is present (autoscaler/elastic)
    min_resources: int = 0
    #: heterogeneous-core description; None ⇒ homogeneous resources
    #: (the sim injects the machine's topology for asymmetric presets)
    topology: CoreTopology | None = None
    #: which core types are trimmed first when Δ drops — "slow-first"
    #: parks the slowest types first (matches the predictor filling the
    #: fastest cores first); "fast-first" parks the fast cores first
    #: ("park the P-cores last" vs "park the E-cores last")
    park_order: str = "slow-first"
    #: co-scheduling arbiter: only borrow foreign cores whose type speed
    #: is ≥ this fraction of the app's slowest *owned* core.  The
    #: default 1.0 ("never borrow silicon slower than your own") keeps
    #: barrier-bound apps from diluting their critical path with slow
    #: cores while still letting slow-core owners borrow fast ones; it
    #: is a no-op on homogeneous machines (all speeds equal).  0.0
    #: accepts any core (pure throughput apps).
    min_borrow_speed: float = 1.0
    #: multi-node clusters: never borrow a core whose node is farther
    #: than this from the app's home node (cluster distance units).
    #: None (default) = unlimited — the effective-speed guard (the
    #: remote penalty folded into ``min_borrow_speed``) still applies.
    #: Serialized only when set, so pre-cluster spec dicts round-trip
    #: unchanged.
    max_borrow_distance: float | None = None
    #: extra kwargs for custom registered policy factories
    policy_params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.resources < 1:
            raise ValueError("resources must be >= 1")
        if self.spin_budget < 1:
            raise ValueError("spin_budget must be >= 1")
        if not 0 <= self.min_resources <= self.resources:
            raise ValueError("min_resources must be in [0, resources]")
        if self.park_order not in ("slow-first", "fast-first"):
            raise ValueError(
                f"park_order must be 'slow-first' or 'fast-first', "
                f"got {self.park_order!r}")
        if self.min_borrow_speed < 0.0:
            raise ValueError(
                f"min_borrow_speed must be >= 0, "
                f"got {self.min_borrow_speed}")
        if (self.max_borrow_distance is not None
                and self.max_borrow_distance < 0.0):
            raise ValueError(
                f"max_borrow_distance must be >= 0, "
                f"got {self.max_borrow_distance}")
        if (self.topology is not None
                and self.topology.n_cores != self.resources):
            raise ValueError(
                f"topology has {self.topology.n_cores} cores, "
                f"but resources is {self.resources}")

    # -- serialization (configs / CLI round-trip) ---------------------------

    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        d["policy_params"] = dict(self.policy_params)
        if self.power is None:
            d.pop("power")
        if self.topology is None:
            d.pop("topology")
        else:
            d["topology"] = self.topology.to_dict()
        if self.max_borrow_distance is None:
            d.pop("max_borrow_distance")
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GovernorSpec":
        d = dict(d)
        if isinstance(d.get("prediction"), Mapping):
            d["prediction"] = PredictionConfig(**d["prediction"])
        if isinstance(d.get("power"), Mapping):
            d["power"] = PowerModel(**d["power"])
        if isinstance(d.get("topology"), Mapping):
            d["topology"] = CoreTopology.from_dict(d["topology"])
        return cls(**d)


# ---------------------------------------------------------------------------
# Unified report schema
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GovernorReport:
    """One metrics schema for every frontend (replaces the divergent
    ``ExecutorReport`` / ``SimReport``): benchmarks and launchers compare
    policies through these fields regardless of which stack produced them.
    Simulator-only fields (``state_seconds``, ``dlb_calls``,
    ``monitor_events``) default to empty/zero elsewhere."""

    policy: str
    makespan: float
    energy: float
    edp: float
    tasks_completed: int
    resumes: int
    idles: int
    predictions: int
    accuracy: AccuracyReport | None
    name: str = ""
    state_seconds: dict[str, float] = field(default_factory=dict)
    dlb_calls: int = 0
    monitor_events: int = 0
    #: per-core-type state seconds ({} on homogeneous stacks)
    state_seconds_by_type: dict[str, dict[str, float]] = field(
        default_factory=dict)
    #: last recommended DVFS step per core type ({} without predictions)
    freq_by_type: dict[str, float] = field(default_factory=dict)
    #: CPU-flow counters from the co-scheduling arbiter
    #: (lends/acquired/returns/reclaims; {} outside arbitrated runs)
    sharing: dict[str, int] = field(default_factory=dict)
    #: multi-node cluster runs: home node, cross-node dependency
    #: transfers charged to this app, and explicit migrations (defaults
    #: — None/0 — everywhere else, keeping single-node reports
    #: bit-identical to the pre-cluster schema)
    node: int | None = None
    transfers: int = 0
    transfer_seconds: float = 0.0
    migrations: int = 0
    #: seconds the run's aggregate power draw sat above the active
    #: power cap (0.0 on cap-free runs; ``repr=False`` keeps reports
    #: from unperturbed runs textually identical to the pre-conditions
    #: schema)
    cap_violation_s: float = field(default=0.0, repr=False)
    #: serving-robustness metrics from the :class:`SimServing` frontend
    #: (latency percentiles, per-class SLO attainment, goodput,
    #: shed/retry/hedge/degrade counts).  ``{}`` everywhere else;
    #: ``repr=False`` keeps non-serving reports textually identical to
    #: the pre-overload schema.
    serving: dict[str, Any] = field(default_factory=dict, repr=False)


# ---------------------------------------------------------------------------
# The governor facade
# ---------------------------------------------------------------------------


class ResourceGovernor:
    """Assembles and owns one monitoring→prediction→policy stack.

    Parameters
    ----------
    spec:
        The declarative description; the policy name is resolved through
        the registry at construction time.
    clock:
        Time source (wall or virtual).  When given, the worker-state half
        of the stack (:class:`WorkerManager` + :class:`EnergyMeter`) is
        built; pull-style frontends (autoscaler, elastic) omit it.
    monitor:
        Use an externally-owned :class:`TaskMonitor` (e.g. the serving
        engine feeds request events into a monitor shared with the
        autoscaler's governor) instead of building one.
    worker_ids:
        Explicit resource ids (the simulator uses global cpu ids);
        defaults to ``range(spec.resources)``.
    t0:
        Epoch for energy integration (virtual ``now`` in the simulator).
    bus:
        Runtime :class:`~repro.core.events.EventBus` shared with the
        frontend.  The governor publishes ``PREDICTION`` events on every
        tick and hands the bus to the :class:`WorkerManager` so worker
        state transitions are observable (trace recorders subscribe to
        the same bus the scheduler publishes task lifecycle events on).
    """

    def __init__(self, spec: GovernorSpec, *,
                 clock: Callable[[], float] | None = None,
                 monitor: TaskMonitor | None = None,
                 worker_ids: list[int] | None = None,
                 t0: float = 0.0,
                 bus: EventBus | None = None) -> None:
        entry = policy_entry(spec.policy)
        self.spec = spec
        self.entry = entry
        self.sharing = entry.sharing
        self.bus = bus
        self._clock = clock
        self.topology: CoreTopology | None = spec.topology
        # Synthesized topologies (hetero policies on a flat resource
        # pool) reduce to the homogeneous algorithms and must not leak
        # a made-up type name into per-type reports; explicit ones do
        # report, even single-type (e.g. a job sliced to the E-cores).
        self._topology_synthesized = (spec.topology is None
                                      and entry.needs_topology)
        if self.topology is None and entry.needs_topology:
            self.topology = CoreTopology.homogeneous(spec.resources)
        needs_monitor = entry.needs_predictor or bool(spec.monitoring)
        if monitor is not None:
            self.monitor: TaskMonitor | None = monitor
        elif needs_monitor:
            self.monitor = TaskMonitor(
                min_samples=spec.prediction.min_samples)
        else:
            self.monitor = None
        self.predictor: CPUPredictor | None = None
        if entry.needs_predictor:
            assert self.monitor is not None
            cfg = spec.prediction
            if entry.sharing and not cfg.allow_oversubscription:
                # paper §3.3: DLB-prediction runs Alg. 1 "slightly
                # modified to allow a superior number of CPUs"
                cfg = replace(cfg, allow_oversubscription=True)
            self.predictor = CPUPredictor(self.monitor,
                                          n_cpus=spec.resources, config=cfg,
                                          topology=self.topology)
        self.policy: Policy = entry.factory(spec, self.predictor)
        # DVFS bookkeeping is only live with a predictor + energy meter
        # + explicit topology; cache the verdict off the tick hot path.
        self._dvfs = (self.predictor is not None and clock is not None
                      and self.topology is not None)
        self.manager: WorkerManager | None = None
        self.energy: EnergyMeter | None = None
        self._type_of_worker: dict[int, str] = {}
        # Last applied type→step map, replaced wholesale at tick time so
        # the per-task-start frequency_of() read is lock-free.
        self._freq_cache: dict[str, float] = {}
        # Thermal frequency ceilings per core type (machine conditions);
        # empty on unperturbed stacks — apply_frequencies() clamps the
        # predictor's recommendation against these.
        self._thermal_caps: dict[str, float] = {}
        #: live machine-condition view (see :meth:`attach_conditions`);
        #: None on unperturbed stacks
        self.conditions = None
        if clock is not None:
            ids = (list(worker_ids) if worker_ids is not None
                   else list(range(spec.resources)))
            topo = self.topology
            core_type_of = None
            park_order = None
            if topo is not None:
                # positional worker→core-type mapping (the i-th owned
                # worker runs on the topology's i-th core)
                self._type_of_worker = {w: topo.type_of(i)
                                        for i, w in enumerate(ids)}
                core_type_of = self._core_type_of
                ordered = sorted(topo.types, key=lambda t: t.speed)
                if spec.park_order == "fast-first":
                    ordered = list(reversed(ordered))
                park_order = [t.name for t in ordered]
                if self.monitor is not None:
                    self.monitor.set_core_type_of(self._core_type_of,
                                                  freq_of=self.frequency_of)
            self.energy = EnergyMeter(0, spec.power, t0=t0)
            for i, w in enumerate(ids):
                ct = topo.core_type_at(i) if topo is not None else None
                self.energy.add_core(
                    w, CoreState.SPIN, t0,
                    power=(ct.power if ct is not None and ct.power
                           is not None else spec.power),
                    core_type=(ct.name if topo is not None
                               and not self._topology_synthesized
                               else ""))
            self.manager = WorkerManager(len(ids), self.policy, clock=clock,
                                         energy=self.energy, worker_ids=ids,
                                         bus=bus,
                                         core_type_of=core_type_of,
                                         park_order=park_order)
            if isinstance(self.policy, HeteroPredictionPolicy):
                self.policy.bind_topology(
                    self._core_type_of,
                    self.manager._active_by_type_locked)

    def _core_type_of(self, worker_id: int) -> str:
        ct = self._type_of_worker.get(worker_id)
        if ct is not None:
            return ct
        # Last resort for foreign CPUs never announced via
        # :meth:`adopt_worker`: map positionally through the topology
        # (global ids wrap per machine; wrong for sliced topologies,
        # which is why executors should adopt borrowed workers).
        if self.topology is not None:
            return self.topology.type_of(worker_id)
        return ""

    def adopt_worker(self, worker_id: int,
                     core_type: "CoreType | None" = None) -> None:
        """Register a foreign (borrowed) CPU with its true identity: the
        executor knows which physical core arrived, the governor does
        not.  Feeds the α_{j,c} mapping, per-type energy billing and
        DVFS-step lookup for the borrowed core."""
        mgr = self._require_manager()
        if core_type is None:
            mgr.add_worker(worker_id)
            return
        self._type_of_worker[worker_id] = core_type.name
        mgr.add_worker(
            worker_id,
            power=(core_type.power if core_type.power is not None
                   else self.spec.power),
            core_type=(core_type.name
                       if not self._topology_synthesized else ""))
        # bill the adopted core at the step its service times will use
        q = self._freq_cache.get(core_type.name)
        if q is not None and self.energy is not None \
                and self._clock is not None:
            self.energy.set_frequency(worker_id, q, self._clock())

    # -- machine conditions --------------------------------------------------

    def attach_conditions(self, conditions) -> None:
        """Install a :class:`~repro.core.conditions.MachineConditions`
        live view.  The monitor learns which workers are suspected
        stragglers (their samples skip the α EMAs); thermal and
        availability changes are pushed by the frontend through
        :meth:`apply_thermal` / :meth:`set_failed_workers` as the
        perturbations fire."""
        self.conditions = conditions
        if self.monitor is not None and conditions is not None:
            self.monitor.set_suspect_of(conditions.is_suspect)

    def apply_thermal(self, caps: Mapping[str, float],
                      now: float | None = None) -> None:
        """Install thermal frequency ceilings per core type (an empty
        mapping lifts all throttles) and rebuild the effective DVFS map:
        for each type, min(predictor's recommended step, thermal cap).
        On homogeneous stacks (no topology) the tightest cap applies to
        every worker under the ``""`` key — :meth:`frequency_of`
        resolves untyped workers through it, and a non-empty map
        disengages the simulator's flat fast path so throttling bites
        even on machines with a single nominal step."""
        self._thermal_caps = dict(caps)
        if self.energy is None or self._clock is None:
            return
        if now is None:
            now = self._clock()
        pred = (self.predictor.freq_by_type
                if self._dvfs and self.predictor is not None else {})
        eff: dict[str, float] = {}
        if self.topology is not None:
            for t in self.topology.types:
                q = min(pred.get(t.name, 1.0), caps.get(t.name, 1.0))
                if q != 1.0:
                    eff[t.name] = q
            for w, ct in self._type_of_worker.items():
                self.energy.set_frequency(w, eff.get(ct, 1.0), now)
        else:
            q = min(caps.values()) if caps else 1.0
            if q != 1.0:
                eff[""] = q
            for w in self.energy.core_ids():
                self.energy.set_frequency(w, q, now)
        self._freq_cache = eff

    def set_failed_workers(self, failed: list[int]) -> None:
        """Tell the predictor which of this governor's workers are dead
        so Δ and the hetero plan stop counting them (an empty list
        restores the all-healthy view)."""
        if self.predictor is None:
            return
        if not failed:
            self.predictor.set_availability(None)
            return
        topo = self.topology
        if topo is None:
            n_alive = max(0, self.spec.resources - len(failed))
            self.predictor.set_availability({"": n_alive})
            return
        alive = {t.name: t.count for t in topo.types}
        for w in failed:
            ct = self._core_type_of(w)
            if ct in alive and alive[ct] > 0:
                alive[ct] -= 1
        self.predictor.set_availability(alive)

    # -- push-style lifecycle (executors: Alg. 2 hooks) ----------------------

    def _require_manager(self) -> WorkerManager:
        if self.manager is None:
            raise RuntimeError(
                "this governor was built without a clock; worker-loop "
                "hooks need ResourceGovernor(spec, clock=...)")
        return self.manager

    def on_task_started(self, worker_id: int) -> None:
        self._require_manager().task_started(worker_id)

    def on_task_finished(self, worker_id: int) -> None:
        self._require_manager().task_finished(worker_id)

    def on_poll_empty(self, worker_id: int,
                      spin_count_override: int | None = None) -> PollDecision:
        return self._require_manager().poll_empty(
            worker_id, spin_count_override=spin_count_override)

    def on_tasks_added(self, ready_tasks: int) -> list[int]:
        """Tasks became ready; returns worker ids to actually wake."""
        return self._require_manager().notify_added(ready_tasks)

    def reevaluate_spinners(self) -> list[int]:
        return self._require_manager().reevaluate_spinners()

    def tick(self) -> int:
        """One prediction-rate tick; returns the fresh Δ (or the full
        resource count for non-predictive policies)."""
        self.policy.on_prediction_tick()
        if self.predictor is None:
            # Non-predictive policies tick for bookkeeping only; they
            # make no predictions, so no PREDICTION event is published
            # (keeps thread-recorded traces consistent with the
            # simulator, which only schedules ticks when the policy
            # uses predictions).
            return self.spec.resources
        if self._dvfs:
            self.apply_frequencies()
        delta = self.predictor.delta
        bus = self.bus
        if bus is not None and bus.interest != _QUIET:
            self._publish_prediction(delta)
        return delta

    def apply_frequencies(self) -> dict[str, float]:
        """Apply the predictor's recommended DVFS step per core type to
        the energy meter (no-op on homogeneous / clock-less stacks).
        Returns the applied type→step map."""
        if (self.predictor is None or self.energy is None
                or self.topology is None or self._clock is None):
            return {}
        freqs = self.predictor.freq_by_type
        if not freqs:
            return {}
        caps = self._thermal_caps
        if caps:
            # thermal ceilings win over the predictor's recommendation
            freqs = {ct: min(q, caps.get(ct, 1.0))
                     for ct, q in freqs.items()}
        now = self._clock()
        for w, ct in self._type_of_worker.items():
            q = freqs.get(ct)
            if q is not None:
                self.energy.set_frequency(w, q, now)
        self._freq_cache = freqs
        return freqs

    def frequency_of(self, worker_id: int) -> float:
        """Current DVFS step of ``worker_id`` (1.0 when un-clocked) —
        the simulator divides service times by this.  Reads the
        tick-time cache, so the per-task hot path takes no lock."""
        freqs = self._freq_cache
        if not freqs:
            return 1.0
        return freqs.get(self._core_type_of(worker_id), 1.0)

    def _publish_prediction(self, delta: int) -> None:
        if self.bus is None or not self.bus.interested(EventKind.PREDICTION):
            return
        now = (self._clock() if self._clock is not None
               else time.perf_counter())
        self.bus.publish(RuntimeEvent(
            kind=EventKind.PREDICTION, time=now, data={"delta": delta}))

    # -- pull-style surface (autoscaler / elastic) ---------------------------

    def target(self, queued: int, active: int) -> int:
        """Desired resource count for the current load, policy-decided.

        Ticks the predictor (if any), asks the policy, then clamps to
        ``[min_resources, resources]`` — the floor applies only while
        load exists, so scale-to-zero policies can return 0.
        """
        self.policy.on_prediction_tick()
        raw = self.policy.target(queued, active, self.spec.resources)
        load = queued + active
        if load <= 0 and raw <= 0:
            target = 0
        else:
            floor = self.spec.min_resources if load > 0 else 0
            target = max(floor, min(raw, self.spec.resources))
        # Pull-style frontends have no tick loop; the target decision IS
        # their prediction sample (published only for predictive
        # policies, matching the executors).
        if self.predictor is not None:
            self._publish_prediction(target)
        return target

    def live_load(self) -> int:
        """Live (ready + executing) instances known to the monitor."""
        if self.monitor is None:
            return 0
        return self.monitor.live_instances()

    # -- reporting -----------------------------------------------------------

    def finish(self, now: float) -> None:
        if self.energy is not None:
            self.energy.finish(now)

    def report(self, *, name: str = "", makespan: float | None = None,
               tasks_fallback: int = 0, dlb_calls: int = 0,
               monitor_events: int = 0,
               sharing: Mapping[str, int] | None = None,
               node: int | None = None, transfers: int = 0,
               transfer_seconds: float = 0.0,
               migrations: int = 0) -> GovernorReport:
        """Assemble the unified report (``finish()`` must have run)."""
        energy_meter = self.energy
        if energy_meter is None:
            raise RuntimeError("report() needs the energy/manager half "
                               "(build the governor with a clock)")
        manager = self._require_manager()
        if makespan is None:
            makespan = energy_meter.elapsed()
        energy = energy_meter.energy()
        return GovernorReport(
            policy=self.spec.policy,
            makespan=makespan,
            energy=energy,
            edp=energy * makespan,
            tasks_completed=(self.monitor.completed_instances()
                            if self.monitor else tasks_fallback),
            resumes=manager.resumes,
            idles=manager.idles,
            predictions=(self.predictor.predictions_made
                         if self.predictor else 0),
            accuracy=(self.monitor.accuracy_report()
                      if self.monitor else None),
            name=name,
            state_seconds={s.value: v for s, v
                           in energy_meter.state_seconds().items()},
            dlb_calls=dlb_calls,
            monitor_events=monitor_events,
            state_seconds_by_type={
                ct: {s.value: v for s, v in acc.items()}
                for ct, acc in
                energy_meter.state_seconds_by_type().items()},
            freq_by_type=(dict(self.predictor.freq_by_type)
                          if self.predictor is not None
                          and not self._topology_synthesized else {}),
            sharing=dict(sharing) if sharing else {},
            node=node,
            transfers=transfers,
            transfer_seconds=transfer_seconds,
            migrations=migrations,
            cap_violation_s=energy_meter.cap_violation_s,
        )
