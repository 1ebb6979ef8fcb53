"""Algorithm 1 — predicting the optimal CPU utilization ``Δ`` (paper §3.1).

Given the per-type live workload ``W_{ready,j} + W_{exec,j}`` (in cost
units), the unitary costs ``α_j`` (seconds per cost unit) and the prediction
rate ``f`` (seconds between predictions), accumulate

    γ ← Σ_j (W_{ready,j} + W_{exec,j}) · α_j / f

over task types, early-exiting once ``γ ≥ N_CPUs`` (the paper's
``while (γ < N_CPUs)`` loop), then

    Δ = min(⌈γ⌉, Σ_j M_j)   with   0 < Δ ≤ N_CPUs.

Types whose ``α_j`` is not yet reliable contribute their *instance count*
instead — the paper's fallback "when task timing predictions are not
available, CPU utilization predictions are based only on the number of
available tasks" (used throughout for coarse-grained Cholesky).

Heterogeneous machines (a :class:`~repro.core.topology.CoreTopology` on
the predictor) generalize Δ to a per-core-type split Δ_c plus a
recommended DVFS step per type (:meth:`CPUPredictor.compute_plan`):

* the live workload is normalized to *unit-speed seconds* through the
  per-(task-type × core-type) costs α_{j,c} (each already bakes in its
  core's speed, so α_base = α_{j,c} · speed_c);
* demand fills the **fastest cores first**; count-based fallback
  instances occupy one core each, also fastest-first;
* per core type, the recommended frequency step minimizes the modeled
  EDP ``P_active(q) / q²`` among steps that still cover the predicted
  utilization (never below ``PredictionConfig.freq_floor``, the
  critical-path dilation guard), falling back to the count-based
  maximum step whenever unknown-duration work is assigned to the type.

With a single core type at speed 1.0 and one frequency step, the plan's
total Δ reproduces the homogeneous Algorithm 1 value exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping

from ..analysis import single_writer
from .energy import CoreState, PowerModel
from .monitoring import DEFAULT_MIN_SAMPLES, TaskMonitor
from .topology import CoreTopology

__all__ = ["PredictionConfig", "CPUPredictor", "HeteroPlan"]

#: Paper §5: "Throughout the whole evaluation we used the same prediction
#: rate — f in Algorithm 1 — of 50 µs."
DEFAULT_PREDICTION_RATE_S = 50e-6


@dataclass(frozen=True)
class PredictionConfig:
    rate_s: float = DEFAULT_PREDICTION_RATE_S
    #: below this many completed samples a type's α_j is not trusted
    #: (one repo-wide default — see monitoring.DEFAULT_MIN_SAMPLES)
    min_samples: int = DEFAULT_MIN_SAMPLES
    #: force the count-based fallback for *all* types (coarse-grained mode)
    count_based_only: bool = False
    #: allow Δ above the locally-owned CPUs (used by the DLB-prediction
    #: sharing policy, which may acquire external CPUs — paper §3.3:
    #: "slightly modified to allow a superior number of CPUs")
    allow_oversubscription: bool = False
    #: cap on Δ in oversubscription mode, as a multiple of owned CPUs
    #: (a DLB deployment cannot hold more than the machine's cores; we
    #: default to the two-NUMA-node arrangement of the paper's Table 3)
    oversubscription_cap: float = 2.0
    #: lowest DVFS step the hetero plan may recommend — bounds worst-case
    #: critical-path dilation to 1/freq_floor; 1.0 disables re-clocking
    freq_floor: float = 0.75
    #: capacity headroom required before a type is stretched to a lower
    #: step (demand may exceed the prediction; 1.0 = no margin)
    freq_margin: float = 1.25

    def __post_init__(self) -> None:
        if self.rate_s <= 0:
            raise ValueError(f"rate_s must be > 0, got {self.rate_s}")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")
        if self.oversubscription_cap < 1.0:
            raise ValueError("oversubscription_cap must be >= 1.0")
        if not 0.0 < self.freq_floor <= 1.0:
            raise ValueError(
                f"freq_floor must be in (0, 1], got {self.freq_floor}")
        if self.freq_margin < 1.0:
            raise ValueError("freq_margin must be >= 1.0")


@dataclass(frozen=True)
class HeteroPlan:
    """One heterogeneous prediction: total Δ, its per-core-type split and
    the recommended DVFS step per type."""

    delta: int
    by_type: Mapping[str, int] = field(default_factory=dict)
    freq: Mapping[str, float] = field(default_factory=dict)


@single_writer("_delta", "_plan", "_memo_version", "_memo_valid",
               "predictions_made", "_alive_by_type", "_n_alive")
class CPUPredictor:
    """Computes and caches ``Δ``; thread-safe.

    The executor (real or simulated) calls :meth:`tick` every ``rate_s``
    seconds; policies read :attr:`delta` (the paper stores Δ in an atomic
    variable read by the CPU manager, Alg. 2).  With a ``topology``,
    :meth:`tick` runs the heterogeneous plan and policies may also read
    :attr:`delta_by_type` / :attr:`freq_by_type`.
    """

    def __init__(self, monitor: TaskMonitor, n_cpus: int,
                 config: PredictionConfig | None = None,
                 topology: CoreTopology | None = None) -> None:
        if n_cpus <= 0:
            raise ValueError("n_cpus must be positive")
        if topology is not None and topology.n_cores != n_cpus:
            raise ValueError(
                f"topology has {topology.n_cores} cores, "
                f"but n_cpus is {n_cpus}")
        self.monitor = monitor
        self.n_cpus = n_cpus
        self.config = config or PredictionConfig()
        self.topology = topology
        self._delta = n_cpus  # optimistic start: all CPUs
        self._plan: HeteroPlan | None = None
        if topology is not None:
            self._plan = HeteroPlan(
                delta=n_cpus,
                by_type={t.name: t.count for t in topology.types},
                freq={t.name: t.max_freq for t in topology.types})
        self.predictions_made = 0
        # tick() memo: last monitor version the delta/plan was computed
        # against (-1 ⇒ never computed).
        self._memo_version = -1
        self._memo_valid = False
        # Core availability under dynamic machine conditions: None ⇒
        # every core healthy (the pre-conditions fast path — zero
        # lookups anywhere below).  Set by the governor when cores fail
        # or recover; dead cores drop out of Δ and the hetero plan.
        self._alive_by_type: dict[str, int] | None = None
        self._n_alive: int | None = None

    def set_availability(self, alive_by_type: dict[str, int] | None,
                         ) -> None:
        """Install the per-core-type count of *alive* cores (None
        restores the all-healthy default).  Invalidates the tick memo:
        the plan is no longer a pure function of the monitor snapshot
        alone."""
        self._alive_by_type = (dict(alive_by_type)
                               if alive_by_type is not None else None)
        self._n_alive = (sum(alive_by_type.values())
                         if alive_by_type is not None else None)
        self._memo_version = -1
        self._memo_valid = False

    def _alive(self, type_name: str, count: int) -> int:
        """Alive cores of ``type_name`` (``count`` when unconditioned)."""
        a = self._alive_by_type
        if a is None:
            return count
        return a.get(type_name, count)

    # -- Algorithm 1 ---------------------------------------------------------

    def compute_delta(self, n_cpus: int | None = None) -> int:
        """One evaluation of Algorithm 1 against the monitor's workload
        aggregates (fused single pass — see
        :meth:`~repro.core.monitoring.TaskMonitor.fold_gamma`; the
        early-exit bound is the paper's ``while (γ < N_CPUs)``)."""
        cfg = self.config
        n = self.n_cpus if n_cpus is None else n_cpus
        if self._n_alive is not None and self._n_alive < n:
            n = max(1, self._n_alive)
        gamma, total_instances = self.monitor.fold_gamma(
            cfg.min_samples, cfg.rate_s, cfg.count_based_only,
            limit=None if cfg.allow_oversubscription else n)
        if total_instances == 0:
            # No live work: keep one CPU awake to pick up new work
            # (Alg. 1 ensures 0 < Δ).
            return 1
        delta = min(math.ceil(gamma), total_instances)
        if cfg.allow_oversubscription:
            delta = min(delta, int(cfg.oversubscription_cap * n))
        else:
            delta = min(delta, n)
        return max(1, delta)

    # -- heterogeneous Algorithm 1 -------------------------------------------

    def compute_plan(self) -> HeteroPlan:
        """Per-core-type Δ_c (fastest cores first) + frequency steps."""
        topo = self.topology
        if topo is None:
            raise RuntimeError("compute_plan() needs a CoreTopology")
        cfg = self.config
        order = topo.fastest_first()
        max_freqs = {t.name: t.max_freq for t in topo.types}
        # Alive cores per type: identical to the nominal counts unless
        # set_availability() installed a failure view (then dead cores
        # vanish from every width/cap below).
        alive = {t.name: self._alive(t.name, t.count) for t in topo.types}

        # 1. Normalize the live workload to unit-speed seconds (γ's
        #    numerator) + the count-based fallback instance pool.
        demand = 0.0          # unit-speed core equivalents over one window
        fallback = 0          # instances predicted by count, one core each
        total_instances = 0
        mean_speed = topo.mean_speed()
        speeds = {t.name: t.speed for t in topo.types}
        for snap in self.monitor.workload_snapshot_hetero(cfg.min_samples):
            total_instances += snap.live_instances
            if cfg.count_based_only:
                fallback += snap.live_instances
                continue
            per_core = [(c, a, n_s) for c, (a, n_s, ok)
                        in snap.alpha_by_core.items()
                        if ok and c in speeds]
            if per_core:
                # α_{j,c} bakes in core speed; normalize each to
                # unit-speed and blend by sample count.
                num = sum(a * speeds[c] * n_s for c, a, n_s in per_core)
                den = sum(n_s for _, _, n_s in per_core)
                alpha_u = num / den
            elif snap.reliable:
                # aggregate α mixes whatever cores ran the samples;
                # first-order correction by the capacity-mean speed
                alpha_u = snap.alpha * mean_speed
            else:
                fallback += snap.live_instances
                continue
            demand += (snap.live_cost * alpha_u) / cfg.rate_s

        # fastest type that still has an alive core (order[0] when all
        # healthy — bit-identical to the pre-conditions choice)
        fastest_alive = order[0].name
        for ct in order:
            if alive[ct.name] > 0:
                fastest_alive = ct.name
                break

        if total_instances == 0:
            # keep one (fastest alive) core awake to pick up new work
            return HeteroPlan(delta=1, by_type={fastest_alive: 1},
                              freq=max_freqs)

        # 2. Fill fastest cores first: fractional per-type allocation for
        #    the timed demand, then one core per count-fallback instance.
        frac: dict[str, float] = {}
        timed_frac: dict[str, float] = {}
        remaining = demand
        fb = float(fallback)
        for ct in order:
            cap_per_core = ct.speed * ct.max_freq
            n_c = alive[ct.name]
            x = 0.0
            if remaining > 1e-12:
                x = min(float(n_c), remaining / cap_per_core)
                remaining -= x * cap_per_core
            timed_frac[ct.name] = x
            if x < n_c and fb > 0:
                y = min(n_c - x, fb)
                x += y
                fb -= y
            frac[ct.name] = x
        if cfg.allow_oversubscription and (remaining > 0 or fb > 0):
            # DLB mode may hold more CPUs than owned (paper §3.3); park
            # the overflow on the slowest type and let the cap clamp it.
            last = order[-1]
            overflow = remaining / (last.speed * last.max_freq) + fb
            timed_frac[last.name] += remaining / (last.speed
                                                  * last.max_freq)
            frac[last.name] += overflow

        # 3. Integerize so Σ Δ_c == ⌈Σ frac_c⌉ (exact homogeneous parity):
        #    cumulative ceiling, fastest types first.
        by_type: dict[str, int] = {}
        cum = 0.0
        alloc_total = 0
        for ct in order:
            cum += frac[ct.name]
            # plain ceil, exactly like the homogeneous ⌈γ⌉ (parity)
            take = max(0, math.ceil(cum) - alloc_total)
            if not cfg.allow_oversubscription:
                take = min(take, alive[ct.name])
            by_type[ct.name] = take
            alloc_total += take

        # 4. Caps (mirrors the homogeneous path): live instances, owned
        #    cores / oversubscription budget, and Δ ≥ 1.
        n_owned = (self._n_alive if self._n_alive is not None
                   else self.n_cpus)
        cap = (int(cfg.oversubscription_cap * self.n_cpus)
               if cfg.allow_oversubscription else max(1, n_owned))
        target = max(1, min(alloc_total, total_instances, cap))
        # trim surplus from the slowest allocated types first
        for ct in reversed(order):
            if alloc_total <= target:
                break
            give = min(by_type[ct.name], alloc_total - target)
            by_type[ct.name] -= give
            alloc_total -= give
        if alloc_total < target:   # all-zero after caps: wake the fastest
            by_type[fastest_alive] += target - alloc_total
            alloc_total = target

        # 4b. Fast-core reserve (speed-asymmetric topologies only): keep
        #     the fastest type fully awake while live work exists.  A
        #     parked P-core loses the instant-dispatch race to a spinning
        #     E-core, putting critical-path tasks on the slow silicon —
        #     the big.LITTLE rule is the opposite: big cores stay
        #     available for latency, little cores carry throughput and
        #     park aggressively.  Spinning ≠ executing, so the reserve
        #     ignores the instance cap; the slow types still deliver the
        #     energy savings.  (A single-speed topology takes this branch
        #     never — exact homogeneous parity.)
        reserved: str | None = None
        fastest = order[0]
        if (fastest.speed > min(t.speed for t in topo.types)
                and alive[fastest.name] > 0):
            reserved = fastest.name
            boost = alive[fastest.name] - by_type[fastest.name]
            if boost > 0:
                by_type[fastest.name] = alive[fastest.name]
                alloc_total += boost

        # 5. Frequency recommendation per type — stretch-to-fit: running
        #    *more* cores at a *lower* step preserves throughput while
        #    cutting the modeled EDP (P_active(q)/q², cubic dynamic
        #    power).  A step is feasible only when the widened core set
        #    (with ``freq_margin`` headroom) fits the type and the spare
        #    instance budget, and is never below ``freq_floor`` — both
        #    are the makespan guards.  Count-based (unknown-duration)
        #    work pins the type at its maximum step.
        budget = min(cap, total_instances) - alloc_total
        freq: dict[str, float] = {}
        for ct in order:
            granted = by_type[ct.name]
            steps = ct.freq_steps
            if (len(steps) == 1 or granted == 0
                    or ct.name == reserved   # reserve = full latency
                    or timed_frac[ct.name] <= 0.0
                    or frac[ct.name] > timed_frac[ct.name] + 1e-12):
                freq[ct.name] = ct.max_freq
                continue
            # demand on this type, in cores-at-max-step
            demand_c = timed_frac[ct.name] * ct.max_freq
            max_width = min(alive[ct.name], granted + budget)
            pm = ct.power or PowerModel()
            best_q = ct.max_freq
            best_width = granted
            best_edp = (pm.power(CoreState.ACTIVE, ct.max_freq)
                        / (ct.max_freq * ct.max_freq))
            for q in steps:
                if q < cfg.freq_floor or q >= ct.max_freq:
                    continue
                width = math.ceil(demand_c * cfg.freq_margin / q)
                if width > max_width:
                    continue   # cannot keep throughput at this step
                edp = pm.power(CoreState.ACTIVE, q) / (q * q)
                if edp < best_edp - 1e-12:
                    best_q, best_width, best_edp = q, width, edp
            freq[ct.name] = best_q
            if best_width > granted:
                budget -= best_width - granted
                alloc_total += best_width - granted
                by_type[ct.name] = best_width
        return HeteroPlan(delta=alloc_total, by_type=by_type, freq=freq)

    # -- atomic Δ (read by Alg. 2) --------------------------------------------

    def tick(self) -> int:
        """Recompute Δ (called at the prediction rate) and publish it.

        Memoized on the monitor's mutation version: Algorithm 1 is a
        pure function of the workload snapshot, so a tick that fires
        with no monitor change since the last one (an idle or spin-only
        window) reuses the previous Δ/plan instead of re-walking the
        snapshot — numerically identical, since recomputing over the
        same inputs returns the same result.
        """
        # Single-writer discipline: tick() is only ever called from one
        # thread (the sim loop / the executor's ticker), and the
        # int/reference stores below are atomic for readers — no lock.
        version = self.monitor.version
        if self.topology is not None:
            plan = self._plan
            if version != self._memo_version or plan is None:
                plan = self.compute_plan()
                self._memo_version = version
                self._plan = plan
                self._delta = plan.delta
            self.predictions_made += 1
            return plan.delta
        delta = self._delta
        if version != self._memo_version or not self._memo_valid:
            delta = self.compute_delta()
            self._memo_version = version
            self._memo_valid = True
            self._delta = delta
        self.predictions_made += 1
        return delta

    @property
    def delta(self) -> int:
        # Lock-free read: Δ is the paper's "atomic" — it is read on
        # every empty poll, and a plain int load is atomic in CPython.
        return self._delta

    @property
    def plan(self) -> HeteroPlan | None:
        return self._plan

    @property
    def delta_by_type(self) -> dict[str, int]:
        """Per-core-type Δ_c split ({} without a topology).  The live
        plan dict — read-only for callers (it is replaced wholesale, not
        mutated, on each tick)."""
        plan = self._plan
        return plan.by_type if plan else {}

    @property
    def freq_by_type(self) -> dict[str, float]:
        """Recommended DVFS step per core type ({} without a topology).
        Read-only view, same contract as :attr:`delta_by_type`."""
        plan = self._plan
        return plan.freq if plan else {}
