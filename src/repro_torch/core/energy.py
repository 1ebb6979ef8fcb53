"""Energy accounting (EDP) — the container has no RAPL, so energy is a
documented *proxy model* integrated over (virtual or wall) time:

    E = Σ_cores ∫ P(state(t), freq(t)) dt

with normalized powers ``P_active = P_spin = 1.0`` (busy-waiting burns the
same cycles as computing — the very premise of the paper's energy argument),
``P_idle = 0.1`` (sleeping core), ``P_off = 0.0`` (core lent away; the
borrower accounts for it).  EDP = E · elapsed, matching the paper's
"energy-delay product correlates both performance and energy consumption
in only one value".

Heterogeneous extensions: each core may carry its *own* power model (an
E-core draws less than a P-core in every state) and a DVFS frequency
step.  Dynamic power scales cubically with the step (P ∝ V²f with
V ∝ f — the classic first-order DVFS model); the idle floor plays the
static/leakage component, so

    P(state, q) = P_idle + (P(state) − P_idle) · q³     for active/spin

and idle/off power does not scale.  At ``q = 1`` this is exactly the
flat model, so homogeneous stacks are bit-for-bit unchanged.

The proxy preserves the paper's *ordering* of policies by construction:
busy maximizes active core-seconds, idle minimizes them at the price of
transition overhead, prediction sits in between.  Absolute Joules are out
of scope on this host.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

__all__ = ["CoreState", "PowerModel", "EnergyMeter"]


class CoreState(enum.Enum):
    ACTIVE = "active"   # executing a task
    SPIN = "spin"       # busy-waiting (polls, finds nothing)
    IDLE = "idle"       # yielded / sleeping
    OFF = "off"         # lent to another runtime (DLB) or fenced off


# Dense per-member index: hot-path accumulators are plain lists indexed
# by `state.idx` (an attribute load) instead of dicts keyed by the enum
# member (enum.__hash__ is a Python-level call, paid per segment close).
for _i, _s in enumerate(CoreState):
    _s.idx = _i


@dataclass(frozen=True)
class PowerModel:
    active: float = 1.0
    spin: float = 1.0
    idle: float = 0.1
    off: float = 0.0
    #: energy spike charged per idle→active resume (wakeup cost)
    resume_energy: float = 0.0

    def __post_init__(self) -> None:
        # power() runs once per state-segment close on the simulator hot
        # path; cache the idx→power list instead of rebuilding a dict
        # per call (frozen dataclass, hence object.__setattr__).
        by_state = [0.0] * len(CoreState)
        by_state[CoreState.ACTIVE.idx] = self.active
        by_state[CoreState.SPIN.idx] = self.spin
        by_state[CoreState.IDLE.idx] = self.idle
        by_state[CoreState.OFF.idx] = self.off
        object.__setattr__(self, "_by_state", by_state)

    def power(self, state: CoreState, freq: float = 1.0) -> float:
        """Draw at ``state`` and DVFS step ``freq``.

        Contract: ``freq`` is clamped to the physical band [0, 1].  A
        ``PowerModel`` has no knowledge of a core type's DVFS steps —
        typed validation lives where the type is known
        (:meth:`MachineModel.service_time`,
        :meth:`ResourceGovernor.apply_frequencies`) — but the cubic
        must never extrapolate: ``freq > 1`` used to silently yield
        super-unit power and ``freq < 0`` a *negative* dynamic term.
        In-band frequencies are returned bit-identically.
        """
        base = self._by_state[state.idx]
        if freq != 1.0 and (state is CoreState.ACTIVE
                            or state is CoreState.SPIN):
            if freq > 1.0:
                return base
            if freq < 0.0:
                freq = 0.0
            # cubic dynamic component over the static (idle) floor
            return self.idle + (base - self.idle) * freq ** 3
        return base


@dataclass(slots=True)
class _CoreTimeline:
    state: CoreState
    since: float
    power: PowerModel
    core_type: str = ""
    freq: float = 1.0
    joules: float = 0.0
    # state-seconds accumulator indexed by CoreState.idx
    accum: list[float] = field(
        default_factory=lambda: [0.0] * len(CoreState))
    resumes: int = 0

    def close_segment(self, now: float) -> None:
        dt = now - self.since
        if dt > 0.0:
            self.accum[self.state.idx] += dt
            self.joules += dt * self.power.power(self.state, self.freq)
        self.since = now


class EnergyMeter:
    """Integrates per-core state durations; time source is supplied by the
    executor (virtual time in simulation, ``time.perf_counter`` live).

    Cores may carry individual power models and a DVFS frequency step
    (see :meth:`add_core` / :meth:`set_frequency`); cores added through
    the constructor use the meter-wide default model at full frequency.
    """

    def __init__(self, n_cores: int, power: PowerModel | None = None,
                 t0: float = 0.0) -> None:
        self.power_model = power or PowerModel()
        self._cores = {i: _CoreTimeline(CoreState.SPIN, t0,
                                        power=self.power_model)
                       for i in range(n_cores)}
        self._t0 = t0
        self._t_end: float | None = None
        # Power-cap accounting is lazy: nothing below is touched (and
        # the hot set_state path pays one falsy attribute check) until
        # the first set_power_cap() call.
        self._cap: float | None = None
        self._cap_track = False
        self._watts = 0.0
        self._cap_since = 0.0
        self._cap_violation_s = 0.0

    def add_core(self, core_id: int, state: CoreState, now: float,
                 power: PowerModel | None = None,
                 core_type: str = "") -> None:
        tl = self._cores.get(core_id)
        if tl is not None:
            # Re-registration (e.g. the same CPU borrowed again): keep
            # the accumulated history — overwriting the timeline used to
            # erase the earlier borrow window's energy.  The DVFS step
            # resets to full; the owner re-applies its current plan.
            if self._cap_track:
                self._cap_tick(now)
                self._watts -= tl.power.power(tl.state, tl.freq)
            tl.close_segment(now)
            tl.state = state
            tl.freq = 1.0
            if power is not None:
                tl.power = power
            if core_type:
                tl.core_type = core_type
            if self._cap_track:
                self._watts += tl.power.power(state, 1.0)
            return
        self._cores[core_id] = _CoreTimeline(
            state, now, power=power or self.power_model,
            core_type=core_type)
        if self._cap_track:
            self._cap_tick(now)
            self._watts += self._cores[core_id].power.power(state, 1.0)

    def set_state(self, core_id: int, state: CoreState, now: float) -> None:
        """Transition a core; identical-state calls coalesce (the open
        segment keeps integrating as one (core, state) run — state
        churn that lands back on the same state costs nothing).

        ``close_segment`` is inlined: this runs twice per simulated
        task."""
        tl = self._cores[core_id]
        prev = tl.state
        if prev is state:
            return
        dt = now - tl.since
        if dt > 0.0:
            tl.accum[prev.idx] += dt
            tl.joules += dt * tl.power.power(prev, tl.freq)
        tl.since = now
        if prev is CoreState.IDLE and (state is CoreState.ACTIVE
                                       or state is CoreState.SPIN):
            tl.resumes += 1
        tl.state = state
        if self._cap_track:
            self._cap_tick(now)
            self._watts += (tl.power.power(state, tl.freq)
                            - tl.power.power(prev, tl.freq))

    def set_frequency(self, core_id: int, freq: float, now: float) -> None:
        """Re-clock a core: the open segment is accounted at the old step."""
        tl = self._cores[core_id]
        if tl.freq == freq:
            return
        if self._cap_track:
            self._cap_tick(now)
            self._watts -= tl.power.power(tl.state, tl.freq)
        tl.close_segment(now)
        tl.freq = freq
        if self._cap_track:
            self._watts += tl.power.power(tl.state, freq)

    def frequency_of(self, core_id: int) -> float:
        return self._cores[core_id].freq

    def core_ids(self) -> list[int]:
        return list(self._cores)

    # -- power-cap accounting --------------------------------------------

    def _cap_tick(self, now: float) -> None:
        """Close the open constant-draw interval; accumulate violation
        seconds if the draw exceeded the active cap."""
        dt = now - self._cap_since
        if dt > 0.0:
            if self._cap is not None and self._watts > self._cap + 1e-12:
                self._cap_violation_s += dt
            self._cap_since = now

    def set_power_cap(self, now: float, watts: float | None) -> None:
        """Install (or lift, with ``None``) a machine-wide power cap.

        The meter does not *enforce* the cap — policies do, by parking
        cores or lowering frequencies — it *measures* compliance: every
        second the aggregate draw sits above the cap is charged to
        :attr:`cap_violation_s`.  Tracking starts lazily at the first
        call so cap-free runs pay nothing.
        """
        if not self._cap_track:
            self._cap_track = True
            self._watts = sum(tl.power.power(tl.state, tl.freq)
                              for tl in self._cores.values())
            self._cap_since = now
        else:
            self._cap_tick(now)
        self._cap = watts

    @property
    def power_cap_w(self) -> float | None:
        return self._cap

    @property
    def watts(self) -> float:
        """Current aggregate draw (only maintained once a cap was set)."""
        return self._watts

    @property
    def cap_violation_s(self) -> float:
        return self._cap_violation_s

    def finish(self, now: float) -> None:
        if self._cap_track:
            self._cap_tick(now)
        for tl in self._cores.values():
            tl.close_segment(now)
        self._t_end = now

    # -- reports ---------------------------------------------------------

    def state_seconds(self) -> dict[CoreState, float]:
        out = {s: 0.0 for s in CoreState}
        for tl in self._cores.values():
            for s in CoreState:
                out[s] += tl.accum[s.idx]
        return out

    def state_seconds_by_type(self) -> dict[str, dict[CoreState, float]]:
        """Per-core-type state seconds (empty for untyped/homogeneous
        meters — cores added without a ``core_type`` label)."""
        out: dict[str, dict[CoreState, float]] = {}
        for tl in self._cores.values():
            if not tl.core_type:
                continue
            acc = out.setdefault(tl.core_type,
                                 {s: 0.0 for s in CoreState})
            for s in CoreState:
                acc[s] += tl.accum[s.idx]
        return out

    def energy_by_type(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for tl in self._cores.values():
            if not tl.core_type:
                continue
            out[tl.core_type] = (out.get(tl.core_type, 0.0) + tl.joules
                                 + tl.power.resume_energy * tl.resumes)
        return out

    def energy(self) -> float:
        return sum(tl.joules + tl.power.resume_energy * tl.resumes
                   for tl in self._cores.values())

    def elapsed(self) -> float:
        if self._t_end is None:
            raise RuntimeError("EnergyMeter.finish() not called")
        return self._t_end - self._t0

    def edp(self) -> float:
        return self.energy() * self.elapsed()

    def resumes(self) -> int:
        return sum(tl.resumes for tl in self._cores.values())
