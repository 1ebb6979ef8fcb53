"""Dynamic machine conditions: power caps, faults, thermal throttling.

Every layer of the runtime historically assumed a static, failure-free,
power-unconstrained machine.  This module is the single source of truth
for *perturbed* machines:

``Perturbation``
    One timestamped change to the machine — a power cap, a core
    failing or recovering, a core type being thermally throttled, or a
    core turning into a straggler.

``ConditionTimeline``
    An immutable, time-sorted schedule of perturbations.  Like
    :mod:`repro.workloads.arrivals` it is seeded and wall-clock-free:
    the random scenario constructors build a fresh
    ``random.Random(seed)`` on every call, so the same seed always
    yields the same timeline.

``MachineConditions``
    The live view the runtime consults while executing: which cores are
    currently failed, the thermal frequency cap per core type, the
    per-core straggler slowdown, and the active power cap.  The sim
    applies each perturbation exactly once (heap-ordered) by calling
    :meth:`MachineConditions.apply`.

The empty timeline is the degenerate case: no layer changes behaviour
when no conditions object is installed, so unperturbed runs stay
byte-identical to the pre-conditions code.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from enum import Enum
from typing import Iterable, Iterator


class PerturbationKind(Enum):
    """What changed about the machine."""

    POWER_CAP = "power_cap"          # machine-wide power budget (watts)
    CORE_FAIL = "core_fail"          # core drops dead
    CORE_RECOVER = "core_recover"    # failed core comes back
    THERMAL_THROTTLE = "thermal_throttle"  # core type capped at freq
    STRAGGLER = "straggler"          # core silently slows down


@dataclass(frozen=True, slots=True)
class Perturbation:
    """One timestamped machine-condition change.

    Only the fields relevant to ``kind`` are meaningful; the rest stay
    at their defaults (and are omitted from :meth:`to_dict`).
    """

    time: float
    kind: PerturbationKind
    core: int | None = None          # CORE_FAIL / CORE_RECOVER / STRAGGLER
    core_type: str | None = None     # THERMAL_THROTTLE
    watts: float | None = None       # POWER_CAP (None lifts the cap)
    freq: float | None = None        # THERMAL_THROTTLE cap (None lifts)
    slowdown: float | None = None    # STRAGGLER multiplier (None cures;
    #                                  1.0 keeps the suspect marker with
    #                                  no dilation — the replay case)

    def to_dict(self) -> dict:
        d: dict = {"time": self.time, "kind": self.kind.value}
        if self.core is not None:
            d["core"] = self.core
        if self.core_type is not None:
            d["core_type"] = self.core_type
        if self.watts is not None:
            d["watts"] = self.watts
        if self.freq is not None:
            d["freq"] = self.freq
        if self.slowdown is not None:
            d["slowdown"] = self.slowdown
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Perturbation":
        return cls(
            time=float(d["time"]),
            kind=PerturbationKind(d["kind"]),
            core=d.get("core"),
            core_type=d.get("core_type"),
            watts=d.get("watts"),
            freq=d.get("freq"),
            slowdown=d.get("slowdown"),
        )


def power_cap(time: float, watts: float | None) -> Perturbation:
    return Perturbation(time, PerturbationKind.POWER_CAP, watts=watts)


def core_fail(time: float, core: int) -> Perturbation:
    return Perturbation(time, PerturbationKind.CORE_FAIL, core=core)


def core_recover(time: float, core: int) -> Perturbation:
    return Perturbation(time, PerturbationKind.CORE_RECOVER, core=core)


def thermal_throttle(time: float, core_type: str,
                     freq: float | None) -> Perturbation:
    return Perturbation(time, PerturbationKind.THERMAL_THROTTLE,
                        core_type=core_type, freq=freq)


def straggler(time: float, core: int, slowdown: float) -> Perturbation:
    if slowdown < 1.0:
        raise ValueError(f"straggler slowdown must be >= 1.0: {slowdown}")
    return Perturbation(time, PerturbationKind.STRAGGLER, core=core,
                        slowdown=slowdown)


class ConditionTimeline:
    """A time-sorted, immutable schedule of :class:`Perturbation`s.

    Construction sorts by ``(time, insertion order)`` so simultaneous
    perturbations apply in the order they were listed — deterministic
    regardless of the caller's container type.
    """

    def __init__(self, perturbations: Iterable[Perturbation] = ()):
        events = list(perturbations)
        for p in events:
            if p.time < 0.0:
                raise ValueError(f"perturbation time must be >= 0: {p}")
        order = {id(p): i for i, p in enumerate(events)}
        events.sort(key=lambda p: (p.time, order[id(p)]))
        self._events: tuple[Perturbation, ...] = tuple(events)

    def __iter__(self) -> Iterator[Perturbation]:
        return iter(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def __bool__(self) -> bool:
        return bool(self._events)

    @property
    def events(self) -> tuple[Perturbation, ...]:
        return self._events

    def to_dicts(self) -> list[dict]:
        return [p.to_dict() for p in self._events]

    @classmethod
    def from_dicts(cls, rows: Iterable[dict]) -> "ConditionTimeline":
        return cls(Perturbation.from_dict(r) for r in rows)

    def neutralized(self) -> "ConditionTimeline":
        """Timeline for *replay* on a neutral machine.

        Replayed graphs carry the originally *observed* task durations,
        so speed-changing perturbations must not dilate them a second
        time: STRAGGLER keeps its suspect marker but with slowdown 1.0,
        and THERMAL_THROTTLE lifts to full frequency.  Structural
        perturbations (POWER_CAP, CORE_FAIL, CORE_RECOVER) are kept
        verbatim — they drive scheduling decisions, not durations.
        """
        out = []
        for p in self._events:
            if p.kind is PerturbationKind.STRAGGLER:
                out.append(Perturbation(p.time, p.kind, core=p.core,
                                        slowdown=1.0))
            elif p.kind is PerturbationKind.THERMAL_THROTTLE:
                out.append(Perturbation(p.time, p.kind,
                                        core_type=p.core_type, freq=1.0))
            else:
                out.append(p)
        return ConditionTimeline(out)

    # ---- seeded scenario constructors (arrivals.py discipline) ----

    @classmethod
    def random_faults(cls, *, n_cores: int, horizon: float,
                      n_faults: int = 2, mttr: float | None = None,
                      seed: int = 0) -> "ConditionTimeline":
        """``n_faults`` random fail(+recover) pairs inside ``horizon``.

        A fresh ``random.Random(seed)`` is built per call — no hidden
        state, no wall clock.  When ``mttr`` is given each failed core
        recovers after an exponential repair time (clamped inside the
        horizon); otherwise failures are permanent.
        """
        rng = random.Random(seed)
        events: list[Perturbation] = []
        cores = list(range(n_cores))
        for _ in range(n_faults):
            if not cores:
                break
            core = cores.pop(rng.randrange(len(cores)))
            t = rng.uniform(0.0, horizon)
            events.append(core_fail(t, core))
            if mttr is not None:
                dt = rng.expovariate(1.0 / mttr)
                t_rec = t + dt
                if t_rec < horizon:
                    events.append(core_recover(t_rec, core))
        return cls(events)

    @classmethod
    def random_stragglers(cls, *, n_cores: int, horizon: float,
                          n_stragglers: int = 1,
                          slowdown_range: tuple[float, float] = (2.0, 8.0),
                          seed: int = 0) -> "ConditionTimeline":
        """Random cores turn into stragglers at random times."""
        rng = random.Random(seed)
        events: list[Perturbation] = []
        cores = list(range(n_cores))
        lo, hi = slowdown_range
        for _ in range(n_stragglers):
            if not cores:
                break
            core = cores.pop(rng.randrange(len(cores)))
            events.append(straggler(rng.uniform(0.0, horizon), core,
                                    rng.uniform(lo, hi)))
        return cls(events)


class MachineConditions:
    """Live view of the machine's current condition.

    The sim owns one of these per run and calls :meth:`apply` for each
    scheduled perturbation; every other layer only *reads* it.  All
    collections are dicts (never sets) so iteration order is the
    deterministic insertion order.
    """

    def __init__(self, timeline: ConditionTimeline | None = None):
        self.timeline = timeline if timeline is not None \
            else ConditionTimeline()
        self._failed: dict[int, bool] = {}
        self._thermal_caps: dict[str, float] = {}
        self._slowdowns: dict[int, float] = {}
        self.power_cap_w: float | None = None

    # ---- mutation (sim-only) ----

    def apply(self, p: Perturbation) -> None:
        k = p.kind
        if k is PerturbationKind.POWER_CAP:
            self.power_cap_w = p.watts
        elif k is PerturbationKind.CORE_FAIL:
            self._failed[p.core] = True
        elif k is PerturbationKind.CORE_RECOVER:
            self._failed.pop(p.core, None)
        elif k is PerturbationKind.THERMAL_THROTTLE:
            if p.freq is None or p.freq >= 1.0:
                self._thermal_caps.pop(p.core_type, None)
            else:
                self._thermal_caps[p.core_type] = p.freq
        elif k is PerturbationKind.STRAGGLER:
            if p.slowdown is None:
                self._slowdowns.pop(p.core, None)
            else:
                self._slowdowns[p.core] = p.slowdown

    # ---- queries (any layer) ----

    def is_failed(self, core: int) -> bool:
        return core in self._failed

    def failed_cores(self) -> list[int]:
        return list(self._failed)

    def thermal_cap(self, core_type: str) -> float:
        """Frequency ceiling for ``core_type`` (1.0 when unthrottled)."""
        return self._thermal_caps.get(core_type, 1.0)

    def thermal_caps(self) -> dict[str, float]:
        return dict(self._thermal_caps)

    def slowdown_of(self, core: int) -> float:
        """Execution-time multiplier for ``core`` (1.0 when healthy)."""
        return self._slowdowns.get(core, 1.0)

    def is_suspect(self, core: int) -> bool:
        """True when ``core``'s observed timings should not feed the
        monitor's frequency-normalized cost model (straggling cores
        lie about the workload; throttled cores are already corrected
        via the frequency term)."""
        return core in self._slowdowns

    @property
    def any_active(self) -> bool:
        return bool(self._failed or self._thermal_caps
                    or self._slowdowns or self.power_cap_w is not None)
