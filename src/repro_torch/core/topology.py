"""Heterogeneous-core topology — pure data shared by every layer.

Modern parts are asymmetric: P/E hybrids (Alder-Lake-style), big.LITTLE,
multi-socket machines with independent DVFS domains.  The paper's
predictor picks how *many* cores a phase needs; on such silicon the
energy-optimal answer is how many cores *of which type at which
frequency* (cf. Costero et al., arXiv:2402.06319, and the Myrmics
heterogeneous-manycore scheduler, arXiv:1606.04282).

:class:`CoreType` describes one class of cores (count, relative speed,
per-state power, available DVFS frequency steps); :class:`CoreTopology`
is an ordered tuple of core types with positional core→type mapping
(cores of the first type occupy indices ``[0, count)``, and so on).
Both are frozen plain data with dict round-trips, so a
:class:`~repro.core.governor.GovernorSpec` can carry one and the
:class:`~repro.runtime.machine.MachineModel` presets can embed them.

A topology with a single :class:`CoreType` at speed 1.0 and one
frequency step *is* today's homogeneous machine — every hetero-aware
code path reduces to the existing behaviour by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

from .energy import PowerModel

__all__ = ["CoreType", "CoreTopology"]


@dataclass(frozen=True)
class CoreType:
    """One class of cores in an asymmetric machine."""

    name: str
    count: int
    #: task-speed multiplier relative to the machine's reference core
    #: (the MachineModel's ``core_speed`` scales all types uniformly)
    speed: float = 1.0
    #: per-state power for this type; None ⇒ the stack's default model
    power: PowerModel | None = None
    #: available DVFS steps as fractions of the base frequency, ascending;
    #: ``(1.0,)`` means the type cannot be re-clocked
    freq_steps: tuple[float, ...] = (1.0,)
    #: socket / NUMA domain this type's cores live on — the middle tier
    #: of the core → socket → node locality hierarchy.  Serialized only
    #: when nonzero so pre-hierarchy spec dicts round-trip unchanged.
    socket: int = 0

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.speed <= 0:
            raise ValueError(f"speed must be > 0, got {self.speed}")
        if self.socket < 0:
            raise ValueError(f"socket must be >= 0, got {self.socket}")
        if not self.freq_steps:
            raise ValueError("freq_steps must not be empty")
        steps = tuple(float(q) for q in self.freq_steps)
        if any(q <= 0 or q > 1.0 for q in steps):
            raise ValueError(
                f"freq_steps must be in (0, 1], got {steps}")
        if list(steps) != sorted(steps):
            raise ValueError(f"freq_steps must be ascending, got {steps}")
        object.__setattr__(self, "freq_steps", steps)

    @property
    def max_freq(self) -> float:
        return self.freq_steps[-1]

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name, "count": self.count,
                             "speed": self.speed,
                             "freq_steps": list(self.freq_steps)}
        if self.socket != 0:
            d["socket"] = self.socket
        if self.power is not None:
            d["power"] = {"active": self.power.active,
                          "spin": self.power.spin,
                          "idle": self.power.idle,
                          "off": self.power.off,
                          "resume_energy": self.power.resume_energy}
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CoreType":
        d = dict(d)
        if isinstance(d.get("power"), Mapping):
            d["power"] = PowerModel(**d["power"])
        if "freq_steps" in d:
            d["freq_steps"] = tuple(d["freq_steps"])
        return cls(**d)


@dataclass(frozen=True)
class CoreTopology:
    """Ordered core types + positional core-index → type mapping."""

    types: tuple[CoreType, ...]
    _offsets: tuple[int, ...] = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not self.types:
            raise ValueError("topology needs at least one core type")
        types = tuple(self.types)
        names = [t.name for t in types]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate core-type names: {names}")
        offsets = []
        base = 0
        for t in types:
            offsets.append(base)
            base += t.count
        object.__setattr__(self, "types", types)
        object.__setattr__(self, "_offsets", tuple(offsets))

    @classmethod
    def homogeneous(cls, n_cores: int, name: str = "core",
                    speed: float = 1.0) -> "CoreTopology":
        """The single-type topology equivalent to today's flat machine."""
        return cls(types=(CoreType(name=name, count=n_cores, speed=speed),))

    # -- introspection -----------------------------------------------------

    @property
    def n_cores(self) -> int:
        return self._offsets[-1] + self.types[-1].count

    @property
    def is_homogeneous(self) -> bool:
        return len(self.types) == 1

    def type_names(self) -> list[str]:
        return [t.name for t in self.types]

    def by_name(self, name: str) -> CoreType:
        for t in self.types:
            if t.name == name:
                return t
        raise KeyError(name)

    def core_type_at(self, index: int) -> CoreType:
        """Core type of local core ``index`` (positional assignment)."""
        i = index % self.n_cores   # global simulator ids wrap per machine
        for off, t in zip(reversed(self._offsets), reversed(self.types)):
            if i >= off:
                return t
        raise IndexError(index)  # pragma: no cover - unreachable

    def type_of(self, index: int) -> str:
        return self.core_type_at(index).name

    def speed_of(self, index: int) -> float:
        return self.core_type_at(index).speed

    def socket_of(self, index: int) -> int:
        """Socket/NUMA domain of local core ``index`` (wraps like
        :meth:`core_type_at`); every core maps to exactly one socket."""
        return self.core_type_at(index).socket

    @property
    def n_sockets(self) -> int:
        return len({t.socket for t in self.types})

    def fastest_first(self) -> list[CoreType]:
        """Types ordered fastest→slowest (Δ_c fills fastest cores
        first); at equal speed, lower socket ids first — the planner
        fills an app's primary socket before spilling to a remote one.
        Single-socket topologies keep declaration order (the sort is
        stable and every key ties)."""
        return sorted(self.types, key=lambda t: (-t.speed, t.socket))

    def mean_speed(self) -> float:
        return (sum(t.count * t.speed for t in self.types)
                / self.n_cores)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {"types": [t.to_dict() for t in self.types]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CoreTopology":
        return cls(types=tuple(CoreType.from_dict(t) for t in d["types"]))
