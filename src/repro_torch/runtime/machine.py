"""Machine models for the discrete-event simulator.

The paper evaluates on two systems (Table 1): MN4 (2×24-core Skylake,
2.10 GHz) and KNL (64-core Knights Landing, 1.30 GHz).  This container has
one physical core, so the policy dynamics are reproduced in *virtual time*
with these models.  ``core_speed`` rescales task service times (KNL cores
are slower per-core: lower frequency, narrower OoO core — we use the
frequency ratio 1.30/2.10 ≈ 0.62 as the first-order factor).

Heterogeneous machines are described by ``core_types`` — an ordered
tuple of :class:`~repro.core.topology.CoreType` (count, relative speed,
per-state power, DVFS steps).  Cores are numbered positionally: the
first type owns indices ``[0, count)``, and so on.  Two asymmetric
presets ship alongside the paper's homogeneous machines:

* :data:`HYBRID_PE` — an Alder-Lake-style hybrid: 8 fast P-cores plus
  16 slower, lower-power E-cores (big.LITTLE economics);
* :data:`DVFS2` — a 2-socket symmetric machine whose sockets can be
  independently re-clocked to 75% / 87.5% / 100% of base frequency.

``resume_latency`` is the idle→running wakeup cost (futex wake + context
switch, O(µs)) that makes *idle* policies expensive for fine-grained tasks;
``poll_interval`` is the virtual duration of one empty scheduler poll
(subscription-lock acquire + queue check); ``monitor_event_overhead`` is
charged per monitoring event when the monitoring infrastructure is enabled
(the paper measures ≤3 % total — see ``benchmarks/bench_overhead.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

from ..core.energy import PowerModel
from ..core.topology import CoreTopology, CoreType

__all__ = ["MachineModel", "MN4", "KNL", "HYBRID_PE", "DVFS2"]


@dataclass(frozen=True)
class MachineModel:
    name: str
    n_cores: int
    core_speed: float = 1.0          # task speed relative to an MN4 core
    resume_latency: float = 5e-6     # idle→running (futex + switch)
    poll_interval: float = 5e-7      # one empty poll
    borrow_latency: float = 2e-6     # DLB CPU hand-over
    dlb_call_overhead: float = 1e-6  # one DLB library call (paper §3.3:
    #                                  "such calls do not come for free")
    monitor_event_overhead: float = 5e-8  # per monitoring event
    #: asymmetric core description; None ⇒ homogeneous (all cores equal)
    core_types: tuple[CoreType, ...] | None = None
    #: service-time dilation for a task whose predecessors completed on
    #: a *different socket* of this machine (remote-NUMA access on the
    #: data it consumes).  1.0 (default) = no penalty — single-socket
    #: machines and every pre-hierarchy model are unaffected; only
    #: multi-socket topologies (``CoreType.socket``) can trigger it.
    remote_socket_penalty: float = 1.0

    def __post_init__(self) -> None:
        if self.remote_socket_penalty < 1.0:
            raise ValueError(
                f"remote_socket_penalty must be >= 1.0, "
                f"got {self.remote_socket_penalty}")
        if self.core_types is not None:
            total = sum(t.count for t in self.core_types)
            if total != self.n_cores:
                raise ValueError(
                    f"core_types counts sum to {total}, "
                    f"but n_cores is {self.n_cores}")
        # Cache the topology once: service_time() sits on the simulator's
        # per-task hot path and must not rebuild/re-validate it.
        topo = (CoreTopology(types=self.core_types)
                if self.core_types is not None
                else CoreTopology.homogeneous(self.n_cores))
        object.__setattr__(self, "_topology", topo)

    def topology(self) -> CoreTopology:
        """The machine's :class:`CoreTopology` (synthesized single-type
        for homogeneous machines — hetero-aware code needs no branch)."""
        return self._topology

    def speed_of(self, core: int | None = None) -> float:
        """Absolute speed of ``core`` (global simulator ids wrap per
        machine); None ⇒ the machine's reference speed."""
        if core is None or self.core_types is None:
            return self.core_speed
        return self.core_speed * self._topology.speed_of(core)

    def service_time(self, base: float, core: int | None = None,
                     freq: float = 1.0) -> float:
        """Wall seconds for ``base`` reference-seconds of work on
        ``core`` at DVFS step ``freq``.

        Contract: ``freq`` is validated against the core type's DVFS
        steps instead of silently extrapolating.  Above the type's top
        step it clamps to ``max_freq`` (requesting a frequency the
        silicon lacks runs at the fastest it has); nonpositive values
        clamp to the *lowest* step (a frequency of zero would stall the
        task forever).  Frequencies inside ``(0, max_freq]`` are
        honored bit-identically even when they sit between or below the
        published steps — thermal throttling legitimately pins a core
        under its slowest nominal step.
        """
        if freq > 1.0 or freq <= 0.0:
            # Every CoreType validates its steps inside (0, 1], so
            # in-band requests (the overwhelmingly common case) skip
            # the typed lookup entirely.
            ct = self._topology.core_type_at(core if core is not None
                                            else 0)
            freq = ct.max_freq if freq > 1.0 else ct.freq_steps[0]
        elif freq != 1.0 and core is not None \
                and self.core_types is not None:
            mf = self._topology.core_type_at(core).max_freq
            if freq > mf:
                freq = mf
        return base / (self.speed_of(core) * freq)

    # -- serialization (ClusterModel round-trip) ----------------------------

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name, "n_cores": self.n_cores,
            "core_speed": self.core_speed,
            "resume_latency": self.resume_latency,
            "poll_interval": self.poll_interval,
            "borrow_latency": self.borrow_latency,
            "dlb_call_overhead": self.dlb_call_overhead,
            "monitor_event_overhead": self.monitor_event_overhead,
        }
        if self.core_types is not None:
            d["core_types"] = [t.to_dict() for t in self.core_types]
        if self.remote_socket_penalty != 1.0:
            d["remote_socket_penalty"] = self.remote_socket_penalty
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MachineModel":
        d = dict(d)
        if d.get("core_types") is not None:
            d["core_types"] = tuple(CoreType.from_dict(t)
                                    for t in d["core_types"])
        return cls(**d)


MN4 = MachineModel(name="MN4", n_cores=48, core_speed=1.0)
KNL = MachineModel(name="KNL", n_cores=64, core_speed=0.62)

#: P+E hybrid: 8 performance cores + 16 efficiency cores at ~55% speed
#: and ~40% power — the asymmetric-silicon scenario the homogeneous
#: ``core_speed`` scalar cannot express.
HYBRID_PE = MachineModel(
    name="HYBRID-PE", n_cores=24,
    core_types=(
        CoreType(name="P", count=8, speed=1.0),
        CoreType(name="E", count=16, speed=0.55,
                 power=PowerModel(active=0.4, spin=0.4, idle=0.05)),
    ))

#: Two symmetric sockets with independent DVFS domains (steps as
#: fractions of base frequency) — the frequency-aware predictor may
#: stretch a lightly-loaded socket to a lower step to cut EDP.
DVFS2 = MachineModel(
    name="DVFS2", n_cores=48,
    core_types=(
        CoreType(name="S0", count=24, freq_steps=(0.75, 0.875, 1.0),
                 socket=0),
        CoreType(name="S1", count=24, freq_steps=(0.75, 0.875, 1.0),
                 socket=1),
    ))
