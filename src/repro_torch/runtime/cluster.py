"""Multi-node cluster model — the top tier of the locality hierarchy.

The locality hierarchy is core → socket/NUMA domain → node:

* cores and sockets live inside one :class:`~repro.runtime.machine
  .MachineModel` (``CoreType.socket`` + ``remote_socket_penalty``);
* :class:`ClusterModel` composes N machines into one address space of
  global core ids with a **distance matrix** between nodes.

Distance drives two costs, mirroring how Myrmics (arXiv:1606.04282) and
the distributed-manager OmpSs runtime charge hierarchy crossings:

* ``penalty(home, node)`` — service-time dilation for an app executing
  on a core *remote from its home node* (``1 + remote_penalty · d``):
  borrowed remote silicon is slower for you than for its owner;
* ``transfer_time(src, dst)`` — inter-node network transfer charged
  when a task's predecessors completed on another node
  (``transfer_latency · d``); the simulator emits a ``TRANSFER`` event
  and delays the task start, but the transfer is *not* part of the
  task's measured ``elapsed`` (it is wire time, not compute time).

Global core ids are contiguous per node: node ``k`` owns
``[base_of(k), base_of(k) + nodes[k].n_cores)``.  A flat
:class:`MachineModel` is exactly :meth:`ClusterModel.single` — one
node, zero distances — and every simulator/broker/arbiter code path
reduces to the pre-cluster behaviour on it by construction (pinned
byte-identical in ``tests/test_cluster.py``).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field, replace
from typing import Any, Mapping

from .machine import MachineModel

__all__ = ["ClusterModel"]


@dataclass(frozen=True)
class ClusterModel:
    """N machines + a symmetric inter-node distance matrix."""

    nodes: tuple[MachineModel, ...]
    #: symmetric, zero-diagonal, non-negative; None ⇒ unit distance
    #: between every pair of distinct nodes
    distance: tuple[tuple[float, ...], ...] | None = None
    #: seconds of network transfer per unit distance, charged when a
    #: task's predecessors completed on another node (0 disables)
    transfer_latency: float = 20e-6
    #: service-time dilation per unit distance for an app running on a
    #: core remote from its home node: factor = 1 + remote_penalty · d
    remote_penalty: float = 0.15
    #: per-core cost of an explicit whole-app migration verb
    migration_latency: float = 200e-6
    name: str = "cluster"
    _bases: tuple[int, ...] = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not self.nodes:
            raise ValueError("cluster needs at least one node")
        nodes = tuple(self.nodes)
        n = len(nodes)
        dist = self.distance
        if dist is None:
            dist = tuple(tuple(0.0 if i == j else 1.0 for j in range(n))
                         for i in range(n))
        else:
            dist = tuple(tuple(float(x) for x in row) for row in dist)
            if len(dist) != n or any(len(row) != n for row in dist):
                raise ValueError(
                    f"distance matrix must be {n}x{n} for {n} node(s)")
            for i in range(n):
                if dist[i][i] != 0.0:
                    raise ValueError(
                        f"distance[{i}][{i}] must be 0, got {dist[i][i]}")
                for j in range(n):
                    if dist[i][j] < 0:
                        raise ValueError(
                            f"distance[{i}][{j}] must be >= 0")
                    if dist[i][j] != dist[j][i]:
                        raise ValueError(
                            f"distance matrix must be symmetric: "
                            f"[{i}][{j}]={dist[i][j]} != "
                            f"[{j}][{i}]={dist[j][i]}")
        if self.transfer_latency < 0:
            raise ValueError("transfer_latency must be >= 0")
        if self.remote_penalty < 0:
            raise ValueError("remote_penalty must be >= 0")
        if self.migration_latency < 0:
            raise ValueError("migration_latency must be >= 0")
        bases = []
        base = 0
        for m in nodes:
            bases.append(base)
            base += m.n_cores
        object.__setattr__(self, "nodes", nodes)
        object.__setattr__(self, "distance", dist)
        object.__setattr__(self, "_bases", tuple(bases))

    # -- construction helpers ----------------------------------------------

    @classmethod
    def single(cls, machine: MachineModel) -> "ClusterModel":
        """The trivial 1-node cluster ≡ the flat machine (the simulator
        reproduces the flat path byte-for-byte on it)."""
        return cls(nodes=(machine,), name=machine.name)

    @classmethod
    def symmetric(cls, machine: MachineModel, n_nodes: int,
                  **kwargs: Any) -> "ClusterModel":
        """``n_nodes`` identical machines at unit pairwise distance."""
        return cls(nodes=(machine,) * n_nodes,
                   name=kwargs.pop("name", f"{machine.name}x{n_nodes}"),
                   **kwargs)

    def replay_model(self) -> "ClusterModel":
        """A cluster for byte-exact sim→sim trace replay: node machines
        are neutralized (recorded durations already include core speed,
        monitoring overhead AND locality penalties, so none may be
        re-charged) while distances/transfer latencies are kept — the
        replayed run re-derives identical cross-node ``TRANSFER``
        delays from identical dispatch decisions."""
        from ..trace.replay import TraceReplayer

        return replace(
            self, remote_penalty=0.0,
            nodes=tuple(
                replace(TraceReplayer.replay_machine(m),
                        remote_socket_penalty=1.0)
                for m in self.nodes))

    # -- the global-id address space ----------------------------------------

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_cores(self) -> int:
        return self._bases[-1] + self.nodes[-1].n_cores

    def base_of(self, node: int) -> int:
        return self._bases[node]

    def cores_of(self, node: int) -> range:
        """Global core ids owned by ``node``."""
        base = self._bases[node]
        return range(base, base + self.nodes[node].n_cores)

    def node_of(self, core: int) -> int:
        """Node owning global core id ``core`` — every core maps to
        exactly one node."""
        if not 0 <= core < self.n_cores:
            raise IndexError(f"global core id {core} out of range "
                             f"[0, {self.n_cores})")
        return bisect_right(self._bases, core) - 1

    def local_id(self, core: int) -> int:
        return core - self._bases[self.node_of(core)]

    def machine_of(self, core: int) -> MachineModel:
        return self.nodes[self.node_of(core)]

    def socket_of(self, core: int) -> int:
        """Socket of global core id ``core`` within its node."""
        node = self.node_of(core)
        return self.nodes[node].topology().socket_of(
            core - self._bases[node])

    def type_of(self, core: int) -> str:
        """Core-type name of global core id ``core`` (the broker's
        per-type pool accounting on mixed-node clusters)."""
        node = self.node_of(core)
        return self.nodes[node].topology().type_of(
            core - self._bases[node])

    def speed_of(self, core: int) -> float:
        """Absolute speed of global core id ``core`` on its own node
        (before any remote penalty)."""
        node = self.node_of(core)
        return self.nodes[node].speed_of(core - self._bases[node])

    # -- locality costs ------------------------------------------------------

    def penalty(self, home: int, node: int) -> float:
        """Service-time factor for a home-``home`` app executing on a
        ``node`` core (1.0 at home)."""
        return 1.0 + self.remote_penalty * self.distance[home][node]

    def transfer_time(self, src: int, dst: int) -> float:
        """Network delay for a dependency edge crossing src → dst."""
        return self.transfer_latency * self.distance[src][dst]

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "nodes": [m.to_dict() for m in self.nodes],
            "distance": [list(row) for row in self.distance],
            "transfer_latency": self.transfer_latency,
            "remote_penalty": self.remote_penalty,
            "migration_latency": self.migration_latency,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClusterModel":
        d = dict(d)
        d["nodes"] = tuple(MachineModel.from_dict(m) for m in d["nodes"])
        if d.get("distance") is not None:
            d["distance"] = tuple(tuple(row) for row in d["distance"])
        return cls(**d)
