"""Unified runtime event bus.

Every frontend used to hard-wire its observability: the
:class:`~repro.runtime.scheduler.Scheduler` called the
:class:`~repro.core.monitoring.TaskMonitor` directly, worker-state
transitions were visible only through counters, and predictions left no
record at all.  This module decouples producers from consumers with a
small structured pub/sub:

* producers (``Scheduler``, ``WorkerManager``, ``ResourceGovernor``,
  ``ServingEngine``, ``SimCluster``) publish :class:`RuntimeEvent`\\ s into
  an :class:`EventBus`;
* consumers subscribe — the :class:`TaskMonitor` is now *one subscriber*
  (see :meth:`TaskMonitor.subscribe`), and the
  :class:`~repro.trace.TraceRecorder` is another, which is what makes
  trace record/replay work identically on every frontend.

Events are plain data (:meth:`RuntimeEvent.to_dict` /
:meth:`RuntimeEvent.from_dict` round-trip through JSON), timestamps come
from whatever clock the producer runs on (virtual time in the simulator,
``perf_counter`` live), and publishing with no subscribers is a cheap
no-op so closed-loop hot paths pay nothing.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Mapping

from ..analysis import guarded_by

__all__ = ["EventKind", "RuntimeEvent", "EventBus", "QUIET_INTEREST"]

#: the :attr:`EventBus.interest` value of a bus nobody subscribed to —
#: producers compare against it to skip publish calls entirely on quiet
#: hot paths (one shared definition; an empty frozenset compares equal)
QUIET_INTEREST: frozenset = frozenset()


class EventKind(enum.Enum):
    #: task registered with a scheduler (data: deps, parent)
    TASK_SUBMITTED = "task_submitted"
    #: dependencies satisfied, task entered the ready queue
    TASK_READY = "task_ready"
    #: task popped by a worker (worker_id when the frontend knows it)
    TASK_EXECUTE = "task_execute"
    #: task finished (elapsed = measured seconds; data: parent)
    TASK_COMPLETED = "task_completed"
    #: open-workload arrival released a task into the runtime
    TASK_ARRIVED = "task_arrived"
    #: worker state transition (data: state, prev) — resumes, idles, lends
    WORKER_STATE = "worker_state"
    #: one Algorithm-1 tick (data: delta)
    PREDICTION = "prediction"
    #: inter-node network transfer on a cross-node dependency edge
    #: (multi-node clusters; data: src, dst, seconds)
    TRANSFER = "transfer"
    #: machine-condition change applied by the runtime (power cap,
    #: core fail/recover, thermal throttle, straggler onset); ``data``
    #: is the :meth:`~repro.core.conditions.Perturbation.to_dict`
    #: payload, so a recorded perturbed run carries its own timeline
    #: and replays byte-exactly
    PERTURBATION = "perturbation"
    #: request left the system without completing: refused by admission
    #: control, evicted from a full queue by a higher-priority arrival,
    #: or abandoned after its deadline/retry budget ran out
    #: (``data["reason"]`` ∈ {"queue", "deadline", "timeout"})
    SHED = "shed"
    #: a timed-out attempt was re-released after exponential backoff
    #: (``data``: try number, backoff seconds) or requeued uncharged
    #: after a capacity change tore it off its replica
    RETRY = "retry"
    #: a hedged duplicate attempt was issued for a tail request
    #: (``worker_id`` = the hedge replica; first completion wins)
    HEDGE = "hedge"
    #: graceful-degradation mode change: brownout engage/release under
    #: a power cap, or a circuit breaker quarantining / re-probing a
    #: replica (``data["mode"]``)
    DEGRADE = "degrade"


@dataclass(frozen=True, slots=True)
class RuntimeEvent:
    """One structured runtime event; immutable and JSON-serializable."""

    kind: EventKind
    time: float
    task_id: int | None = None
    type_name: str | None = None
    cost: float | None = None
    worker_id: int | None = None
    elapsed: float | None = None
    #: application namespace for multi-app traces (co-scheduled jobs
    #: share one machine but publish on per-app buses; the bus stamps
    #: this so a combined recording can be split back per app).  None on
    #: single-app frontends — the field round-trips through JSON only
    #: when set, so existing traces stay byte-identical.
    app: str | None = None
    #: per-stream monotonic sequence stamp for multi-threaded producers
    #: (one stream per publishing worker, plus one for the submit side).
    #: Appends from N worker threads interleave in recorder-lock order,
    #: not program order; the stamp lets
    #: :meth:`~repro.trace.TraceRecorder.merged_events` reconstruct the
    #: canonical per-stream order at flush time.  None on
    #: single-threaded frontends (the simulator) — like ``app``, the
    #: field round-trips through JSON only when set, so existing traces
    #: stay byte-identical.
    seq: int | None = None
    #: locality stamps for multi-node runs: the node the producing job
    #: lives on and the socket of ``worker_id`` (when the bus knows the
    #: topology).  Like ``app``/``seq`` they serialize only when set, so
    #: single-node traces stay byte-identical.
    node: int | None = None
    socket: int | None = None
    data: Mapping[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"kind": self.kind.value, "time": self.time}
        for k in ("task_id", "type_name", "cost", "worker_id", "elapsed",
                  "app", "seq", "node", "socket"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.data:
            d["data"] = dict(self.data)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RuntimeEvent":
        d = dict(d)
        d["kind"] = EventKind(d["kind"])
        return cls(**d)


@guarded_by("_subs", "interest")
class EventBus:
    """Thread-safe pub/sub for :class:`RuntimeEvent`.

    Subscribers are called synchronously, in subscription order, on the
    publisher's thread — handlers must be fast and must not call back
    into the publisher.  ``kinds`` filters at the bus so uninterested
    subscribers cost nothing per event.

    ``app`` names the application this bus belongs to: published events
    with no ``app`` of their own are stamped with it, which is what lets
    a recorder attached to several per-app buses produce one splittable
    multi-app trace.  ``node`` (the app's home node) and ``socket_of``
    (worker id → socket) stamp locality the same way on multi-node
    runs; both default to off so single-node traces are unchanged.
    """

    def __init__(self, app: str | None = None, node: int | None = None,
                 socket_of: Callable[[int], int] | None = None) -> None:
        self._lock = threading.Lock()
        self.app = app
        self.node = node
        self.socket_of = socket_of
        # Copy-on-write subscriber list: publish() iterates a snapshot
        # without holding the lock.
        self._subs: tuple[tuple[Callable[[RuntimeEvent], None],
                                frozenset[EventKind] | None], ...] = ()
        #: public read-only view of subscriber interest — the union of
        #: every subscriber's kind filter.  None ⇒ some subscriber wants
        #: all kinds; empty (== :data:`QUIET_INTEREST`) ⇒ nobody wants
        #: anything.  Recomputed on (un)subscribe so per-event pre-checks
        #: are one attribute load + set probe; producers read it directly
        #: on hot paths (scheduler, manager, governor).
        self.interest: frozenset[EventKind] | None = QUIET_INTEREST

    def _recompute_interest_locked(self) -> None:
        kinds: set[EventKind] = set()
        for _, ks in self._subs:
            if ks is None:
                self.interest = None
                return
            kinds |= ks
        self.interest = frozenset(kinds)

    def subscribe(self, handler: Callable[[RuntimeEvent], None],
                  kinds: Iterable[EventKind] | None = None,
                  ) -> Callable[[RuntimeEvent], None]:
        """Register ``handler`` (for ``kinds``, or all); returns it so the
        caller can later :meth:`unsubscribe` the same object.

        Subscribing a handler that is already registered (equality, not
        identity — bound methods compare equal by (function, instance))
        does NOT add a second entry: it updates the existing entry's kind
        filter.  Double delivery silently doubled every subscriber-side
        aggregate (e.g. TaskMonitor costs), and was asymmetric with
        :meth:`unsubscribe`.
        """
        ks = frozenset(kinds) if kinds is not None else None
        with self._lock:
            for i, (h, _) in enumerate(self._subs):
                if h == handler:
                    self._subs = (self._subs[:i] + ((handler, ks),)
                                  + self._subs[i + 1:])
                    self._recompute_interest_locked()
                    return handler
            self._subs = self._subs + ((handler, ks),)
            self._recompute_interest_locked()
        return handler

    def unsubscribe(self, handler: Callable[[RuntimeEvent], None]) -> None:
        # Equality, not identity: each access to a bound method (e.g.
        # ``monitor._on_event``) builds a fresh object, and bound methods
        # compare equal by (function, instance).  Removes exactly the one
        # matching entry — subscribe() guarantees there is at most one —
        # keeping the pair symmetric (one subscribe ⟺ one unsubscribe).
        with self._lock:
            for i, (h, _) in enumerate(self._subs):
                if h == handler:
                    self._subs = self._subs[:i] + self._subs[i + 1:]
                    self._recompute_interest_locked()
                    return

    @property
    def n_subscribers(self) -> int:
        return len(self._subs)

    def interested(self, kind: EventKind) -> bool:
        """True iff some subscriber would receive ``kind`` — the cheap
        pre-check that lets producers skip building event payloads on
        hot paths (a kind-filtered subscriber, e.g. the TaskMonitor,
        does not make the bus interested in other kinds).  One set
        lookup against the cached interest union — O(1) regardless of
        subscriber count."""
        interest = self.interest
        if interest is None:
            return True
        # `not interest` before the containment check: an empty frozenset
        # (subscriber-free bus — THE hot case) answers without hashing
        # the enum member (enum.__hash__ is a Python-level call).
        return bool(interest) and kind in interest

    def publish(self, event: RuntimeEvent) -> None:
        # Same pre-check publish-side: on a subscriber-free bus (or one
        # whose subscribers filter this kind out) this returns before the
        # app-stamping replace(), so publishing is a no-alloc no-op.
        interest = self.interest
        if interest is not None and (not interest
                                     or event.kind not in interest):
            return
        if self.app is not None and event.app is None:
            event = replace(event, app=self.app)
        if self.node is not None and event.node is None:
            event = replace(event, node=self.node)
        if (self.socket_of is not None and event.socket is None
                and event.worker_id is not None):
            event = replace(event, socket=self.socket_of(event.worker_id))
        for handler, kinds in self._subs:
            if kinds is None or event.kind in kinds:
                handler(event)
