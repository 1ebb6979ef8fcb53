"""Trace replay: recorded events → task graph + arrival timeline → sim.

A trace records *what actually happened*: which tasks existed (type,
cost, dependency ids, parent links), when each was released into the
runtime, and how long each really took.  :class:`TraceReplayer` rebuilds
that as a fresh :class:`~repro.runtime.task.TaskGraph` whose
``service_time`` is the measured duration and whose ``release_time`` is
the recorded arrival timeline — so a workload recorded once (on the
threaded executor, the serving engine, or the simulator itself) replays
deterministically in the simulator under any
:class:`~repro.core.governor.GovernorSpec`.

Replays run on a **neutral machine** (``core_speed=1.0``,
``monitor_event_overhead=0``) because recorded durations are already
end-to-end measurements — scaling them again would double-count.  Pass
``machine=TraceReplayer.replay_machine(MN4)`` to keep a specific model's
latency constants (this is what makes a sim→sim round trip reproduce the
original decision sequence exactly).
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import Iterable

from ..core.conditions import ConditionTimeline
from ..core.events import EventKind, RuntimeEvent
from ..core.governor import GovernorReport, GovernorSpec
from ..runtime.cluster import ClusterModel
from ..runtime.machine import MachineModel
from ..runtime.task import Task, TaskGraph
from ..workloads.arrivals import FixedTimeline
from .recorder import TraceRecorder

__all__ = ["TraceReplayer"]


class TraceReplayer:
    """Builds replayable workloads from a recorded event stream."""

    def __init__(self, events: Iterable[RuntimeEvent] | TraceRecorder
                 | str | Path) -> None:
        if isinstance(events, TraceRecorder):
            # Canonical order: threaded recordings interleave N event
            # streams in lock order; merged_events() restores the
            # per-stream sequence (a no-op copy for sim recordings).
            self.events = events.merged_events()
        elif isinstance(events, (str, Path)):
            self.events = list(TraceRecorder.from_jsonl(events).events)
        else:
            self.events = list(events)

    @staticmethod
    def replay_machine(machine: MachineModel) -> MachineModel:
        """A machine whose latency constants match ``machine`` but which
        does not re-scale (or re-charge overhead on) recorded durations."""
        return replace(machine, name=f"{machine.name}-replay",
                       core_speed=1.0, monitor_event_overhead=0.0)

    # -- multi-app traces --------------------------------------------------

    def apps(self) -> list[str]:
        """Application namespaces present in the trace (sorted; events
        from per-app buses carry ``RuntimeEvent.app``).  Empty for a
        single-app trace recorded from an unnamespaced bus."""
        return sorted({ev.app for ev in self.events if ev.app is not None})

    def for_app(self, app: str) -> "TraceReplayer":
        """A replayer over this app's slice of a multi-app trace — the
        per-app graphs/timelines rebuild independently, so a recorded
        co-schedule can be replayed app-by-app or reassembled into a
        fresh multi-app cluster.

        Raises ``KeyError`` (listing the app ids the trace does contain)
        for an unknown app — an empty replayer would surface much later
        as a confusing zero-task replay."""
        events = [ev for ev in self.events if ev.app == app]
        if not events:
            raise KeyError(
                f"no events for app {app!r}; trace contains {self.apps()}")
        return TraceReplayer(events)

    # -- machine conditions ------------------------------------------------

    def conditions(self) -> ConditionTimeline | None:
        """The machine-condition timeline recorded in the trace
        (``PERTURBATION`` events carry ``Perturbation.to_dict()``
        payloads), or ``None`` for an unperturbed run."""
        rows = [ev.data for ev in self.events
                if ev.kind is EventKind.PERTURBATION]
        if not rows:
            return None
        return ConditionTimeline.from_dicts(rows)

    # -- graph reconstruction ----------------------------------------------

    def build(self) -> tuple[TaskGraph, FixedTimeline | None]:
        """Reconstruct ``(graph, arrivals)`` from the trace.

        Only tasks with a ``TASK_SUBMITTED`` event are materialized
        (orphan completions — e.g. serving prefill/decode-tick samples —
        are instrumentation, not schedulable work).  Each build returns
        *fresh* :class:`Task` objects, so the result can be executed
        repeatedly (once per candidate policy) without state leaking.
        ``arrivals`` is ``None`` for a closed-world trace (everything
        released at t=0); otherwise it is the recorded timeline and the
        graph's tasks carry the matching ``release_time``.
        """
        submitted: list[RuntimeEvent] = []
        elapsed: dict[int, float] = {}
        exec_at: dict[int, float] = {}
        xfer: dict[int, float] = {}
        for ev in self.events:
            if ev.kind is EventKind.TASK_SUBMITTED:
                submitted.append(ev)
            elif ev.kind is EventKind.TASK_EXECUTE and ev.task_id is not None:
                exec_at[ev.task_id] = ev.time
            elif (ev.kind is EventKind.TRANSFER and ev.task_id is not None
                  and ev.elapsed is not None):
                # multi-node trace: the task's EXECUTE→COMPLETED span
                # includes wire time that is not service time — the
                # replay cluster re-derives the transfer itself
                xfer[ev.task_id] = ev.elapsed
            elif (ev.kind is EventKind.TASK_COMPLETED
                  and ev.task_id is not None and ev.elapsed is not None):
                # Prefer the EXECUTE→COMPLETED interval: it is the
                # resource *holding* time on every frontend.  A serving
                # request's published ``elapsed`` is its sojourn
                # (queueing included), which must not be replayed as
                # service time.  When the interval agrees with the
                # published elapsed to within float rounding, keep the
                # published value: the simulator computes the COMPLETED
                # timestamp as start + service, so re-deriving the
                # service as ``time - start`` can be an ulp off — and
                # that ulp would break the byte-exact replay-of-replay
                # round trip.
                start = exec_at.get(ev.task_id)
                if start is None:
                    elapsed[ev.task_id] = ev.elapsed
                else:
                    interval = ev.time - start - xfer.get(ev.task_id, 0.0)
                    if abs(interval - ev.elapsed) <= 1e-9 * abs(interval):
                        elapsed[ev.task_id] = ev.elapsed
                    else:
                        elapsed[ev.task_id] = interval
        if not submitted:
            return TaskGraph(), None
        missing = [ev.task_id for ev in submitted
                   if ev.task_id not in elapsed]
        if missing:
            raise ValueError(
                f"trace is not replayable: {len(missing)} submitted "
                f"task(s) never completed (first: {missing[:5]})")

        t0 = min(ev.time for ev in submitted)
        # Submissions that precede any execution are the closed-world
        # part of the workload: a batch-submitted graph records wall
        # timestamps a few µs apart, and replaying that recording jitter
        # as an arrival timeline would be noise, not workload shape.
        first_exec = min((ev.time for ev in self.events
                          if ev.kind is EventKind.TASK_EXECUTE),
                         default=float("inf"))
        graph = TaskGraph()
        by_old_id: dict[int, Task] = {}
        release: list[float] = []
        for ev in submitted:
            assert ev.task_id is not None
            rt = ev.data.get("release_time")
            if rt is None:
                rt = ev.time - t0 if ev.time > first_exec else 0.0
            task = Task(type_name=ev.type_name or "task",
                        cost=ev.cost if ev.cost is not None else 1.0,
                        service_time=elapsed[ev.task_id])
            by_old_id[ev.task_id] = task
            release.append(rt)
            # Added dep-less and wired below: TaskGraph.add() dedups
            # deps through a set, which would permute the recorded dep
            # order — and the replay's re-recorded TASK_SUBMITTED events
            # must reproduce the original dep lists byte-for-byte.
            graph.add(task)
        # Dependencies/parents are wired in a second pass: open-mode
        # submission order is not topological (a dependent can be
        # submitted before its dependency), so resolving inline would
        # silently drop edges the live run honored.
        for ev in submitted:
            task = by_old_id[ev.task_id]
            unknown = [d for d in ev.data.get("deps", ())
                       if d not in by_old_id]
            parent_id = ev.data.get("parent")
            if parent_id is not None and parent_id not in by_old_id:
                unknown.append(parent_id)   # fail fast like missing deps:
                #                             a dropped parent silently
                #                             skews the monitor's
                #                             parent-child subtraction
            if unknown:
                raise ValueError(
                    f"trace is not replayable: task {ev.task_id} depends "
                    f"on unrecorded task(s) {unknown[:5]}")
            task.deps = [by_old_id[d] for d in ev.data.get("deps", ())]
            task.parent = (by_old_id[parent_id] if parent_id is not None
                           else None)
        if all(rt <= 0.0 for rt in release):
            return graph, None
        for task, rt in zip(graph.tasks, release):
            task.release_time = rt
        # The graph's per-task ``release_time`` is authoritative for
        # replay (and is what replay() uses); the returned FixedTimeline
        # is the canonical sorted sequence of arrival *instants* — do
        # not re-assign() it onto the graph if submission order was not
        # already release-ordered.
        return graph, FixedTimeline(tuple(sorted(release)))

    # -- one-call what-if --------------------------------------------------

    def replay(self, spec: GovernorSpec,
               machine: MachineModel | ClusterModel | None = None,
               bus=None) -> GovernorReport:
        """Replay the trace in the simulator under ``spec``.

        Default machine: a neutral model with ``spec.resources`` cores.
        Pass a :class:`~repro.runtime.cluster.ClusterModel` (use
        :meth:`ClusterModel.replay_model` to neutralize it first) to
        replay onto a multi-node cluster.  Pass ``bus`` (an
        :class:`~repro.core.events.EventBus`) to observe or re-record
        the replay.

        A perturbed trace replays under the *neutralized* form of its
        recorded :meth:`conditions`: structural perturbations (power
        caps, fail/recover) are re-applied verbatim — they drive the
        same scheduling decisions — while speed-changing ones
        (straggler slowdowns, thermal caps) are disarmed, because the
        recorded durations already include their dilation.
        """
        from ..runtime.sim import SimCluster, SimJobSpec

        if machine is None:
            # Neutral by construction: recorded service times are
            # end-to-end measurements, so neither core scaling nor
            # monitoring overhead may be charged a second time.
            machine = MachineModel(name="replay", n_cores=spec.resources,
                                   core_speed=1.0,
                                   monitor_event_overhead=0.0)
        graph, _ = self.build()
        tl = self.conditions()
        cluster = SimCluster(
            machine,
            conditions=tl.neutralized() if tl is not None else None)
        job = SimJobSpec(name="replay", graph=graph, governor=spec,
                         cpus=list(range(spec.resources)), bus=bus)
        cluster.add_job(job)
        return cluster.run()["replay"]
