"""Tasks and task graphs.

A :class:`Task` mirrors an OmpSs-2 task: a unit of work with a *type*
(the monitoring aggregation key), a *cost* (the paper's ``cost`` clause,
evaluated at creation time), explicit *dependencies* (predecessor tasks)
and an optional *parent* (for the paper's parent–child outstanding-time
subtraction).

Payloads are either a Python callable ``fn`` (executed by the real
:class:`~repro.runtime.thread_executor.ThreadExecutor`) or a virtual
``service_time`` in seconds (consumed by the simulator).  Workloads attach
both so the same graph runs everywhere.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

__all__ = ["Task", "TaskGraph"]

_ids = itertools.count()


@dataclass(eq=False, slots=True)
class Task:
    type_name: str
    cost: float = 1.0
    fn: Callable[[], Any] | None = None
    service_time: float | None = None       # virtual seconds (simulator)
    parent: "Task | None" = None
    deps: list["Task"] = field(default_factory=list)
    #: open-workload release time (virtual seconds from run start); None
    #: means the task is part of the closed graph submitted at t=0.  An
    #: :class:`~repro.workloads.arrivals.ArrivalProcess` or a replayed
    #: trace fills it in; dependencies still gate readiness after release.
    release_time: float | None = None
    # -- filled by the scheduler ------------------------------------------
    task_id: int = field(default_factory=lambda: next(_ids))
    unmet: int = 0
    successors: list["Task"] = field(default_factory=list)
    done: bool = False
    #: global core id this task completed on (stamped by the simulator;
    #: successors use it to charge cross-node transfer / remote-socket
    #: penalties on the dependency edge).  None outside the simulator.
    completed_on: int | None = None

    def __hash__(self) -> int:
        return self.task_id

    def depends_on(self, *tasks: "Task") -> "Task":
        self.deps.extend(tasks)
        return self


class TaskGraph:
    """A container that wires dependencies and hands tasks to a scheduler.

    Supports OmpSs-2-style data dependences via :meth:`add` with ``in_``
    /``out`` token sets: a task depends on the last writer of each of its
    ``in_`` tokens and on all readers since the last write for ``out``
    tokens (write-after-read).
    """

    def __init__(self) -> None:
        self.tasks: list[Task] = []
        self._last_writer: dict[Any, Task] = {}
        self._readers_since_write: dict[Any, list[Task]] = {}

    def add(self, task: Task, in_: Iterable[Any] = (),
            out: Iterable[Any] = ()) -> Task:
        deps: set[Task] = set(task.deps)
        for tok in in_:
            w = self._last_writer.get(tok)
            if w is not None:
                deps.add(w)
            self._readers_since_write.setdefault(tok, []).append(task)
        for tok in out:
            w = self._last_writer.get(tok)
            if w is not None:
                deps.add(w)
            for r in self._readers_since_write.get(tok, []):
                if r is not task:
                    deps.add(r)
            self._last_writer[tok] = task
            self._readers_since_write[tok] = []
        task.deps = list(deps)
        self.tasks.append(task)
        return task

    def __len__(self) -> int:
        return len(self.tasks)
