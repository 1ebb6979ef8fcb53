"""The ``cost`` clause (paper §3.1).

The paper relies on a user-provided *cost clause* per task: a rough,
monotone measure of the computational weight of a task instance (e.g. the
tile size cubed for a GEMM task).  Costs are what let the monitoring
infrastructure *normalize* measured execution times across instances of the
same task type — two instances with different inputs map onto one *unitary
cost* (time per unit of cost), which extrapolates to any future instance.

``CostClause.evaluate`` is evaluated once, at task-creation time, outside the
runtime critical path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class CostClause:
    """A cost expression attached to a task type.

    Either a callable over the task's arguments (mirrors OmpSs-2's
    ``cost(expr)`` clause, evaluated per instance) or a constant.
    """

    fn: Callable[..., float] | None = None
    constant: float = 1.0

    def evaluate(self, *args: Any, **kwargs: Any) -> float:
        if self.fn is None:
            return float(self.constant)
        value = float(self.fn(*args, **kwargs))
        if value <= 0.0:
            # A non-positive cost would poison the unitary-cost
            # normalization; clamp like the reference runtime does.
            return 1.0
        return value


@dataclass
class TaskTypeInfo:
    """Static registry entry for a task type (label + cost clause)."""

    name: str
    cost: CostClause = field(default_factory=CostClause)

    def instance_cost(self, *args: Any, **kwargs: Any) -> float:
        return self.cost.evaluate(*args, **kwargs)


class TaskTypeRegistry:
    """Process-wide registry of task types.

    Task types are the aggregation key of the whole monitoring
    infrastructure (paper: "aggregation of metrics in a per-thread and
    per-task type basis").
    """

    def __init__(self) -> None:
        self._types: dict[str, TaskTypeInfo] = {}

    def register(self, name: str, cost: CostClause | None = None) -> TaskTypeInfo:
        info = self._types.get(name)
        if info is None:
            info = TaskTypeInfo(name=name, cost=cost or CostClause())
            self._types[name] = info
        elif cost is not None:
            info.cost = cost
        return info

    def get(self, name: str) -> TaskTypeInfo:
        try:
            return self._types[name]
        except KeyError:
            return self.register(name)

    def __contains__(self, name: str) -> bool:
        return name in self._types

    def names(self) -> list[str]:
        return list(self._types)
