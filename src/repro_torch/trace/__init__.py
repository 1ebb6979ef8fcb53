"""Trace record/replay — run a workload once, replay it everywhere.

:class:`TraceRecorder` subscribes to any frontend's
:class:`~repro.core.events.EventBus` (threaded executor, simulator,
serving engine) and records the structured event stream; it exports JSONL
(lossless, reloadable) and Chrome ``chrome://tracing`` / Perfetto JSON.

:class:`TraceReplayer` turns a recorded trace back into a
:class:`~repro.runtime.task.TaskGraph` (types, costs, dependencies,
measured durations as service times) plus an arrival timeline, and runs
it deterministically in the simulator — so one recorded workload becomes
a what-if experiment under every registered policy.
"""

from .recorder import TraceRecorder, decision_sequence, prediction_sequence
from .replay import TraceReplayer

__all__ = ["TraceRecorder", "TraceReplayer", "decision_sequence",
           "prediction_sequence"]
