"""Trace recording: an event-bus subscriber with JSONL + Chrome export.

The recorder is frontend-agnostic by construction — it never touches a
scheduler or a governor, it only subscribes to the
:class:`~repro.core.events.EventBus` every frontend publishes on.  The
JSONL form is the replay input (`repro.trace.replay`); the Chrome form
(``chrome://tracing`` / https://ui.perfetto.dev) is for eyeballs:
per-worker task lanes plus a Δ-prediction counter track.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Iterable

from ..analysis import guarded_by
from ..core.events import EventBus, EventKind, RuntimeEvent

__all__ = ["TraceRecorder", "decision_sequence", "prediction_sequence"]


@guarded_by("events", "_buses")
class TraceRecorder:
    """Records :class:`RuntimeEvent` streams from one or more buses."""

    def __init__(self, bus: EventBus | None = None,
                 kinds: Iterable[EventKind] | None = None) -> None:
        self.events: list[RuntimeEvent] = []
        self._kinds = frozenset(kinds) if kinds is not None else None
        self._lock = threading.Lock()
        self._buses: list[EventBus] = []
        if bus is not None:
            self.attach(bus)

    # -- subscription ------------------------------------------------------

    def attach(self, bus: EventBus) -> "TraceRecorder":
        """Subscribe to ``bus`` (idempotent per bus — double-attaching
        must not double-record every event).

        The membership check and the append happen under the recorder
        lock: two threads racing attach() on the same bus used to both
        pass the unlocked check and double-subscribe.  Holding it across
        ``bus.subscribe`` is fine — TraceRecorder precedes EventBus in
        the declared LOCK_ORDER."""
        with self._lock:
            if any(b is bus for b in self._buses):
                return self
            bus.subscribe(self._record, kinds=self._kinds)
            self._buses.append(bus)
        return self

    def detach(self) -> None:
        with self._lock:
            buses, self._buses = self._buses, []
        for bus in buses:
            bus.unsubscribe(self._record)

    def _record(self, ev: RuntimeEvent) -> None:
        with self._lock:
            self.events.append(ev)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)

    # -- canonical ordering ------------------------------------------------

    def merged_events(self) -> list[RuntimeEvent]:
        """Events in canonical (replayable) order.

        Single-threaded producers (the simulator) record an already-
        ordered stream and get it back verbatim — no event carries a
        ``seq`` stamp, and the list (hence the JSONL bytes) is exactly
        what was appended.  Multi-threaded producers (the sharded
        real-thread scheduler) append from N streams in recorder-lock
        order, which is not program order; their events carry per-stream
        monotonic ``seq`` stamps, and this method merge-sorts the
        streams back: stable sort on ``(time, stream, seq)``, where the
        stream is the publishing worker (submit-side events sort as
        stream −1).  Unstamped events (worker states, predictions) keep
        their arrival position among equal-time stamps — replay ignores
        their order.
        """
        with self._lock:
            events = list(self.events)
        if all(ev.seq is None for ev in events):
            return events
        events.sort(key=lambda ev: (
            ev.time,
            -1 if ev.worker_id is None else ev.worker_id,
            -1 if ev.seq is None else ev.seq))
        return events

    # -- JSONL round trip --------------------------------------------------

    def to_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        events = self.merged_events()
        with path.open("w") as f:
            for ev in events:
                f.write(json.dumps(ev.to_dict()) + "\n")
        return path

    @classmethod
    def from_jsonl(cls, path: str | Path) -> "TraceRecorder":
        rec = cls()
        with Path(path).open() as f:
            for line in f:
                line = line.strip()
                if line:
                    rec.events.append(RuntimeEvent.from_dict(
                        json.loads(line)))
        return rec

    # -- Chrome tracing export ---------------------------------------------

    def to_chrome(self, path: str | Path) -> Path:
        """Write a ``chrome://tracing`` / Perfetto JSON trace.

        Tasks become complete (``ph="X"``) slices on per-worker lanes
        (EXECUTE→COMPLETED pairs; COMPLETED-only events — e.g. serving
        prefill/decode ticks — are reconstructed from their elapsed), and
        every PREDICTION tick becomes a Δ counter sample.
        """
        events = self.merged_events()
        if events:
            t0 = min(ev.time for ev in events)
        else:
            t0 = 0.0
        us = 1e6
        exec_at: dict[int, RuntimeEvent] = {}
        out: list[dict] = []
        for ev in events:
            if ev.kind is EventKind.TASK_EXECUTE and ev.task_id is not None:
                exec_at[ev.task_id] = ev
            elif ev.kind is EventKind.TASK_COMPLETED:
                start = exec_at.pop(ev.task_id, None) \
                    if ev.task_id is not None else None
                if start is not None:
                    ts = (start.time - t0) * us
                    dur = (ev.time - start.time) * us
                    tid = start.worker_id
                elif ev.elapsed is not None:
                    ts = (ev.time - ev.elapsed - t0) * us
                    dur = ev.elapsed * us
                    tid = ev.worker_id
                else:
                    continue
                out.append({
                    "name": ev.type_name or "task", "ph": "X",
                    "ts": ts, "dur": max(dur, 0.0), "pid": 0,
                    "tid": tid if tid is not None else 0,
                    "args": {"task_id": ev.task_id, "cost": ev.cost},
                })
            elif ev.kind is EventKind.PREDICTION:
                out.append({
                    "name": "delta", "ph": "C",
                    "ts": (ev.time - t0) * us, "pid": 0,
                    "args": {"delta": ev.data.get("delta", 0)},
                })
            elif ev.kind is EventKind.TASK_ARRIVED:
                out.append({
                    "name": f"arrive:{ev.type_name}", "ph": "i",
                    "ts": (ev.time - t0) * us, "pid": 0, "tid": 0,
                    "s": "g",
                })
        path = Path(path)
        path.write_text(json.dumps({"traceEvents": out,
                                    "displayTimeUnit": "ms"}))
        return path


def decision_sequence(events: Iterable[RuntimeEvent],
                      ) -> list[tuple[int, str]]:
    """The policy decision sequence of a run: ordered worker state
    transitions ``(worker_id, new_state)`` — the signal the round-trip
    replay property is checked against."""
    return [(ev.worker_id, ev.data["state"]) for ev in events
            if ev.kind is EventKind.WORKER_STATE
            and ev.worker_id is not None]


def prediction_sequence(events: Iterable[RuntimeEvent]) -> list[int]:
    """Ordered Δ values published by the governor's prediction ticks."""
    return [ev.data["delta"] for ev in events
            if ev.kind is EventKind.PREDICTION]
