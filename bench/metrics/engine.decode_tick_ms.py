"""engine.decode_tick_ms: the mean ``elapsed`` of the engine's
``decode_tick`` TASK_COMPLETED events in the window (each ends in a
host copy of the tokens, so it waits for the device).  Layer: engine."""


def read(rec: dict) -> float | None:
    ev = [e[3] for e in rec.get("events", []) if e[0] == "decode_tick"]
    return sum(ev) / len(ev) * 1e3 if ev else None
