"""engine.prefill_ms_per_ktok: Σ ``elapsed`` of the engine's ``prefill``
TASK_COMPLETED events in the window (each ends in a read of the first
token, so it waits for the device) over the prompt tokens, per thousand
tokens.  Layer: engine."""


def read(rec: dict) -> float | None:
    ev = [e for e in rec.get("events", []) if e[0] == "prefill"]
    tokens = sum(e[2] for e in ev)
    if not tokens:
        return None
    return sum(e[3] for e in ev) * 1e3 / (tokens / 1e3)
