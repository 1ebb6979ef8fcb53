"""mfu.serve, in %: the model FLOPs of the window's prefills and decode ticks
(frozen formulas: 2 × active parameters × tokens, plus attention's
query-key pairs or the WKV) over Σ their ``elapsed``, over the card's
bf16 peak (989e12).  Layer: model step, the whole step."""

from bench.readers import PEAK_FLOPS, serve_model_flops


def read(rec: dict) -> float | None:
    if rec["kind"] != "serve":
        return None
    busy = sum(e[3] for e in rec["events"])
    if not busy:
        return None
    return 100.0 * serve_model_flops(rec) / busy / PEAK_FLOPS
