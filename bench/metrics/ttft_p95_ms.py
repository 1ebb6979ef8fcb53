"""ttft_p95_ms: the nearest-rank 95th percentile, over every request due
in the window, of the time from its due time to its first token on the
host, read after each ``engine.tick()``; a request that never finished
counts as +inf.  Host clock."""

from bench.stats import percentile


def read(rec: dict) -> float | None:
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    return percentile([r["ttft_s"] for r in rec["requests"]], 95) * 1e3
