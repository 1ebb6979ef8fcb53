"""itl_p95_ms: the nearest-rank 95th percentile over every gap between
consecutive output tokens of the requests due in the window (a request
that never finished adds one +inf gap).  Host clock."""

from bench.stats import percentile


def read(rec: dict) -> float | None:
    if rec["kind"] != "serve" or not rec["requests"]:
        return None
    gaps = [g for r in rec["requests"] for g in r["gaps_s"]]
    return percentile(gaps, 95) * 1e3 if gaps else None
