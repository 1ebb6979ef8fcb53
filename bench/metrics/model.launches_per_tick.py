"""model.launches_per_tick: device kernels inside the harness's
``bench.tick`` ranges of the traced window whose tick admitted no
prompt, over those ticks: a count.  Layer: model step."""


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None:
        return None
    ticks = tr.named_ranges("bench.tick")
    counts = [len(tr.kernels_within(a, b))
              for (_, a, b), info in zip(ticks, tr.tick_info)
              if not info.get("admitted")]
    counts = [c for c in counts if c]
    return sum(counts) / len(counts) if counts else None
