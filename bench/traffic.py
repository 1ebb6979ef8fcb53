"""The one generator of open-loop traffic, driven by a traffic file.

A run's timeline has three segments: the lead-in (``lead_in_s``), the
measured window (``--seconds``) and the tail (``drain_s``), in which
arrivals go on while the window's requests finish.  Each segment holds
``round(rate × length)`` requests (for bursts, whole bursts), whose
arrival times come from the frozen arrival processes
(:mod:`bench.frozen.arrivals`) seeded by the file's ``base_seed``, and
whose prompt and output lengths are drawn from the file's lognormal
laws, clipped, with the same base seed.  So every run seed gets the same
arrivals with the same sizes, in the same order, and the seed draws only
the prompts' tokens (and, elsewhere, the weights): seeds change the
content, not the work.  (Ordering the sizes by the seed moved the chat
cell's p95 time to first token by 13 % from seed to seed, against 2 %
between two runs of one seed.)

The file: ``arrivals`` (``{"process": "poisson", "rate": r}`` or
``{"process": "burst", "rate": r, "burst_size": n, "spacing": s,
"jitter": j}``: bursts of n arrivals s seconds apart, their gaps sized
for a mean rate r), ``prompt`` and ``output`` (``{"median", "sigma",
"min", "max"}`` of a lognormal law, in tokens), ``lead_in_s``,
``drain_s`` and ``base_seed``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .frozen.arrivals import BurstArrivals, PoissonArrivals

__all__ = ["Arrival", "schedule", "lengths"]


@dataclass
class Arrival:
    due: float          # seconds after the lead-in starts
    prompt: list[int]
    max_new: int
    segment: str        # "lead", "window" or "tail"


def lengths(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n lengths from a lognormal law with the given median and σ,
    rounded and clipped to [min, max]."""
    x = rng.lognormal(np.log(law["median"]), law["sigma"], size=n)
    return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)


def _times(arr: dict, n: int, length: float, seed: int) -> np.ndarray:
    """n arrival times in [0, length), the process's own, stretched to
    span the segment."""
    if arr["process"] == "poisson":
        t = np.asarray(PoissonArrivals(rate=arr["rate"], seed=seed)
                       .times(n + 1))
    elif arr["process"] == "burst":
        size = int(arr["burst_size"])
        spacing = float(arr["spacing"])
        gap = size / arr["rate"] - (size - 1) * spacing
        t = np.asarray(BurstArrivals(burst_size=size, gap=gap,
                                     spacing=spacing, seed=seed,
                                     jitter=arr.get("jitter", 0.0))
                       .times(n + 1))
    else:
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    t = t - t[0]
    return t[:n] * (length / t[n])


def _count(arr: dict, length: float) -> int:
    n = int(round(arr["rate"] * length))
    if arr["process"] == "burst":
        size = int(arr["burst_size"])
        n = max(size, size * int(round(n / size)))
    return max(1, n)


def schedule(traffic: dict, seed: int, seconds: float, vocab: int
             ) -> list[Arrival]:
    """Every arrival of one run, in order of due time."""
    arr = traffic["arrivals"]
    base = int(traffic.get("base_seed", 0))
    content = np.random.default_rng([int(seed) % 2**63, 2])
    out: list[Arrival] = []
    start = 0.0
    for si, (name, length) in enumerate((("lead", traffic["lead_in_s"]),
                                         ("window", seconds),
                                         ("tail", traffic["drain_s"]))):
        if length <= 0:
            continue
        n = _count(arr, length)
        times = _times(arr, n, length, base * 16 + si)
        sizes = np.random.default_rng([base, si])
        plen = lengths(traffic["prompt"], n, sizes)
        olen = lengths(traffic["output"], n, sizes)
        for t, p, o in zip(times, plen, olen):
            out.append(Arrival(
                float(start + t),
                content.integers(1, vocab, size=int(p)).tolist(),
                int(o), name))
        start += length
    return out
