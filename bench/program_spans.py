"""The program's own spans (``repro_torch.trace.spans``) as the benchmark
reads them: the profiled ranges in the kineto trace, the kernels put
down to the span that launched them, and the readings made from them.

The program marks its work with spans only while they are enabled, and a
span enters a ``torch.profiler`` range only while a profiler records;
the benchmark's runs enable neither, so :mod:`bench.tools.spans` runs a
cell with them.  :func:`collect` reads a stopped profiler: the program's
ranges (CPU side, by the names' :data:`PREFIXES`), each kernel with its
correlation id and each launch's host time by the same id.  A kernel is
put down to a span when its launch lies inside the span on the host,
never by comparing the kernel's device time with the span's host time,
which is wrong whenever the host runs ahead of the card.  Times are
microseconds on the profiler's clock, as in :mod:`bench.trace`."""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field

import torch

from .stats import gaps, percentile
from .trace import _NOT_KERNELS

__all__ = ["PREFIXES", "ProgramTrace", "collect", "queue_wait_p95_ms",
           "prefill_pad_pct", "kernel_load_s", "idle_pct",
           "launched_share_pct", "idle_gaps"]

#: the first part of every program span's name (the program exports the
#: same tuple as ``repro_torch.trace.spans.PREFIXES``; the benchmark
#: keeps its own copy so that it reads a program without spans too)
PREFIXES = ("engine.", "model.", "moe.", "train.", "optim.", "kernels.")


@dataclass
class ProgramTrace:
    #: the program's profiled ranges: (name, start, end, thread)
    spans: list[tuple[str, float, float, int]] = field(default_factory=list)
    #: device kernels: (name, start, end, correlation id)
    kernels: list[tuple[str, float, float, int]] = field(
        default_factory=list)
    #: host time of each kernel launch, by correlation id
    launches: dict[int, float] = field(default_factory=dict)
    #: device events named like a program span (the profiler's
    #: annotation of a range on the device's timeline): not kernels
    annotations: int = 0

    def named(self, name: str) -> list[tuple[str, float, float, int]]:
        return [s for s in self.spans if s[0] == name]


def collect(prof) -> ProgramTrace:
    """The program's ranges, the kernels and the launches of a stopped
    ``torch.profiler.profile``."""
    pt = ProgramTrace()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        b = a + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(PREFIXES):
                pt.annotations += 1
            elif not name.startswith(_NOT_KERNELS):
                pt.kernels.append((name, a, b, e.correlation_id()))
        elif name.startswith(PREFIXES):
            pt.spans.append((name, a, b, e.start_thread_id()))
        elif "Launch" in name and name.startswith("cu"):
            pt.launches[e.correlation_id()] = a
    pt.spans.sort(key=lambda s: s[1])
    pt.kernels.sort(key=lambda k: k[1])
    return pt


def _merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(union: list[tuple[float, float]], starts: list[float],
             a: float, b: float) -> float:
    """How much of [a, b] the disjoint sorted ``union`` covers."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(union) and union[i][0] < b:
        total += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
        i += 1
    return total


def _inside(union: list[tuple[float, float]], starts: list[float],
            t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


def idle_pct(pt: ProgramTrace, name: str,
             window: tuple[float, float] | None = None) -> float | None:
    """Device idle time inside the profiled ``name`` ranges (within
    ``window``) over their wall time, in %: the share of the time the
    host spent there in which no kernel ran."""
    lo, hi = window or (-math.inf, math.inf)
    ranges = _merged((a, b) for _, a, b, _ in pt.named(name)
                     if a >= lo and b <= hi)
    wall = sum(b - a for a, b in ranges)
    if not wall:
        return None
    busy = _merged((a, b) for _, a, b, _ in pt.kernels)
    starts = [a for a, _ in busy]
    covered = sum(_covered(busy, starts, a, b) for a, b in ranges)
    return 100.0 * (1.0 - covered / wall)


def launched_share_pct(pt: ProgramTrace, part: str, whole: str,
                       window: tuple[float, float] | None = None
                       ) -> float | None:
    """Device time of the kernels launched inside ``part`` ranges that
    lie inside ``whole`` ranges, over device time of the kernels launched
    inside ``whole`` ranges, in %; a kernel is matched to its launch by
    correlation id, and a kernel whose launch was not traced counts in
    neither."""
    lo, hi = window or (-math.inf, math.inf)
    outer = [(a, b, t) for _, a, b, t in pt.named(whole)
             if a >= lo and b <= hi]
    inner = [(a, b) for _, a, b, t in pt.named(part)
             if any(t == u and x <= a and b <= y for x, y, u in outer)]
    outer_u, inner_u = _merged((a, b) for a, b, _ in outer), _merged(inner)
    o_starts, i_starts = [a for a, _ in outer_u], [a for a, _ in inner_u]
    num = den = 0.0
    for _, a, b, corr in pt.kernels:
        t = pt.launches.get(corr)
        if t is None or not _inside(outer_u, o_starts, t):
            continue
        den += b - a
        if _inside(inner_u, i_starts, t):
            num += b - a
    return 100.0 * num / den if den else None


def queue_wait_p95_ms(records, ids) -> float | None:
    """The nearest-rank 95th percentile of the ``engine.queue`` spans of
    the requests ``ids``, in ms (+inf for a request never prefilled)."""
    waits = {r.attrs.get("id"): (r.end_ns - r.start_ns) / 1e6
             for r in records if r.name == "engine.queue"}
    if not ids or not waits:
        return None
    return percentile([waits.get(i, math.inf) for i in ids], 95)


def prefill_pad_pct(records, lo_ns: float, hi_ns: float) -> float | None:
    """Σ (bucket − length) over Σ bucket of the ``engine.prefill`` spans
    that ended in [lo_ns, hi_ns), in %: the share of the positions
    prefilled that are padding."""
    pre = [r.attrs for r in records
           if r.name == "engine.prefill" and lo_ns <= r.end_ns < hi_ns]
    total = sum(a["bucket"] for a in pre)
    if not total:
        return None
    return 100.0 * sum(a["bucket"] - a["length"] for a in pre) / total


def kernel_load_s(records) -> float | None:
    """Σ wall seconds of the ``kernels.load`` spans (a build included)."""
    loads = [r for r in records if r.name == "kernels.load"]
    if not loads:
        return None
    return sum(r.end_ns - r.start_ns for r in loads) / 1e9


def idle_gaps(tr, pt: ProgramTrace) -> tuple[list[list], float]:
    """The device's idle time in the traced window, summed by the label
    ``<harness range>/<innermost program span covering the gap's
    middle>`` (the harness range alone where no span covers it), with
    the harness's ranges labelled as :meth:`bench.trace.Trace.idle_gaps`
    labels them; and the share, in %, of the idle time inside
    ``bench.tick`` and ``bench.grads`` ranges that carries a span."""
    lo, hi = tr.window
    harness = []
    for i, (name, a, b) in enumerate(tr.named_ranges("bench.tick")):
        if i < len(tr.tick_info) and tr.tick_info[i].get("admitted"):
            name = "bench.tick(admit)"
        harness.append((name, a, b))
    harness += [r for r in tr.ranges if r[0] != "bench.window"
                and not r[0].startswith("bench.tick")]
    starts = [s[1] for s in pt.spans]
    reach, far = [], -math.inf        # the latest end among spans[:i + 1]
    for s in pt.spans:
        far = max(far, s[2])
        reach.append(far)

    def innermost(t: float) -> str | None:
        # spans nest on each thread, and the backward's thread opens its
        # spans inside the train step's, so the covering span entered
        # last is the innermost
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:
            if pt.spans[i][2] >= t:
                return pt.spans[i][0]
            i -= 1
        return None

    tot: dict[str, float] = {}
    inside = labelled = 0.0
    for a, b in gaps(((x, y) for _, x, y, _ in pt.kernels), lo, hi):
        mid, length = 0.5 * (a + b), (b - a) / 1e6
        name = next((n for n, x, y in harness if x <= mid <= y),
                    "outside the harness's ranges")
        span = innermost(mid)
        if name.startswith(("bench.tick", "bench.grads")):
            inside += length
            labelled += length if span else 0.0
        if span:
            name = f"{name}/{span}"
        tot[name] = tot.get(name, 0.0) + length
    top = [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]
    return top, (100.0 * labelled / inside if inside else math.nan)
