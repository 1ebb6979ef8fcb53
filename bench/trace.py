"""The traced run's device trace: ``torch.profiler`` over part of the
window, with the harness's own ranges (``record_function``) around the
calls it makes into the program — ``bench.window`` around the whole
traced part, ``bench.tick`` around each ``engine.tick()``, ``bench.wait``
around the loop's sleeps, ``bench.grads`` and ``bench.update`` around
the train step's two halves.

:class:`Trace` holds what the per-layer metrics read: the device kernels
(name, start, end), the harness's ranges, and the program's operators
(``repro_torch::*``) with the shapes of their inputs.  Times are
microseconds on the profiler's clock."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from .stats import gaps, union_length

__all__ = ["Tracer", "Trace"]

#: device activity that is not a kernel
_NOT_KERNELS = ("Memcpy", "Memset", "bench.")


@dataclass
class Trace:
    kernels: list[tuple[str, float, float]] = field(default_factory=list)
    ranges: list[tuple[str, float, float]] = field(default_factory=list)
    ops: list[tuple[str, float, float, list, list]] = field(
        default_factory=list)
    window: tuple[float, float] = (0.0, 0.0)
    #: one entry per ``bench.tick`` range, in order: the harness's own
    #: record of that tick (``{"admitted": n, ...}``)
    tick_info: list[dict] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self, items):
        lo, hi = self.window
        return [x for x in items if x[1] >= lo and x[2] <= hi]

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_length((max(a, lo), min(b, hi))
                            for _, a, b in self.kernels
                            if b > lo and a < hi) / 1e6

    def named_ranges(self, prefix: str):
        return [r for r in self.ranges if r[0].startswith(prefix)]

    def kernels_within(self, a: float, b: float):
        return [k for k in self.kernels if k[1] >= a and k[2] <= b]

    def device_ops(self, top: int = 10) -> list[list]:
        """The kernels that took most device time in the window, summed
        by name: [[name, seconds], ...]."""
        tot: dict[str, float] = {}
        for name, a, b in self.in_window(self.kernels):
            tot[name[:120]] = tot.get(name[:120], 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time in the window, summed by the harness's
        range the host was in (a tick that admitted a prompt is
        ``bench.tick(admit)``): [[name, seconds], ...]."""
        lo, hi = self.window
        labelled = []
        for i, (name, a, b) in enumerate(self.named_ranges("bench.tick")):
            if i < len(self.tick_info) and self.tick_info[i].get("admitted"):
                name = "bench.tick(admit)"
            labelled.append((name, a, b))
        labelled += [r for r in self.ranges
                     if r[0] != "bench.window"
                     and not r[0].startswith("bench.tick")]
        labelled.sort(key=lambda r: r[1])
        tot: dict[str, float] = {}
        for a, b in gaps(((x, y) for _, x, y in self.kernels), lo, hi):
            mid = 0.5 * (a + b)
            name = next((n for n, x, y in labelled if x <= mid <= y),
                        "outside the harness's ranges")
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:top]]


def _collect(prof) -> Trace:
    tr = Trace()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3              # microseconds
        b = a + e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(_NOT_KERNELS):
                tr.kernels.append((name, a, b))
        elif name.startswith("bench."):
            tr.ranges.append((name, a, b))
        elif name.startswith("repro_torch::"):
            tr.ops.append((name, a, b, e.shapes(), e.dtypes()))
    tr.kernels.sort(key=lambda k: k[1])
    tr.ranges.sort(key=lambda r: r[1])
    tr.ops.sort(key=lambda o: o[1])
    win = [r for r in tr.ranges if r[0] == "bench.window"]
    if win:
        tr.window = (win[0][1], win[0][2])
    return tr


class Tracer:
    """The profiler, on only while :meth:`window` is open, and the
    harness's ranges, which cost nothing when tracing is off."""

    def __init__(self, enabled: bool, device: torch.device) -> None:
        self.enabled = enabled
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None
        self.trace: Trace | None = None
        self.tick_info: list[dict] = []
        self.active = False

    def range(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        if not self.enabled or self.active or self.trace is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=acts,
                                            record_shapes=True)
        self._prof.start()
        self.active = True
        self._win = torch.profiler.record_function("bench.window")
        self._win.__enter__()

    def stop(self) -> None:
        if not self.active:
            return
        if self._cuda:
            torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self._prof.stop()
        self.active = False
        self.trace = _collect(self._prof)
        self.trace.tick_info = self.tick_info
        self._prof = None
