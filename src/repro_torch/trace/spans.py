"""Program spans and counters: where the port's own time goes, from
inside the engine, the model, the train step and the kernel loader.

    from repro_torch.trace import spans

    spans.enable()
    with torch.profiler.profile(...) as prof:
        engine.tick()                 # engine.*, model.*, moe.* spans
    spans.disable()
    spans.records()                   # [Span(name, start_ns, end_ns, ...)]

``span(name, **attrs)`` marks a piece of work where it happens;
``add(name, n)`` counts something there: a number, or the elements of a
device tensor that are not zero, summed on the device without waiting
for it (:func:`counters` reads the sums).  Both are off by default, and
:func:`enable` / :func:`disable` are the only switch: off, ``span``
returns one shared null context after a single check of a module flag
(no clock read, no span object, no profiler range) and ``add`` returns
at once.

On, a span stamps ``time.perf_counter_ns()`` at its entry and exit (the
clock of the serving engine's events) and keeps its parent, the span
open around it on the same thread: autograd's backward, and the
recomputation of checkpointed layers in it, run on the device's own
thread, so each thread has its own stack.  While a ``torch.profiler`` is
recording, a span also enters ``torch.profiler.record_function(name)``,
so it lies in the same kineto trace as the kernels it launched, on the
device trace's clock.  The records in memory cover everything between
:func:`enable` and :func:`disable`; the profiled ranges cover what the
profiler saw.

Spans read the host's clock by design: they time the live program, and
no simulation or replay reads them (the determinism lint's suppressions
below say so).

Every span's name starts with one of :data:`PREFIXES`, by the module it
marks: ``engine.`` (the serving engine), ``model.`` (a layer, the head),
``moe.`` (the experts' dispatch and products), ``train.`` (the train
step), ``optim.`` (the clip and AdamW) and ``kernels.`` (a kernel's
backward formula, the load and build of a kernel's library).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["PREFIXES", "Span", "span", "record", "add", "enable", "disable",
           "enabled", "records", "counters", "reset"]

#: the first part of every span's name, one for each module that marks
PREFIXES = ("engine.", "model.", "moe.", "train.", "optim.", "kernels.")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    #: index in :func:`records` of the span open around this one on its
    #: thread, −1 for none
    parent: int
    thread: int
    attrs: dict


_on = False
#: every span entered since the last reset, in order of entry:
#: [name, start_ns, end_ns, parent's record or None, thread, attrs]
_records: list[list] = []
_counters: dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()
_NULL = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("_rec", "_range")

    def __init__(self, name: str, attrs: dict) -> None:
        self._rec = [name, 0, 0, None, 0, attrs]
        self._range = None

    def __enter__(self) -> "_Span":
        rec, stack = self._rec, _stack()
        rec[3] = stack[-1] if stack else None
        rec[4] = threading.get_ident()
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(rec[0])
            self._range.__enter__()
        stack.append(rec)
        _records.append(rec)
        rec[1] = time.perf_counter_ns()  # analysis: ignore[wall-clock] -- times the live program
        return self

    def __exit__(self, *exc) -> None:
        self._rec[2] = time.perf_counter_ns()  # analysis: ignore[wall-clock] -- as above
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)


def span(name: str, **attrs):
    """A context manager that marks the work inside it as ``name``, with
    ``attrs`` (a request's id, a prompt's length); a shared null context
    while spans are off."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


def record(name: str, start_s: float, end_s: float, **attrs) -> None:
    """A span whose ends were stamped by its caller, in seconds of
    ``time.perf_counter``: work that no block of code encloses, such as a
    request's wait in a queue.  It has no parent and no profiled range."""
    if _on:
        _records.append([name, round(start_s * 1e9), round(end_s * 1e9),
                         None, threading.get_ident(), attrs])


def add(name: str, n: int | torch.Tensor = 1) -> None:
    """Add ``n`` to the counter ``name``; a tensor adds the count of its
    nonzero elements, kept on its device until :func:`counters`."""
    if not _on:
        return
    if isinstance(n, torch.Tensor):
        n = torch.count_nonzero(n)
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """True while spans are on: a path that runs without them (a replayed
    CUDA graph) is left for the traced one."""
    return _on


def records() -> list[Span]:
    """The spans closed since the last :func:`reset`, in order of entry."""
    done = [r for r in list(_records) if r[2]]
    index = {id(r): i for i, r in enumerate(done)}
    return [Span(r[0], r[1], r[2],
                 -1 if r[3] is None else index.get(id(r[3]), -1),
                 r[4], dict(r[5])) for r in done]


def counters() -> dict[str, int]:
    """Every counter's value (a device's sums are read here)."""
    with _lock:
        return {k: int(v) for k, v in _counters.items()}


def reset() -> None:
    """Forget every record and counter (spans still open stay open)."""
    with _lock:
        _records.clear()
        _counters.clear()
