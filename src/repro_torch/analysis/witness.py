"""Runtime lock-order witness.

A debug-mode shim (no ``threading.setprofile``, no tracing): when a
:class:`LockOrderWitness` is installed, every construction of a
``@guarded_by``-decorated class replaces its declared lock with a thin
wrapper that keeps a per-thread stack of held locks.  Each acquisition
is checked against the stack — acquiring a lock whose declared rank is
outer-or-equal to one already held is a lock-order violation (the PR 4
broker-deadlock shape) — and every nested pair actually observed is
recorded, so the test suite ends with an empirical map of the hierarchy
that :meth:`LockOrderWitness.check_declared` cross-checks against
:data:`~repro.analysis.annotations.LOCK_ORDER`.

The witness is installed for the whole threaded test suite by an
autouse fixture in ``tests/conftest.py`` (disable with
``REPRO_LOCK_WITNESS=0``); measurement-only tests opt out with
:func:`witness_paused`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from . import annotations

__all__ = [
    "LockOrderWitness",
    "install_witness",
    "uninstall_witness",
    "active_witness",
    "witness_paused",
]


class _WitnessLock:
    """Drop-in ``threading.Lock`` wrapper that reports to the witness."""

    __slots__ = ("_inner", "rank", "owner", "_witness")

    def __init__(self, witness: "LockOrderWitness", rank: int,
                 owner: str) -> None:
        self._inner = threading.Lock()
        self.rank = rank
        self.owner = owner
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Check *before* blocking: if this acquisition inverts the
        # declared order the deadlock may happen right here.
        self._witness.note_before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.note_acquired(self)
        return got

    def release(self) -> None:
        self._witness.note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()


class LockOrderWitness:
    """Records actual lock-acquisition orders and flags inversions.

    ``strict=True`` raises on the acquiring thread at the moment of the
    inversion (regression tests); the default records the violation and
    lets the suite-level fixture fail the session with the full list.
    """

    def __init__(self, strict: bool = False) -> None:
        self.strict = strict
        self._tls = threading.local()
        self._mutex = threading.Lock()
        #: (outer class, inner class) pairs actually observed nested
        self.observed: set[tuple[str, str]] = set()
        #: human-readable violation descriptions
        self.violations: list[str] = []
        self.acquisitions = 0

    # -- instrumentation hook (called from decorated __init__) -----------

    def instrument(self, obj: object, lock_attr: str, rank: int,
                   owner: str) -> None:
        current = getattr(obj, lock_attr, None)
        if isinstance(current, _WitnessLock):
            return  # subclass chained through an already-wrapped init
        setattr(obj, lock_attr, _WitnessLock(self, rank, owner))

    # -- per-thread held stack -------------------------------------------

    def _stack(self) -> list[_WitnessLock]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_before_acquire(self, lock: _WitnessLock) -> None:
        stack = self._stack()
        if not stack:
            return
        for held in stack:
            if held.rank >= lock.rank:
                msg = (
                    f"lock-order inversion on thread "
                    f"{threading.current_thread().name!r}: acquiring "
                    f"{lock.owner} (rank {lock.rank}) while holding "
                    f"{held.owner} (rank {held.rank}); declared order: "
                    f"{' -> '.join(annotations.LOCK_ORDER)}")
                with self._mutex:
                    self.violations.append(msg)
                if self.strict:
                    raise RuntimeError(msg)

    def note_acquired(self, lock: _WitnessLock) -> None:
        stack = self._stack()
        if stack:
            pairs = {(held.owner, lock.owner) for held in stack}
            with self._mutex:
                self.observed |= pairs
        stack.append(lock)
        self.acquisitions += 1  # approximate across threads; fine for stats

    def note_released(self, lock: _WitnessLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    # -- session-end cross-check -----------------------------------------

    def check_declared(self) -> list[str]:
        """Cross-check every observed nested pair against the declared
        hierarchy; returns the problems (empty = validated)."""
        problems = []
        rank = {name: i for i, name in enumerate(annotations.LOCK_ORDER)}
        with self._mutex:
            observed = sorted(self.observed)
        for outer, inner in observed:
            ro, ri = rank.get(outer), rank.get(inner)
            if ro is None or ri is None:
                problems.append(
                    f"observed lock of undeclared class: {outer} -> {inner}")
            elif ro >= ri:
                problems.append(
                    f"observed acquisition order {outer} -> {inner} "
                    f"inverts declared LOCK_ORDER (ranks {ro} >= {ri})")
        return problems


def install_witness(strict: bool = False) -> LockOrderWitness:
    """Install (and return) a fresh witness; newly constructed decorated
    objects get instrumented locks from here on."""
    witness = LockOrderWitness(strict=strict)
    annotations._set_witness(witness)
    return witness


def uninstall_witness() -> None:
    annotations._set_witness(None)


def active_witness() -> LockOrderWitness | None:
    return annotations._witness


@contextlib.contextmanager
def witness_paused() -> Iterator[None]:
    """Temporarily disable instrumentation of *new* objects — for
    measurement-only tests (throughput floors) that must not pay the
    per-acquisition bookkeeping."""
    saved = annotations._witness
    annotations._set_witness(None)
    try:
        yield
    finally:
        annotations._set_witness(saved)
