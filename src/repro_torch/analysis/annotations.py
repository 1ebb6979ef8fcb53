"""Machine-checkable concurrency annotations.

Every class in the runtime that owns a ``threading.Lock`` declares its
discipline here, and ``python -m repro.analysis`` (plus the runtime
witness) enforces it:

* ``@guarded_by("_a", "_b", lock="_lock")`` — instances of this class
  mutate ``self._a`` / ``self._b`` only while holding ``self._lock``.
  The class name must appear in :data:`LOCK_ORDER`; its position is the
  lock's rank in the global acquisition hierarchy.
* ``@lock_free`` — this class must never acquire a lock of its own (the
  single-threaded fast-path contract, e.g.
  :class:`~repro.runtime.scheduler._SeqScheduler`).  Inherited guarded
  fields are exempt; the static pass instead verifies no threading
  primitive is reachable through its methods, and the class is expected
  to enforce single-thread use at runtime (owning-thread assertion).
* ``@single_writer("_x")`` — the named fields are mutated by exactly one
  thread (e.g. the prediction tick loop) and read lock-free elsewhere;
  the class owns no lock at all.

Static-pass conventions (see :mod:`repro.analysis.lockcheck`):

* a method whose name ends in ``_locked`` — or whose ``def`` line (or
  the line above it) carries ``# analysis: caller-locks`` — is entered
  with the instance lock already held by its caller;
* a finding is silenced only by an inline
  ``# analysis: ignore[<rule>] -- <justification>`` comment; the
  analyzer rejects suppressions without a justification text.

``LOCK_ORDER`` is the single declared hierarchy, outermost lock first:
holding a lock, a thread may only acquire locks of classes that appear
*later* in the tuple.  The runtime witness checks the orders actually
observed during the threaded test suite against this exact tuple.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

__all__ = [
    "LOCK_ORDER",
    "guarded_by",
    "lock_free",
    "single_writer",
    "registered_classes",
    "lock_rank",
]

#: The global lock hierarchy, outermost first.  A thread holding the
#: lock of class at index i may only acquire locks of classes at index
#: > i.  Rationale for the order (the nestings that actually occur):
#:
#: * ``ThreadExecutor._submit_lock`` guards only the submission counter
#:   and nests inside nothing — outermost by construction.
#: * ``ResourceBroker`` verbs are self-contained and are always called
#:   from the event loop / worker loops with no other lock held.
#: * ``Scheduler`` holds its lock while driving the ``TaskMonitor``
#:   (``completion_batch``) and while publishing READY events (which
#:   reach a ``TraceRecorder``), so it precedes both.
#: * ``ShardedScheduler`` (the real-thread fast lane) holds its
#:   dependency-bookkeeping lock only while publishing submit-side
#:   events (→ recorder); its monitor flushes run with no lock held,
#:   but ranking it exactly where ``Scheduler`` sits keeps the two
#:   interchangeable behind an executor.
#: * ``WorkerManager`` publishes WORKER_STATE transitions (→ recorder)
#:   with its lock held.
#: * ``TraceRecorder.attach`` subscribes to a bus, so the recorder lock
#:   precedes the ``EventBus`` registration lock (``EventBus.publish``
#:   itself is lock-free by design and appears nowhere in the order).
LOCK_ORDER: tuple[str, ...] = (
    "ThreadExecutor",
    "ResourceBroker",
    "Scheduler",
    "ShardedScheduler",
    "WorkerManager",
    "TaskMonitor",
    "TraceRecorder",
    "EventBus",
)

#: class name → decorated class, for the runtime witness and tests
_REGISTRY: dict[str, type] = {}

#: the active runtime witness (see :mod:`repro.analysis.witness`); the
#: decorated ``__init__`` wrappers consult it once per construction
_witness: Any = None


def registered_classes() -> dict[str, type]:
    """All annotation-decorated classes by name (a copy)."""
    return dict(_REGISTRY)


def lock_rank(class_name: str) -> int:
    """Rank of ``class_name`` in :data:`LOCK_ORDER` (lower = outer)."""
    return LOCK_ORDER.index(class_name)


def _set_witness(witness: Any) -> None:
    """Called by :mod:`repro.analysis.witness` on install/uninstall."""
    global _witness
    _witness = witness


def guarded_by(*fields: str, lock: str = "_lock",
               ) -> Callable[[type], type]:
    """Declare the fields of a lock-owning class and its lock attribute.

    The class must appear in :data:`LOCK_ORDER` — an unlisted lock owner
    is a hard error at import time, which is what keeps the declared
    hierarchy complete.  When a runtime witness is installed, each new
    instance's lock is replaced by an instrumented wrapper right after
    ``__init__`` returns (zero overhead otherwise: one module-global
    ``None`` check per construction).
    """
    def deco(cls: type) -> type:
        if cls.__name__ not in LOCK_ORDER:
            raise ValueError(
                f"{cls.__name__} owns a lock but is not declared in "
                f"analysis.annotations.LOCK_ORDER")
        cls.__guarded_fields__ = tuple(fields)
        cls.__lock_attr__ = lock
        cls.__lock_rank__ = LOCK_ORDER.index(cls.__name__)
        _REGISTRY[cls.__name__] = cls
        inner_init = cls.__init__

        @functools.wraps(inner_init)
        def __init__(self, *args: Any, **kwargs: Any) -> None:
            inner_init(self, *args, **kwargs)
            if _witness is not None:
                _witness.instrument(self, lock, cls.__lock_rank__,
                                    cls.__name__)

        cls.__init__ = __init__
        return cls
    return deco


def lock_free(cls: type) -> type:
    """Declare that ``cls`` acquires no lock of its own, ever.

    The static pass walks the class's methods (transitively through
    ``self._helper()`` calls) and flags any lock acquisition or
    threading-primitive construction it can reach; calls into
    ``@guarded_by``-declared collaborators (whose locks are ranked and
    witness-checked) are allowed.
    """
    cls.__lock_free__ = True
    _REGISTRY[cls.__name__] = cls
    return cls


def single_writer(*fields: str) -> Callable[[type], type]:
    """Declare fields mutated by exactly one thread and read lock-free.

    The class owns no lock; the static pass verifies it acquires none
    and that only the declared fields are mutated outside ``__init__``.
    """
    def deco(cls: type) -> type:
        cls.__single_writer_fields__ = tuple(fields)
        _REGISTRY[cls.__name__] = cls
        return cls
    return deco
