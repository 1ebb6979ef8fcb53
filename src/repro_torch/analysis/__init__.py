"""Concurrency & determinism analyzer for the governor stack.

Three layers, one convention:

* :mod:`repro.analysis.annotations` — the ``@guarded_by`` /
  ``@lock_free`` / ``@single_writer`` decorators and the global
  :data:`~repro.analysis.annotations.LOCK_ORDER` hierarchy that every
  lock-owning class in the runtime declares itself against.
* the static passes (:mod:`repro.analysis.lockcheck`,
  :mod:`repro.analysis.determinism`) — AST-only, import nothing from the
  runtime, and run as ``python -m repro.analysis`` (a required CI job).
* :mod:`repro.analysis.witness` — a debug-mode runtime shim that wraps
  the declared locks, records the acquisition orders the threaded test
  suite *actually* produces, and cross-checks them against the declared
  hierarchy.

This ``__init__`` stays import-light (stdlib only, no AST machinery) so
annotating a core class costs one decorator call at import time.
"""

from .annotations import (LOCK_ORDER, guarded_by, lock_free,
                          registered_classes, single_writer)
from .witness import (LockOrderWitness, active_witness, install_witness,
                      uninstall_witness, witness_paused)

__all__ = [
    "LOCK_ORDER",
    "guarded_by",
    "lock_free",
    "single_writer",
    "registered_classes",
    "LockOrderWitness",
    "active_witness",
    "install_witness",
    "uninstall_witness",
    "witness_paused",
]
