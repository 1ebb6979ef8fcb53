"""No-op stand-ins for the concurrency annotations of the reference
package (``@guarded_by``, ``@lock_free``, ``@single_writer``).

The copied core modules keep their decorators so that they read line for
line like the originals; here each decorator returns the class as it
is.  The port has no static analyzer or runtime lock witness of its own.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["guarded_by", "lock_free", "single_writer"]


def guarded_by(*fields: str, lock: str = "_lock") -> Callable[[type], type]:
    return lock_free


def lock_free(cls: type) -> type:
    return cls


def single_writer(*fields: str) -> Callable[[type], type]:
    return lock_free
