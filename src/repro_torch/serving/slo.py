"""Per-request SLO classes: deadlines, priorities, retry/hedge budgets.

An :class:`SLOClass` is the contract a request arrives with — how long
the client will wait (``deadline_s``), how it ranks against other
classes under overload (``priority``), and what the serving stack may
do on its behalf when an attempt stalls: time it out after
``timeout_s``, re-release it up to ``retry_budget`` times with
exponential backoff + jitter, and (for the latency-critical tail)
issue a hedged duplicate after ``hedge_after_s``.  ``best_effort``
classes additionally consent to brownout: under an active power cap
the engine may truncate their ``max_new_tokens`` instead of shedding
them.

The class is immutable and JSON-serializable, so a recorded serving
trace carries each request's full SLO contract and replays byte-
exactly.  Backoff jitter follows the repo's seeded wall-clock-free
discipline: a fresh ``random.Random`` keyed on
``(seed, request_id, attempt)`` per call, so the jitter of one request
never depends on how many other requests drew before it.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Mapping

__all__ = ["SLOClass", "INTERACTIVE", "STANDARD", "BATCH"]


@dataclass(frozen=True, slots=True)
class SLOClass:
    """One service-level contract shared by every request of a class."""

    name: str
    #: end-to-end latency bound in seconds (None = no deadline; the
    #: request is attained iff it completes at all)
    deadline_s: float | None = None
    #: admission rank under overload — higher wins a full queue
    priority: int = 0
    #: per-attempt timeout (None falls back to ``deadline_s``; both
    #: None = attempts never time out)
    timeout_s: float | None = None
    #: how many timed-out attempts may be re-released
    retry_budget: int = 0
    #: first-retry backoff; doubles per attempt
    backoff_base_s: float = 0.05
    #: ± fraction of the backoff drawn as seeded jitter
    backoff_jitter: float = 0.25
    #: issue a hedged duplicate if an attempt is still running after
    #: this many seconds (None = never hedge)
    hedge_after_s: float | None = None
    #: consents to brownout (``max_new_tokens`` truncation) under an
    #: active power cap instead of being shed
    best_effort: bool = False

    def __post_init__(self) -> None:
        if self.deadline_s is not None and self.deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.timeout_s is not None and self.timeout_s <= 0.0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if self.backoff_base_s < 0.0:
            raise ValueError("backoff_base_s must be >= 0")
        if not 0.0 <= self.backoff_jitter < 1.0:
            raise ValueError("backoff_jitter must be in [0, 1)")
        if self.hedge_after_s is not None and self.hedge_after_s <= 0.0:
            raise ValueError("hedge_after_s must be > 0")

    @property
    def attempt_timeout_s(self) -> float | None:
        """Effective per-attempt timeout (falls back to the deadline)."""
        return self.timeout_s if self.timeout_s is not None \
            else self.deadline_s

    def backoff(self, attempt: int, *, seed: int = 0,
                request_id: int = 0) -> float:
        """Seconds to wait before re-releasing the ``attempt``-th try
        (attempt 1 = first retry): exponential base with seeded jitter.

        Deterministic and order-independent — keyed on
        ``(seed, request_id, attempt)``, not on a shared PRNG stream —
        so concurrent requests retry at reproducible instants
        regardless of interleaving (the property the byte-exact
        serving replay relies on).
        """
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        base = self.backoff_base_s * (2.0 ** (attempt - 1))
        if self.backoff_jitter == 0.0 or base == 0.0:
            return base
        # str seeding hashes via sha512 — stable across processes and
        # Python versions, unlike (deprecated) tuple seeding
        rng = random.Random(f"{seed}:{request_id}:{attempt}")
        return base * rng.uniform(1.0 - self.backoff_jitter,
                                  1.0 + self.backoff_jitter)

    # -- serialization (trace round trip) -----------------------------------

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name}
        if self.deadline_s is not None:
            d["deadline_s"] = self.deadline_s
        if self.priority:
            d["priority"] = self.priority
        if self.timeout_s is not None:
            d["timeout_s"] = self.timeout_s
        if self.retry_budget:
            d["retry_budget"] = self.retry_budget
        if self.backoff_base_s != 0.05:
            d["backoff_base_s"] = self.backoff_base_s
        if self.backoff_jitter != 0.25:
            d["backoff_jitter"] = self.backoff_jitter
        if self.hedge_after_s is not None:
            d["hedge_after_s"] = self.hedge_after_s
        if self.best_effort:
            d["best_effort"] = True
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SLOClass":
        return cls(**dict(d))


#: latency-critical traffic: tight deadline, top priority, one retry,
#: hedged tail
INTERACTIVE = SLOClass("interactive", deadline_s=3.0, priority=2,
                       timeout_s=1.5, retry_budget=1, hedge_after_s=1.0)

#: default traffic: looser deadline, one retry, no hedging
STANDARD = SLOClass("standard", deadline_s=10.0, priority=1,
                    timeout_s=5.0, retry_budget=1)

#: throughput traffic: no deadline, lowest priority, browns out under
#: a power cap instead of being shed
BATCH = SLOClass("batch", best_effort=True)
