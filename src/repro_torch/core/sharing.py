"""Resource sharing between co-located runtimes (paper §2 "Resource
Sharing", §3.3, Table 3) — a DLB/LeWI-style broker plus the three sharing
strategies evaluated by the paper:

* **LeWI** — *Lend When Idle*: a worker that polls and finds nothing lends
  its CPU immediately; when tasks are added, threads eagerly call the
  broker to get CPUs back, one call per thread.  Extremely reactive; the
  paper measures ~4M broker calls in a 100 s run.
* **Hybrid** — like LeWI but a worker spins for ``spin_budget`` (paper:
  100) consecutive empty polls before lending.
* **Prediction** — the paper's contribution (§3.3): lend only when the
  predictor says the CPU will not be needed (``δ > Δ``), and make a
  *single* broker call per prediction tick to acquire ``Δ − δ`` CPUs,
  instead of per-thread eager calls.  The predictor runs with
  ``allow_oversubscription=True`` because DLB may provide more CPUs than
  the runtime owns.

Every :meth:`ResourceBroker.lend` / :meth:`ResourceBroker.acquire` /
:meth:`ResourceBroker.reclaim` invocation that actually reaches the broker
increments the per-job *DLB call* counter — the cost metric of paper
Table 3.  An ``acquire`` with ``max_n <= 0`` never leaves the caller (no
DLB library call would be issued), so it is not counted.

Multiprogramming (N ≥ 2 jobs): foreign CPUs are rationed with a
least-recently-served reservation — a claimant whose last acquisition
came up short registers its unmet demand, and better-served claimants
must leave that many foreign CPUs in the pool.  Without it, whichever
borrower's tick happens to fire first drains the pool every round and
can starve a third job indefinitely.

On heterogeneous machines the broker can be taught each CPU's core type
(:meth:`ResourceBroker.set_core_type_of`): the pool is then accountable
per type (:meth:`pool_by_type`) and ``acquire`` accepts a ``core_type``
filter, so a P-core lent is never silently handed back as an E-core
grant.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable

from ..analysis import guarded_by
from .policies import Policy, PollDecision
from .prediction import CPUPredictor

__all__ = [
    "ResourceBroker",
    "SharingPolicy",
    "LeWIPolicy",
    "DLBHybridPolicy",
    "DLBPredictionPolicy",
]


@dataclass
class _JobAccount:
    name: str
    owned: set[int] = field(default_factory=set)    # CPUs this job owns
    lent: set[int] = field(default_factory=set)     # owned, now in the pool/borrowed
    borrowed: set[int] = field(default_factory=set)  # others' CPUs we run on
    calls: int = 0                                   # DLB call counter
    reclaim_wanted: bool = False
    #: unmet demand from the last acquire (foreign-claimant fairness):
    #: while > 0, better-served claimants leave this many CPUs in the pool
    waiting: int = 0
    #: monotonic stamp of the last *foreign* CPU grant; 0 = never served
    last_served: int = 0


@guarded_by("_jobs", "_pool", "_owner", "_holder", "_return_flags",
            "total_calls", "_failed")
class ResourceBroker:
    """The DLB stand-in: a pool of lent CPUs shared between jobs.

    Reclaim semantics: an owner may flag a reclaim; borrowed CPUs are
    returned cooperatively at the borrower's next task boundary (the
    executor calls :meth:`cpu_must_return` to learn this).
    """

    def __init__(self, core_type_of: Callable[[int], str] | None = None,
                 ) -> None:
        self._lock = threading.Lock()
        self._jobs: dict[str, _JobAccount] = {}
        self._pool: list[int] = []          # lent, unborrowed CPUs
        self._owner: dict[int, str] = {}    # cpu -> owning job
        self._holder: dict[int, str] = {}   # cpu -> job currently running on it
        self._return_flags: set[int] = set()
        self._type_of = core_type_of
        self._serve_stamp = itertools.count(1)
        self.total_calls = 0
        # Failed cores (machine conditions): a dict used as an ordered
        # set — failed CPUs are pulled from the pool, refused by lend/
        # acquire, and their loan accounting erased until recovery.
        self._failed: dict[int, bool] = {}

    # -- registration --------------------------------------------------------

    def register_job(self, name: str, cpus: list[int]) -> None:
        with self._lock:
            acct = _JobAccount(name=name, owned=set(cpus))
            self._jobs[name] = acct
            for c in cpus:
                self._owner[c] = name
                self._holder[c] = name

    def set_core_type_of(self, fn: Callable[[int], str] | None) -> None:
        """Teach the broker each CPU's core type (heterogeneous machines)
        so pool accounting and ``acquire(core_type=...)`` filters work
        per type.  ``None`` reverts to untyped (homogeneous) mode."""
        with self._lock:
            self._type_of = fn

    @property
    def typed(self) -> bool:
        """True when the broker knows core types (see
        :meth:`set_core_type_of`)."""
        return self._type_of is not None

    def _ct(self, cpu: int) -> str:
        return self._type_of(cpu) if self._type_of is not None else ""

    def job_calls(self, name: str) -> int:
        with self._lock:
            return self._jobs[name].calls

    def pool_size(self, core_type: str | None = None) -> int:
        with self._lock:
            if core_type is None:
                return len(self._pool)
            return sum(1 for c in self._pool if self._ct(c) == core_type)

    def pool_rejected(self, where: Callable[[int], bool]) -> int:
        """How many pooled CPUs fail the ``where`` predicate right now —
        arbiters use it to attribute a short locality-guarded grant to
        the guard (vs. a genuinely empty pool).  Shared-memory peek, not
        a DLB call."""
        with self._lock:
            return sum(1 for c in self._pool if not where(c))

    def reassign_core(self, job: str, old: int, new: int) -> None:
        """Whole-app migration moved ``job`` off owned CPU ``old`` onto
        free CPU ``new``: transfer ownership/holder accounting so later
        lend/acquire verbs see the post-migration layout.  ``old`` must
        be owned, held and unlent by ``job`` (the simulator refuses to
        migrate borrowed or lent cores) and ``new`` unclaimed."""
        with self._lock:
            acct = self._jobs[job]
            if old not in acct.owned or old in acct.lent:
                raise ValueError(
                    f"cannot reassign cpu {old}: not an unlent core "
                    f"owned by {job!r}")
            if self._owner.get(new) is not None:
                raise ValueError(
                    f"cannot reassign onto cpu {new}: owned by "
                    f"{self._owner[new]!r}")
            acct.owned.discard(old)
            acct.owned.add(new)
            del self._owner[old]
            del self._holder[old]
            self._owner[new] = job
            self._holder[new] = job

    def pool_by_type(self) -> dict[str, int]:
        """Pool composition per core type ({""; n} when untyped)."""
        with self._lock:
            out: dict[str, int] = {}
            for c in self._pool:
                ct = self._ct(c)
                out[ct] = out.get(ct, 0) + 1
            return out

    # -- machine conditions ----------------------------------------------------

    def fail_core(self, cpu: int) -> str:
        """``cpu`` died: pull it from the pool, erase any loan
        accounting, and refuse to lend/grant it until
        :meth:`recover_core`.  Returns the job that was holding it
        (``""`` if it sat in the pool) so the caller can tear down the
        right worker.  Shared-memory bookkeeping, not a DLB call —
        hardware does not bill you for breaking."""
        with self._lock:
            self._failed[cpu] = True
            owner = self._owner.get(cpu)
            if owner is None:
                return ""
            held_by = self._holder.get(cpu, owner)
            if cpu in self._pool:
                self._pool.remove(cpu)
            owner_acct = self._jobs[owner]
            owner_acct.lent.discard(cpu)
            self._return_flags.discard(cpu)
            owner_acct.reclaim_wanted = bool(
                self._return_flags & owner_acct.lent)
            if held_by and held_by != owner:
                self._jobs[held_by].borrowed.discard(cpu)
            # Park the dead core on its owner's books so recovery
            # restores the pre-failure ownership layout.
            self._holder[cpu] = owner
            return held_by

    def recover_core(self, cpu: int) -> str:
        """A failed ``cpu`` came back; it rejoins its owner directly
        (never through the pool — the owner decides whether to lend
        it).  Returns the owning job name (``""`` if unregistered)."""
        with self._lock:
            self._failed.pop(cpu, None)
            owner = self._owner.get(cpu)
            if owner is None:
                return ""
            self._holder[cpu] = owner
            return owner

    def is_failed(self, cpu: int) -> bool:
        with self._lock:
            return cpu in self._failed

    # -- the three DLB verbs ---------------------------------------------------

    def lend(self, job: str, cpu: int) -> str:
        """Job ``job`` lends ``cpu`` into the pool (1 DLB call).

        Returns the new holder: the owner's name when a reclaim was
        pending (direct hand-over), else ``""`` (parked in the pool).
        A failed CPU is refused outright (uncounted — the call would
        never reach the library on dead silicon).
        """
        with self._lock:
            if self._failed and cpu in self._failed:
                return ""
            acct = self._jobs[job]
            acct.calls += 1
            self.total_calls += 1
            # Lending is a surplus signal: any outstanding unmet demand
            # this job registered is stale, so stop reserving for it.
            acct.waiting = 0
            if cpu in acct.borrowed:
                # Returning someone else's CPU.
                acct.borrowed.discard(cpu)
                owner = self._owner[cpu]
                owner_acct = self._jobs[owner]
                owner_acct.lent.discard(cpu)
                self._return_flags.discard(cpu)
                if owner_acct.reclaim_wanted:
                    # Owner asked for CPUs back: hand it straight over.
                    self._holder[cpu] = owner
                    owner_acct.reclaim_wanted = bool(
                        self._return_flags & owner_acct.lent)
                    return owner
                owner_acct.lent.add(cpu)
                self._holder[cpu] = ""
                self._pool.append(cpu)
                return ""
            if cpu not in acct.owned or cpu in acct.lent:
                return ""
            acct.lent.add(cpu)
            self._holder[cpu] = ""
            self._pool.append(cpu)
            self._return_flags.discard(cpu)
            return ""

    def acquire(self, job: str, max_n: int,
                core_type: str | None = None,
                where: Callable[[int], bool] | None = None,
                prefer: Callable[[int], float] | None = None) -> list[int]:
        """Job asks the broker for up to ``max_n`` CPUs (1 DLB call).

        ``max_n <= 0`` is a caller-side no-op: it returns immediately and
        is NOT counted as a DLB call (it would never reach the library),
        so Table-3 cost metrics only count real broker traffic.

        ``core_type`` restricts the grant to CPUs of that type (typed
        brokers only — see :meth:`set_core_type_of`).

        ``where``/``prefer`` make the verb locality-aware on multi-node
        clusters (the acquire carries a domain): ``where`` filters
        *foreign* CPUs (own cores always pass — reclaiming your own is
        never a remote borrow) and ``prefer`` sorts the eligible
        foreign CPUs (stable) by a key such as home-node distance, so
        near cores are granted — and far ones left for the fairness
        reservation — first.  Both default to off (single-node runs
        keep pool FIFO order bit-for-bit).

        Preference order: the job's own lent CPUs first (cheap reclaim),
        then foreign CPUs in pool (FIFO) order — minus a reservation for
        less-recently-served claimants with outstanding unmet demand, the
        round-robin discipline that stops one borrower from draining the
        pool ahead of a starving third job every round.
        """
        if max_n <= 0:
            return []
        with self._lock:
            acct = self._jobs[job]
            acct.calls += 1
            self.total_calls += 1
            got: list[int] = []
            own: list[int] = []
            foreign: list[int] = []
            for c in self._pool:
                if self._failed and c in self._failed:
                    continue   # defensive: fail_core() drains the pool
                if core_type is not None and self._ct(c) != core_type:
                    continue
                if self._owner[c] == job:
                    own.append(c)
                elif where is None or where(c):
                    foreign.append(c)
            if prefer is not None:
                foreign.sort(key=prefer)
            # Foreign-claimant fairness: demand registered by claimants
            # served less recently than us stays in the pool.
            reserved = sum(a.waiting for n, a in self._jobs.items()
                           if n != job and a.waiting > 0
                           and a.last_served < acct.last_served)
            foreign = foreign[:max(0, len(foreign) - reserved)]
            for cpu in own + foreign:
                if len(got) >= max_n:
                    break
                self._pool.remove(cpu)
                self._holder[cpu] = job
                if self._owner[cpu] == job:
                    acct.lent.discard(cpu)
                else:
                    acct.borrowed.add(cpu)
                got.append(cpu)
            if any(self._owner[c] != job for c in got):
                acct.last_served = next(self._serve_stamp)
            acct.waiting = max_n - len(got)
            return got

    def reclaim(self, job: str) -> list[int]:
        """Owner wants its lent CPUs back (1 DLB call).

        CPUs sitting in the pool return immediately; borrowed ones are
        flagged and come back at the borrower's next task boundary.
        """
        with self._lock:
            acct = self._jobs[job]
            acct.calls += 1
            self.total_calls += 1
            back: list[int] = []
            for cpu in list(acct.lent):
                if cpu in self._pool:
                    self._pool.remove(cpu)
                    acct.lent.discard(cpu)
                    self._holder[cpu] = job
                    back.append(cpu)
                else:
                    self._return_flags.add(cpu)
            acct.reclaim_wanted = bool(self._return_flags & acct.lent)
            return back

    # -- cooperative return ----------------------------------------------------

    def cpu_must_return(self, cpu: int) -> bool:
        with self._lock:
            return cpu in self._return_flags

    def reclaim_pending(self, job: str) -> bool:
        """True while an earlier :meth:`reclaim` still has return flags
        outstanding — re-issuing the reclaim would set no new flag, so
        arbiters use this to avoid paying for redundant DLB calls."""
        with self._lock:
            return self._jobs[job].reclaim_wanted

    def register_demand(self, job: str, n: int) -> None:
        """Record ``job``'s current unmet CPU demand for the
        foreign-claimant fairness reservation *without* a DLB call — in
        a real DLB deployment this is a shared-memory counter write, not
        a library round-trip.  Arbiters call it when the cheap free-CPU
        peek suppresses an acquisition (a starved app would otherwise
        never register the claim that reserves CPUs for it) and with 0
        when the app's demand evaporates (done, or satisfied through a
        reclaim), so stale reservations cannot park pooled CPUs."""
        with self._lock:
            self._jobs[job].waiting = max(0, n)

    def return_cpu(self, borrower: str, cpu: int) -> str:
        """Borrower hands a flagged CPU back; returns the owner job name."""
        with self._lock:
            owner = self._owner[cpu]
            owner_acct = self._jobs[owner]
            self._jobs[borrower].borrowed.discard(cpu)
            owner_acct.lent.discard(cpu)
            self._holder[cpu] = owner
            self._return_flags.discard(cpu)
            # The reclaim stays wanted while *other* lent CPUs still have
            # pending return flags (same recomputation as lend()) — a
            # blanket False silently dropped multi-CPU reclaims.
            owner_acct.reclaim_wanted = bool(
                self._return_flags & owner_acct.lent)
            return owner

    def holder(self, cpu: int) -> str:
        with self._lock:
            return self._holder[cpu]

    def lent_out(self, job: str, core_type: str | None = None) -> int:
        """How many of ``job``'s owned CPUs another job is running on."""
        with self._lock:
            return sum(1 for c in self._jobs[job].lent
                       if self._holder.get(c) not in ("", job)
                       and (core_type is None or self._ct(c) == core_type))


# ---------------------------------------------------------------------------
# Sharing policies: what a worker does on an empty poll in DLB mode.
# ---------------------------------------------------------------------------


class SharingPolicy(Policy):
    """Base for DLB-mode policies: empty polls may LEND the CPU away.

    ``acquire_on_add``: how many broker CPUs to request when tasks arrive
    (None ⇒ eager per-thread acquisition, the LeWI way).
    """

    eager_acquire = True

    def workers_to_resume(self, active: int, idle: int, ready_tasks: int,
                          ) -> int:
        # DLB mode: nothing sleeps locally — CPUs are lent, not idled.
        return min(idle, max(0, ready_tasks - active))

    def acquire_target(self, active: int, ready_tasks: int) -> int:
        """How many CPUs to request from the broker right now."""
        return max(0, ready_tasks - active)


class LeWIPolicy(SharingPolicy):
    """Lend When Idle — lend on the *first* empty poll."""

    name = "dlb-lewi"

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        return PollDecision.LEND


class DLBHybridPolicy(SharingPolicy):
    """Spin ``spin_budget`` empty polls (paper: 100) before lending."""

    name = "dlb-hybrid"

    def __init__(self, spin_budget: int = 100) -> None:
        self.spin_budget = spin_budget

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        if spin_count < self.spin_budget:
            return PollDecision.SPIN
        return PollDecision.LEND


class DLBPredictionPolicy(SharingPolicy):
    """Paper §3.3 — predictions drive both lending and acquisition.

    Lending: only when ``δ > Δ`` (this CPU is predicted surplus).
    Acquisition: *not* eager — a single broker call per prediction tick
    requests ``Δ − δ`` CPUs (``Δ`` may exceed the owned count because the
    predictor allows oversubscription in DLB mode).
    """

    name = "dlb-prediction"
    uses_predictions = True
    eager_acquire = False

    def __init__(self, predictor: CPUPredictor) -> None:
        self.predictor = predictor

    def on_poll_empty(self, worker_id: int, active: int, spin_count: int,
                      ) -> PollDecision:
        if active > self.predictor.delta:
            return PollDecision.LEND
        return PollDecision.SPIN

    def on_prediction_tick(self) -> None:
        self.predictor.tick()

    def acquire_target(self, active: int, ready_tasks: int) -> int:
        return max(0, self.predictor.delta - active)
