"""Discrete-event serving simulator — overload robustness at 10⁵-request
scale.

The live :class:`~repro.serving.engine.ServingEngine` decodes real
tokens, so an overload study on it is bounded by wall clock.  This
module is the serving twin of :mod:`repro.runtime.sim`: request service
is *modelled* (prefill + decode token rates on a
:class:`~repro.runtime.machine.MachineModel`), time is virtual, and the
whole SLO/robustness surface runs in one thread with the simulator's
flattened-heap idioms (``(t, seq, kind, a, b)`` tuples, int event kinds,
epoch guards for stale-event cancellation) — 10⁵ requests in seconds.

What it exercises, end to end:

* **SLO classes** (:mod:`repro.serving.slo`): priority-ordered
  admission, deadline shedding, per-attempt timeouts with seeded
  exponential-backoff retries, and hedged duplicates for the
  latency-critical tail (first completion wins, the loser is
  cancelled).
* **Overload protection** (:mod:`repro.serving.admission`): an
  :class:`AdmissionController` sheds at arrival on queue depth and
  deadline infeasibility (estimated wait comes from the live queue's
  predicted work — the prediction stack deciding *what not to serve*);
  a per-replica :class:`CircuitBreaker` quarantines a failing replica
  and re-admits it through half-open probes.
* **Graceful degradation** under live
  :class:`~repro.core.conditions.MachineConditions`: an active power
  cap shrinks the hot-replica allowance (:func:`cap_allowance`,
  worst-case draw, so a protected run logs **zero** cap-violation
  seconds) and *brownouts* best-effort requests (``max_new_tokens``
  truncation) instead of shedding them; core failures tear attempts off
  the replica and requeue them *uncharged* (no retry-budget debit).
* **Prediction-based autoscaling**: the same
  :class:`~repro.serving.autoscale.AutoScaler` stack (Algorithm 1 over
  per-class request costs) decides how many replicas stay hot; replicas
  park to the idle power floor and pay ``spinup_s`` to come back.

Every decision is deterministic given (requests, timeline, seed):
arrival processes and SLO backoff are seeded, there is no wall clock,
and the published event stream (TASK_* lifecycle plus
SHED/RETRY/HEDGE/DEGRADE/PERTURBATION/PREDICTION) carries enough data
for :func:`replay_serving` to rebuild and re-run the scenario
byte-exactly from a recorded trace.
"""

from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Iterable, Sequence

from ..core.conditions import ConditionTimeline, MachineConditions, \
    PerturbationKind
from ..core.energy import CoreState, EnergyMeter, PowerModel
from ..core.events import EventBus, EventKind, RuntimeEvent
from ..core.governor import GovernorReport
from ..core.monitoring import TaskMonitor
from ..runtime.machine import MachineModel
from ..workloads.arrivals import ArrivalProcess
from .admission import AdmissionController, CircuitBreaker, cap_allowance
from .autoscale import AutoScaler
from .slo import BATCH, INTERACTIVE, STANDARD, SLOClass

__all__ = ["ServingModel", "SimRequest", "build_requests", "SimServing",
           "replay_serving"]


# ---------------------------------------------------------------------------
# Service model + workload
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingModel:
    """Cost model for one simulated serving deployment.

    Each core of ``machine`` hosts one engine replica with
    ``slots_per_replica`` concurrent request slots (continuous-batching
    capacity).  A request of ``prompt`` input tokens and ``new`` output
    tokens costs ``prompt/prefill_rate + new/decode_rate`` reference
    seconds, then dilates through the machine's per-core speed, the
    thermal frequency cap and any straggler slowdown — exactly the
    :meth:`MachineModel.service_time` contract the task simulator uses.
    """

    machine: MachineModel
    slots_per_replica: int = 4
    prefill_rate: float = 4000.0   # prompt tokens / reference second
    decode_rate: float = 160.0     # new tokens / reference second
    spinup_s: float = 0.05         # parked → serving (model/cache warmup)

    def __post_init__(self) -> None:
        if self.slots_per_replica < 1:
            raise ValueError("slots_per_replica must be >= 1")
        if self.prefill_rate <= 0 or self.decode_rate <= 0:
            raise ValueError("token rates must be > 0")
        if self.spinup_s < 0:
            raise ValueError("spinup_s must be >= 0")

    @property
    def n_replicas(self) -> int:
        return self.machine.n_cores

    def base_seconds(self, prompt: int, new: int) -> float:
        """Reference-core service seconds for one attempt."""
        return prompt / self.prefill_rate + new / self.decode_rate


@dataclass(slots=True)
class SimRequest:
    """One simulated request and its eventual fate."""

    rid: int
    release: float
    prompt: int
    new: int
    slo: SLOClass | None = None
    #: "completed" | "shed" | "timed_out" (None while live)
    outcome: str | None = None
    done_at: float | None = None
    tries: int = 1
    tokens_out: int = 0
    # Filled by SimServing at setup (derived, not part of the workload):
    type_name: str = ""
    cost: float = 0.0
    est_s: float = 0.0


#: default traffic mix (class, weight): half standard, a quarter each of
#: interactive and batch — the shape of a user-facing service with a
#: background analytics tail
DEFAULT_MIX: tuple[tuple[SLOClass, float], ...] = (
    (INTERACTIVE, 1.0), (STANDARD, 2.0), (BATCH, 1.0))


def build_requests(process: ArrivalProcess, n: int, *,
                   mix: Sequence[tuple[SLOClass, float]] = DEFAULT_MIX,
                   prompt_range: tuple[int, int] = (16, 256),
                   new_range: tuple[int, int] = (16, 128),
                   seed: int = 0) -> list[SimRequest]:
    """``n`` seeded requests released by ``process``: SLO classes drawn
    from the weighted ``mix``, token counts uniform over the ranges.
    Fresh ``random.Random(seed)`` per call (arrivals.py discipline)."""
    rng = random.Random(seed)
    times = process.times(n)
    classes = [s for s, _ in mix]
    weights = [w for _, w in mix]
    slos = rng.choices(classes, weights=weights, k=n)
    p_lo, p_hi = prompt_range
    n_lo, n_hi = new_range
    return [SimRequest(rid=i, release=times[i],
                       prompt=rng.randint(p_lo, p_hi),
                       new=rng.randint(n_lo, n_hi), slo=slos[i])
            for i in range(n)]


# ---------------------------------------------------------------------------
# The discrete-event serving frontend
# ---------------------------------------------------------------------------

# Flattened heap entries (t, seq, kind, a, b) with int kinds — the
# PR-5 sim hot-path idiom (tuple compare never reaches `kind`; `seq` is
# unique per push).
_ARRIVE, _FINISH, _TIMEOUT, _RETRY, _HEDGE, _SCALE, _WARM, _PERT = range(8)


class SimServing:
    """Virtual-time serving frontend over a :class:`ServingModel`.

    Parameters
    ----------
    model, requests:
        The deployment cost model and the (release-sorted) workload.
    policy:
        Autoscaler policy name (``prediction`` / ``idle`` / ``busy`` /
        any registered policy) — slots are the governed resource.
    rate_s:
        Prediction tick period *and* Algorithm 1's planning horizon
        (clear the outstanding predicted work within ``rate_s``).
    protection:
        Master switch for the overload-protection layer: admission
        control, SLO-priority queue ordering, dead-request reaping at
        dispatch, hedging, circuit breakers, power-cap enforcement and
        brownout.  SLO timeouts/retries are the *client's* contract and
        stay active either way — ``protection=False`` is the
        "unprotected reactive baseline" of the benchmarks: a FIFO
        server that burns slots on requests whose deadline is already
        lost.
    admission:
        Override the default :class:`AdmissionController` (queue bound
        ``queue_factor × total slots``); ignored when protection is off.
    conditions:
        A :class:`ConditionTimeline` of machine perturbations.
    brownout_tokens:
        ``max_new_tokens`` ceiling applied to best-effort requests while
        a power cap is active (None disables brownout).
    bus:
        Event bus for trace recording; quiet buses cost nothing.
    """

    def __init__(self, model: ServingModel,
                 requests: Iterable[SimRequest], *,
                 policy: str = "prediction",
                 rate_s: float = 0.5,
                 min_replicas: int = 1,
                 protection: bool = True,
                 admission: AdmissionController | None = None,
                 queue_factor: int = 4,
                 conditions: ConditionTimeline | None = None,
                 brownout_tokens: int | None = 16,
                 breaker_failures: int = 3,
                 breaker_reset_s: float = 0.5,
                 breaker_probes: int = 2,
                 bus: EventBus | None = None,
                 seed: int = 0) -> None:
        self.model = model
        self.machine = model.machine
        self.protection = protection
        self.brownout_tokens = brownout_tokens
        self.seed = seed
        self.bus = bus if bus is not None else EventBus()

        reqs = sorted(requests, key=lambda r: (r.release, r.rid))
        self._reqs: dict[int, SimRequest] = {r.rid: r for r in reqs}
        if len(self._reqs) != len(reqs):
            raise ValueError("duplicate request ids")
        self._n = len(reqs)

        spr = model.slots_per_replica
        n_rep = model.n_replicas
        self.slots_total = n_rep * spr
        topo = self.machine.topology()
        self._typed = self.machine.core_types is not None
        # Replica state (lists indexed by replica id — never sets, the
        # determinism lint covers this package).
        self._ctype = [topo.core_type_at(r).name for r in range(n_rep)]
        self._power = [topo.core_type_at(r).power or PowerModel()
                       for r in range(n_rep)]
        self._hot = [True] * n_rep       # serving (or warming) now
        self._warming = [False] * n_rep
        self._wepoch = [0] * n_rep
        self._failed = [False] * n_rep
        self._busy = [0] * n_rep         # attempts in flight per replica
        # Dispatch/wake order: fastest silicon first, id as tie-break.
        self._order = sorted(range(n_rep),
                             key=lambda r: (-self.machine.speed_of(r), r))
        self._nhot = n_rep

        self._conditions = MachineConditions(conditions)
        self._meter = EnergyMeter(0)
        for r in range(n_rep):
            self._meter.add_core(r, CoreState.SPIN, 0.0,
                                 power=self._power[r],
                                 core_type=self._ctype[r]
                                 if self._typed else "")

        self.monitor = TaskMonitor()
        self.monitor.mark_direct_driven(self.bus)
        self.scaler = AutoScaler(self.monitor, max_replicas=self.slots_total,
                                 policy=policy,
                                 min_replicas=min_replicas * spr,
                                 rate_s=rate_s)
        self._breakers = ([CircuitBreaker(breaker_failures, breaker_reset_s,
                                          breaker_probes)
                           for _ in range(n_rep)] if protection else None)
        if protection and admission is None:
            admission = AdmissionController(
                max_queue_depth=queue_factor * self.slots_total)
        self._admission = admission if protection else None

        # Event heap + priority queue (lazy staleness on both).
        self._heap: list[tuple] = []
        self._seq = itertools.count()
        self._aids = itertools.count()
        self._q: list[tuple[int, int, int]] = []      # (-pri, seq, rid)
        self._vq: list[tuple[int, int, int]] = []     # (pri, -seq, rid)
        self._inq: dict[int, tuple[int, int]] = {}    # rid -> (pri, seq)
        self._qdepth = 0
        self._qwork = 0.0
        self._qwork_by_pri: dict[int, float] = {}
        # Attempt registry: aid -> (rid, replica, served_new, t_start,
        # hedge?, freq); popping an aid IS the cancellation.
        self._att: dict[int, tuple[int, int, int, float, bool, float]] = {}
        self._rid_att: dict[int, list[int]] = {}
        self._tepoch: dict[int, int] = {}
        self._active = 0
        self._sleeping = 0     # requests waiting out a retry backoff

        self._now = 0.0
        self._done = 0
        self._completed = 0
        self._idles = 0
        self._retries = 0
        self._requeues = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._degrades = 0
        self._shed_by_reason: dict[str, int] = {}
        self._cap_active = False
        self._allowance: int | None = None
        self._stall = 0
        self._stall_done = -1
        self._finished = False

        fastest = self._order[0]
        for req in reqs:
            req.type_name = (f"request:{req.slo.name}" if req.slo
                             else "request")
            req.cost = float(req.prompt + req.new)
            req.est_s = self.machine.service_time(
                model.base_seconds(req.prompt, req.new), core=fastest)
            self._tepoch[req.rid] = 0

        # Seed the heap: first scale tick, then the perturbation
        # timeline, then arrivals (seq breaks same-time ties in this
        # order — control plane before data plane at t=0).
        self._push(0.0, _SCALE, 0, 0)
        for i, p in enumerate(self._conditions.timeline):
            self._push(p.time, _PERT, i, 0)
        for req in reqs:
            self._push(req.release, _ARRIVE, req.rid, 0)

    # -- plumbing ------------------------------------------------------------

    def _push(self, t: float, kind: int, a: int, b: int) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, a, b))

    def _publish(self, kind: EventKind, *, task_id: int | None = None,
                 type_name: str | None = None, cost: float | None = None,
                 worker_id: int | None = None, elapsed: float | None = None,
                 data: dict | None = None) -> None:
        if not self.bus.interested(kind):
            return
        self.bus.publish(RuntimeEvent(
            kind=kind, time=self._now, task_id=task_id,
            type_name=type_name, cost=cost, worker_id=worker_id,
            elapsed=elapsed, data=data or {}))

    # -- main loop -----------------------------------------------------------

    def run(self) -> "SimServing":
        """Process events until every request has an outcome."""
        heap = self._heap
        while self._done < self._n:
            if not heap:
                raise RuntimeError(
                    f"serving sim drained its event heap with "
                    f"{self._n - self._done} of {self._n} requests "
                    f"unresolved (queued={self._qdepth}, "
                    f"active={self._active})")
            t, _, kind, a, b = heapq.heappop(heap)
            self._now = t
            if kind == _FINISH:
                self._on_finish(a, t)
            elif kind == _ARRIVE:
                self._on_arrive(a, t)
            elif kind == _TIMEOUT:
                self._on_timeout(a, b, t)
            elif kind == _RETRY:
                self._on_retry(a, t)
            elif kind == _HEDGE:
                self._on_hedge(a, b, t)
            elif kind == _SCALE:
                self._on_scale(t)
            elif kind == _WARM:
                self._on_warm(a, b, t)
            else:
                self._on_pert(a, t)
        if not self._finished:
            self._meter.finish(self._now)
            self._finished = True
        return self

    # -- queue ---------------------------------------------------------------

    def _pri(self, req: SimRequest) -> int:
        # SLO-priority ordering is part of the protection layer: the
        # unprotected baseline is a plain FIFO server
        return req.slo.priority if req.slo and self.protection else 0

    def _enqueue(self, req: SimRequest) -> None:
        pri = self._pri(req)
        seq = next(self._seq)
        self._inq[req.rid] = (pri, seq)
        heapq.heappush(self._q, (-pri, seq, req.rid))
        heapq.heappush(self._vq, (pri, -seq, req.rid))
        self._qdepth += 1
        self._qwork += req.est_s
        self._qwork_by_pri[pri] = \
            self._qwork_by_pri.get(pri, 0.0) + req.est_s

    def _pop_queue(self) -> int | None:
        q = self._q
        while q:
            negpri, seq, rid = heapq.heappop(q)
            if self._inq.get(rid) == (-negpri, seq):
                del self._inq[rid]
                self._qdepth -= 1
                est = self._reqs[rid].est_s
                self._qwork -= est
                self._qwork_by_pri[-negpri] -= est
                return rid
        return None

    def _evict_lowest(self, above: int) -> int | None:
        """Drop the lowest-priority (youngest at ties) queued request if
        its priority is strictly below ``above``; returns its rid."""
        vq = self._vq
        while vq:
            pri, negseq, rid = vq[0]
            if self._inq.get(rid) != (pri, -negseq):
                heapq.heappop(vq)          # stale
                continue
            if pri >= above:
                return None
            heapq.heappop(vq)
            del self._inq[rid]
            self._qdepth -= 1
            est = self._reqs[rid].est_s
            self._qwork -= est
            self._qwork_by_pri[pri] -= est
            return rid
        return None

    # -- arrival / admission -------------------------------------------------

    def _on_arrive(self, rid: int, now: float) -> None:
        req = self._reqs[rid]
        data: dict[str, Any] = {"prompt": req.prompt, "new": req.new}
        if req.slo is not None:
            data["slo"] = req.slo.to_dict()
        self._publish(EventKind.TASK_SUBMITTED, task_id=rid,
                      type_name=req.type_name, cost=req.cost, data=data)
        self.monitor.on_task_ready(rid, req.type_name, req.cost)
        self._publish(EventKind.TASK_READY, task_id=rid,
                      type_name=req.type_name, cost=req.cost)
        reason = None
        pri = self._pri(req)
        if self._admission is not None:
            # Priority-aware wait estimate: the newcomer only queues
            # behind work at its own priority or above — charging it
            # for the batch backlog it would jump over would shed
            # latency-critical traffic that is perfectly feasible.
            ahead = sum(w for p, w in self._qwork_by_pri.items()
                        if p >= pri)
            est_wait = ahead / max(
                1, self._nhot * self.model.slots_per_replica)
            reason = self._admission.shed_reason(
                now=now, queue_depth=self._qdepth, slo=req.slo,
                submitted_at=now, est_wait_s=est_wait,
                est_service_s=req.est_s)
        if reason == "queue":
            victim = self._evict_lowest(pri)
            if victim is not None:
                self._shed(self._reqs[victim], "queue", now)
                reason = None
        if reason is not None:
            self._shed(req, reason, now)
            return
        self._enqueue(req)
        self._dispatch(now)

    def _shed(self, req: SimRequest, reason: str, now: float) -> None:
        """Terminal shed of a *ready* (queued or never-admitted) request."""
        self.monitor.on_task_shed(req.rid, req.type_name, req.cost)
        req.outcome = "shed" if reason != "timeout" else "timed_out"
        req.done_at = now
        self._shed_by_reason[reason] = \
            self._shed_by_reason.get(reason, 0) + 1
        self._publish(EventKind.SHED, task_id=req.rid,
                      type_name=req.type_name, cost=req.cost,
                      data={"reason": reason})
        self._done += 1

    # -- dispatch ------------------------------------------------------------

    def _pick_replica(self, now: float) -> int | None:
        spr = self.model.slots_per_replica
        breakers = self._breakers
        for r in self._order:
            if (not self._hot[r] or self._warming[r] or self._failed[r]
                    or self._busy[r] >= spr):
                continue
            if breakers is not None:
                st = breakers[r].state(now)
                if st == CircuitBreaker.OPEN:
                    continue
                if st == CircuitBreaker.HALF_OPEN and self._busy[r] > 0:
                    continue   # one probe in flight at a time
            return r
        return None

    def _dispatch(self, now: float) -> None:
        while self._qdepth > 0:
            r = self._pick_replica(now)
            if r is None:
                return
            rid = self._pop_queue()
            if rid is None:
                return
            req = self._reqs[rid]
            slo = req.slo
            if (self.protection and slo is not None
                    and slo.deadline_s is not None
                    and now > req.release + slo.deadline_s):
                # deadline lost while queued: cheapest failure is now.
                # The unprotected baseline serves these dead requests
                # anyway — the wasted slots are exactly the congestion
                # collapse admission control exists to prevent.
                self._shed(req, "deadline", now)
                continue
            self._start_attempt(req, r, now, hedge=False)

    def _start_attempt(self, req: SimRequest, r: int, now: float,
                       hedge: bool) -> None:
        served = req.new
        if (self.protection and self._cap_active
                and self.brownout_tokens is not None
                and req.slo is not None and req.slo.best_effort):
            served = min(served, self.brownout_tokens)
        freq = self._conditions.thermal_cap(self._ctype[r])
        svc = (self.machine.service_time(
                   self.model.base_seconds(req.prompt, served),
                   core=r, freq=freq)
               * self._conditions.slowdown_of(r))
        aid = next(self._aids)
        self._att[aid] = (req.rid, r, served, now, hedge, freq)
        self._rid_att.setdefault(req.rid, []).append(aid)
        self._busy[r] += 1
        self._active += 1
        if self._busy[r] == 1:
            self._meter.set_state(r, CoreState.ACTIVE, now)
        self._push(now + svc, _FINISH, aid, 0)
        if hedge:
            self._hedges += 1
            self._publish(EventKind.HEDGE, task_id=req.rid,
                          type_name=req.type_name, cost=req.cost,
                          worker_id=r)
            return
        self.monitor.on_task_execute(req.rid, req.type_name, req.cost)
        self._publish(EventKind.TASK_EXECUTE, task_id=req.rid,
                      type_name=req.type_name, cost=req.cost, worker_id=r)
        slo = req.slo
        if slo is not None:
            epoch = self._tepoch[req.rid]
            tmo = slo.attempt_timeout_s
            if tmo is not None:
                self._push(now + tmo, _TIMEOUT, req.rid, epoch)
            if self.protection and slo.hedge_after_s is not None:
                self._push(now + slo.hedge_after_s, _HEDGE, req.rid, epoch)

    # -- completion / cancellation -------------------------------------------

    def _release_slot(self, r: int, now: float) -> None:
        self._busy[r] -= 1
        self._active -= 1
        if (self._busy[r] == 0 and self._hot[r] and not self._warming[r]
                and not self._failed[r]):
            self._meter.set_state(r, CoreState.SPIN, now)

    def _on_finish(self, aid: int, now: float) -> None:
        ent = self._att.pop(aid, None)
        if ent is None:
            return   # cancelled attempt; stale event
        rid, r, served, t0, hedge, freq = ent
        req = self._reqs[rid]
        for aid2 in self._rid_att.pop(rid, ()):
            ent2 = self._att.pop(aid2, None)
            if ent2 is None:
                continue   # the finishing attempt itself, or long gone
            self._release_slot(ent2[1], now)
        self._release_slot(r, now)
        self._tepoch[rid] += 1
        if hedge:
            self._hedge_wins += 1
        if self._breakers is not None:
            self._record_breaker_success(r, now)
        self.monitor.on_task_completed(
            rid, req.type_name, req.cost, now - t0,
            core_type=self._ctype[r] if self._typed else None,
            freq=freq, suspect=self._conditions.is_suspect(r))
        req.outcome = "completed"
        req.done_at = now
        req.tokens_out = served
        self._completed += 1
        self._done += 1
        self._publish(EventKind.TASK_COMPLETED, task_id=rid,
                      type_name=req.type_name, cost=req.cost, worker_id=r,
                      elapsed=now - req.release)
        self._dispatch(now)

    def _record_breaker_success(self, r: int, now: float) -> None:
        brk = self._breakers[r]
        was_half = brk.state(now) == CircuitBreaker.HALF_OPEN
        brk.record_success(now)
        if was_half and brk.state(now) == CircuitBreaker.CLOSED:
            self._degrades += 1
            self._publish(EventKind.DEGRADE, worker_id=r,
                          data={"mode": "restored"})

    def _on_timeout(self, rid: int, epoch: int, now: float) -> None:
        if epoch != self._tepoch[rid]:
            return   # attempt finished / was torn down before the bell
        req = self._reqs[rid]
        for aid in self._rid_att.pop(rid, ()):
            ent = self._att.pop(aid, None)
            if ent is None:
                continue
            r = ent[1]
            self._release_slot(r, now)
            if self._breakers is not None:
                brk = self._breakers[r]
                brk.record_failure(now)
                if brk.state(now) == CircuitBreaker.OPEN:
                    self._quarantine(r, now)
        self._tepoch[rid] += 1
        self.monitor.on_task_abort(rid, req.type_name, req.cost)
        slo = req.slo
        if slo is not None and req.tries <= slo.retry_budget:
            backoff = slo.backoff(req.tries, seed=self.seed, request_id=rid)
            retry_at = now + backoff
            if (slo.deadline_s is None
                    or retry_at <= req.release + slo.deadline_s):
                req.tries += 1
                self._retries += 1
                self._sleeping += 1
                self._publish(EventKind.RETRY, task_id=rid,
                              type_name=req.type_name, cost=req.cost,
                              data={"try": req.tries,
                                    "backoff_s": backoff})
                self._push(retry_at, _RETRY, rid, 0)
                self._dispatch(now)
                return
        self._shed(req, "timeout", now)
        self._dispatch(now)

    def _on_retry(self, rid: int, now: float) -> None:
        self._sleeping -= 1
        req = self._reqs[rid]
        if req.outcome is not None:
            return
        self._enqueue(req)
        self._dispatch(now)

    def _on_hedge(self, rid: int, epoch: int, now: float) -> None:
        if epoch != self._tepoch[rid] or rid not in self._rid_att:
            return   # finished / retried — the tail is gone
        primary_replicas = [self._att[a][1] for a in self._rid_att[rid]
                            if a in self._att]
        if not primary_replicas:
            return
        spr = self.model.slots_per_replica
        breakers = self._breakers
        for r in self._order:
            if (r in primary_replicas or not self._hot[r]
                    or self._warming[r] or self._failed[r]
                    or self._busy[r] >= spr):
                continue
            if breakers is not None \
                    and breakers[r].state(now) != CircuitBreaker.CLOSED:
                continue   # never hedge onto suspect silicon
            self._start_attempt(self._reqs[rid], r, now, hedge=True)
            return

    # -- replica lifecycle ---------------------------------------------------

    def _wake(self, r: int, now: float) -> None:
        self._hot[r] = True
        self._warming[r] = True
        self._wepoch[r] += 1
        self._nhot += 1
        self._meter.set_state(r, CoreState.SPIN, now)
        self._push(now + self.model.spinup_s, _WARM, r, self._wepoch[r])

    def _park(self, r: int, now: float) -> None:
        self._hot[r] = False
        if self._warming[r]:
            self._warming[r] = False
            self._wepoch[r] += 1   # cancel the in-flight _WARM
        self._nhot -= 1
        self._idles += 1
        self._meter.set_state(r, CoreState.IDLE, now)

    def _on_warm(self, r: int, epoch: int, now: float) -> None:
        if not self._warming[r] or self._wepoch[r] != epoch:
            return
        self._warming[r] = False
        self._dispatch(now)

    def _on_scale(self, now: float) -> None:
        if self._done >= self._n:
            return
        target = self.scaler.target(self._qdepth + self._sleeping,
                                    self._active)
        if self.scaler.governor.predictor is not None:
            self._publish(EventKind.PREDICTION, data={"delta": target})
        spr = self.model.slots_per_replica
        need = -(-target // spr)   # ceil in replicas
        if self.protection and self._allowance is not None:
            need = min(need, self._allowance)
        self._apply_replica_target(need, now)
        self._check_stall(now)
        self._push(now + self.scaler.rate_s, _SCALE, 0, 0)

    def _apply_replica_target(self, need: int, now: float) -> None:
        breakers = self._breakers
        if self._nhot < need:
            for r in self._order:
                if self._nhot >= need:
                    break
                if self._hot[r] or self._failed[r]:
                    continue
                if breakers is not None \
                        and not breakers[r].allow(now):
                    continue
                self._wake(r, now)
        elif self._nhot > need:
            for r in reversed(self._order):
                if self._nhot <= need:
                    break
                if self._hot[r] and self._busy[r] == 0:
                    self._park(r, now)
        self._dispatch(now)

    def _check_stall(self, now: float) -> None:
        if (self._done == self._stall_done and self._active == 0
                and self._sleeping == 0
                and not any(self._warming)):
            self._stall += 1
            if self._stall > 10_000:
                raise RuntimeError(
                    f"serving sim stalled at t={now:.3f}: "
                    f"{self._done}/{self._n} resolved, "
                    f"queued={self._qdepth}, hot={self._nhot}, "
                    f"failed={sum(self._failed)} — no attempt, retry "
                    f"or warmup in flight for {self._stall} scale ticks")
        else:
            self._stall = 0
            self._stall_done = self._done

    # -- degradation: quarantine, capacity shrink, brownout ------------------

    def _evict_replica(self, r: int, now: float) -> None:
        """Tear every attempt off replica ``r`` and requeue the affected
        requests *uncharged* (no retry-budget debit — the machine, not
        the request, failed).  A request whose hedge twin survives on
        another replica just loses this one attempt."""
        doomed = [aid for aid, ent in self._att.items() if ent[1] == r]
        for aid in doomed:
            rid = self._att.pop(aid)[0]
            self._release_slot(r, now)
            aids = self._rid_att.get(rid)
            if aids is not None:
                aids = [a for a in aids if a != aid and a in self._att]
                if aids:
                    self._rid_att[rid] = aids
                    continue   # a sibling attempt survives
                del self._rid_att[rid]
            req = self._reqs[rid]
            self._tepoch[rid] += 1
            self.monitor.on_task_abort(rid, req.type_name, req.cost)
            self._requeues += 1
            self._publish(EventKind.RETRY, task_id=rid,
                          type_name=req.type_name, cost=req.cost,
                          data={"requeued": True})
            self._enqueue(req)

    def _quarantine(self, r: int, now: float) -> None:
        """Circuit breaker opened on ``r``: park it out of rotation (it
        re-enters through half-open probes after the reset window)."""
        self._evict_replica(r, now)
        if self._hot[r]:
            self._park(r, now)
        self._degrades += 1
        self._publish(EventKind.DEGRADE, worker_id=r,
                      data={"mode": "quarantine"})

    def _shrink_to(self, allowance: int, now: float) -> None:
        """Enforce a hot-replica ceiling *now* (power-cap compliance):
        park empty replicas slowest-first, then evict busy ones."""
        if self._nhot <= allowance:
            return
        for r in reversed(self._order):
            if self._nhot <= allowance:
                return
            if self._hot[r] and self._busy[r] == 0:
                self._park(r, now)
        for r in reversed(self._order):
            if self._nhot <= allowance:
                return
            if self._hot[r]:
                self._evict_replica(r, now)
                self._park(r, now)

    def _on_pert(self, index: int, now: float) -> None:
        p = self._conditions.timeline.events[index]
        self._conditions.apply(p)
        self._publish(EventKind.PERTURBATION, data=p.to_dict())
        k = p.kind
        if k is PerturbationKind.POWER_CAP:
            self._meter.set_power_cap(now, p.watts)
            if p.watts is None:
                self._cap_active = False
                self._allowance = None
                if self.protection:
                    self._degrades += 1
                    self._publish(EventKind.DEGRADE,
                                  data={"mode": "brownout_release"})
            else:
                self._cap_active = True
                if self.protection:
                    draws = [(self._power[r].power(CoreState.ACTIVE),
                              self._power[r].power(CoreState.IDLE))
                             for r in self._order if not self._failed[r]]
                    self._allowance = cap_allowance(p.watts, draws)
                    self._degrades += 1
                    self._publish(EventKind.DEGRADE,
                                  data={"mode": "brownout",
                                        "allowance": self._allowance})
                    self._shrink_to(self._allowance, now)
        elif k is PerturbationKind.CORE_FAIL:
            r = p.core
            self._evict_replica(r, now)
            self._failed[r] = True
            if self._hot[r]:
                self._park(r, now)
                self._idles -= 1   # a crash is not a policy idle
            self._meter.set_state(r, CoreState.OFF, now)
            if self._breakers is not None:
                self._breakers[r].force_open(now)
                self._degrades += 1
                self._publish(EventKind.DEGRADE, worker_id=r,
                              data={"mode": "quarantine"})
        elif k is PerturbationKind.CORE_RECOVER:
            r = p.core
            self._failed[r] = False
            self._meter.set_state(r, CoreState.IDLE, now)
            # parked; the scaler re-admits it (through the breaker's
            # half-open probes when protection is on)
        elif k is PerturbationKind.THERMAL_THROTTLE:
            q = p.freq if p.freq is not None else 1.0
            for r in range(self.model.n_replicas):
                if self._ctype[r] == p.core_type:
                    self._meter.set_frequency(r, q, now)
        self._dispatch(now)

    # -- reporting -----------------------------------------------------------

    @property
    def requests(self) -> list[SimRequest]:
        return [self._reqs[rid] for rid in sorted(self._reqs)]

    def report(self, name: str = "") -> GovernorReport:
        """Unified :class:`GovernorReport` with the ``serving`` extras."""
        if not self._finished:
            self._meter.finish(self._now)
            self._finished = True
        meter = self._meter
        makespan = self._now
        energy = meter.energy()
        reqs = self.requests
        lat = sorted(r.done_at - r.release for r in reqs
                     if r.outcome == "completed")
        by_class: dict[str, dict[str, Any]] = {}
        attained_total = 0
        for r in reqs:
            cname = r.slo.name if r.slo else "none"
            row = by_class.setdefault(
                cname, {"requests": 0, "attained": 0})
            row["requests"] += 1
            dl = r.slo.deadline_s if r.slo else None
            ok = (r.outcome == "completed"
                  and (dl is None or r.done_at - r.release <= dl))
            if ok:
                row["attained"] += 1
                attained_total += 1
        for row in by_class.values():
            row["attainment"] = row["attained"] / row["requests"]
        timed_out = sum(1 for r in reqs if r.outcome == "timed_out")
        shed = sum(1 for r in reqs if r.outcome == "shed")
        truncated = sum(r.new - r.tokens_out for r in reqs
                        if r.outcome == "completed")
        serving = {
            "requests": self._n,
            "completed": self._completed,
            "shed": shed,
            "timed_out": timed_out,
            "shed_by_reason": dict(self._shed_by_reason),
            "retries": self._retries,
            "requeues": self._requeues,
            "hedges": self._hedges,
            "hedge_wins": self._hedge_wins,
            "degrades": self._degrades,
            "truncated_tokens": truncated,
            "p50_ms": _pct(lat, 0.50) * 1e3,
            "p99_ms": _pct(lat, 0.99) * 1e3,
            "attainment": attained_total / self._n if self._n else 0.0,
            "attainment_by_class": by_class,
            "goodput_rps": (attained_total / makespan
                            if makespan > 0 else 0.0),
        }
        predictor = self.scaler.governor.predictor
        return GovernorReport(
            policy=self.scaler.policy,
            makespan=makespan,
            energy=energy,
            edp=energy * makespan,
            tasks_completed=self._completed,
            resumes=meter.resumes(),
            idles=self._idles,
            predictions=(predictor.predictions_made
                         if predictor is not None else 0),
            accuracy=self.monitor.accuracy_report(),
            name=name,
            state_seconds={s.value: v
                           for s, v in meter.state_seconds().items()},
            state_seconds_by_type={
                ct: {s.value: v for s, v in acc.items()}
                for ct, acc in meter.state_seconds_by_type().items()},
            cap_violation_s=meter.cap_violation_s,
            serving=serving,
        )


def _pct(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (0.0 if empty)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


# ---------------------------------------------------------------------------
# Trace round trip
# ---------------------------------------------------------------------------


def replay_serving(events: Iterable[RuntimeEvent], model: ServingModel,
                   **kwargs: Any) -> SimServing:
    """Rebuild a :class:`SimServing` run from its recorded event stream.

    ``TASK_SUBMITTED`` events carry each request's full contract
    (release = event time; prompt/new/SLO in ``data``) and
    ``PERTURBATION`` events carry the condition timeline, so the
    returned sim — constructed with the *same* ``kwargs`` (policy,
    protection, seed, …) as the original — re-runs the scenario and
    publishes a byte-identical trace.
    """
    reqs: list[SimRequest] = []
    perts: list[dict] = []
    for ev in events:
        if ev.kind is EventKind.TASK_SUBMITTED:
            d = ev.data
            slo = (SLOClass.from_dict(d["slo"]) if "slo" in d else None)
            reqs.append(SimRequest(rid=ev.task_id, release=ev.time,
                                   prompt=d["prompt"], new=d["new"],
                                   slo=slo))
        elif ev.kind is EventKind.PERTURBATION:
            perts.append(dict(ev.data))
    kwargs.setdefault("conditions", ConditionTimeline.from_dicts(perts))
    return SimServing(model, reqs, **kwargs)
