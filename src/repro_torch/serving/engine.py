"""Continuous-batching serving engine.

Fixed-slot continuous batching: a batched decode step runs every tick;
slots hold independent requests at their own depths (vector positions).
Arriving prompts are prefetched (B=1 prefill) and their caches scattered
into a free slot; finished slots free immediately — no head-of-line
blocking on long generations.

The engine feeds the paper's monitoring infrastructure: every request is
a *task* with a cost clause (prompt_len + max_new_tokens), prefill and
decode timings are aggregated per type, and the
:class:`~repro.serving.autoscale.AutoScaler` turns Algorithm 1 into a
replica/slot target Δ.

The port of :mod:`repro.serving.engine`: the same requests, events, task
ids and bucketing, with the model in PyTorch on ``device`` (CUDA unless
the caller asks for the CPU).  The decode cache is updated in place.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.events import EventBus, EventKind, RuntimeEvent
from ..core.governor import GovernorSpec, ResourceGovernor
from ..core.monitoring import TaskMonitor
from ..models import ModelConfig, decode_step, init_cache, prefill
from ..models.config import LayerKind
from ..models.transformer import Transformer, resolve_device
from .admission import AdmissionController
from .slo import SLOClass

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    #: service contract (deadline/priority/…); None = plain best-effort
    #: FIFO request, byte-identical to the pre-SLO engine
    slo: SLOClass | None = None
    #: assigned by the engine at submit (ids are *per engine* — two
    #: engines in one process no longer interleave a global counter)
    request_id: int | None = None
    # -- filled by the engine ------------------------------------------
    output: list[int] = field(default_factory=list)
    submitted_at: float = 0.0
    done_at: float | None = None

    @property
    def cost(self) -> float:
        return float(len(self.prompt) + self.max_new_tokens)

    @property
    def type_name(self) -> str:
        return f"request:{self.slo.name}" if self.slo else "request"

    @property
    def priority(self) -> int:
        return self.slo.priority if self.slo else 0

    @property
    def done(self) -> bool:
        return self.done_at is not None


def _scatter_cache(dst: list[dict], src: list[dict], slot: int
                   ) -> list[dict]:
    """Copy the B=1 cache ``src`` into batch slot ``slot`` of ``dst``,
    in place (one ``{"k", "v"}`` dict per layer, batch at axis 0)."""
    for d, s in zip(dst, src):
        for name in d:
            d[name][slot].copy_(s[name][0])
    return dst


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Transformer, *,
                 max_batch: int = 4,
                 max_len: int = 256, monitor: TaskMonitor | None = None,
                 governor: ResourceGovernor | None = None,
                 bus: EventBus | None = None,
                 clock: Callable[[], float] | None = None,
                 admission: AdmissionController | None = None,
                 brownout_tokens: int | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        # Injected time source (tests/sims pass virtual clocks; the
        # default is the wall clock, referenced — never called — here).
        self._clock = clock if clock is not None else time.perf_counter
        # Overload protection (both default off = pre-SLO behaviour):
        # an AdmissionController sheds at submit; ``brownout_tokens``,
        # when set, truncates best-effort generations at admit time.
        self.admission = admission
        self.brownout_tokens = brownout_tokens
        #: requests refused by admission control (terminal; not queued)
        self.shed: list[Request] = []
        # Per-engine id stream for requests and decode ticks (was a
        # module global, which interleaved ids across engines and made
        # single-engine traces depend on process history).
        self._ids = itertools.count()
        # The engine is the workload side of the paper's loop: it
        # publishes request lifecycle events on ``self.bus``; the monitor
        # (owned by a governor — either one passed in and shared with an
        # AutoScaler, or a minimal monitoring-only stack assembled here)
        # subscribes, and so can a TraceRecorder for record/replay.
        self.bus = bus if bus is not None else EventBus()
        if governor is None:
            governor = ResourceGovernor(
                GovernorSpec(resources=max_batch, monitoring=True),
                monitor=monitor, bus=self.bus)
        elif monitor is not None and governor.monitor is not monitor:
            raise ValueError(
                "conflicting monitor and governor arguments: the engine "
                "feeds events to governor.monitor, so pass one or the "
                "other (or a governor built over that monitor)")
        if governor.bus is None:
            # Pull-style governors carry no worker manager, so adopting
            # the engine's bus late only affects where PREDICTION
            # samples are published — serving traces then show the
            # autoscaler's Δ decisions like every other frontend.
            governor.bus = self.bus
        self.governor = governor
        if governor.monitor is None:
            raise ValueError(
                "ServingEngine needs a monitoring governor — build it "
                "from a GovernorSpec with monitoring=True")
        self.monitor = governor.monitor
        self.monitor.subscribe(self.bus)
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * max_batch
        self.cache = init_cache(cfg, max_batch, max_len, device=self.device)
        self.tokens = torch.zeros((max_batch,), dtype=torch.long,
                                  device=self.device)
        self.pos = torch.zeros((max_batch,), dtype=torch.long,
                               device=self.device)
        self.remaining = np.zeros((max_batch,), np.int64)
        # Prompt-length bucketing, as the reference does to avoid a
        # recompile per length (here it keeps the kernel shapes few).
        # Right-padding is safe for attention archs (pad slots sit after
        # `pos` and are causally invisible); recurrent states would
        # absorb the padding, so those archs prefill at exact length.
        self._bucketing = all(k in (LayerKind.ATTN, LayerKind.MOE)
                              for k in cfg.pattern)
        self.ticks = 0
        self.tokens_out = 0
        #: prompts prefilled (each runs every layer's prefill attention)
        self.prefills = 0

    @torch.no_grad()
    def _prefill(self, params: Transformer, prompt: torch.Tensor,
                 length: int):
        return prefill(params, prompt, self.cfg, max_len=self.max_len,
                       return_all_logits=self._bucketing, length=length)

    @torch.no_grad()
    def _decode(self, params: Transformer, tokens: torch.Tensor,
                pos: torch.Tensor, cache: list[dict]):
        return decode_step(params, tokens, pos, cache, self.cfg)

    # -- request lifecycle ---------------------------------------------------

    def _publish(self, kind: EventKind, task_id: int, type_name: str,
                 cost: float, elapsed: float | None = None,
                 data: dict | None = None) -> None:
        self.bus.publish(RuntimeEvent(
            kind=kind, time=self._clock(), task_id=task_id,
            type_name=type_name, cost=cost, elapsed=elapsed,
            data=data or {}))

    def submit(self, req: Request) -> Request:
        if req.request_id is None:
            req.request_id = next(self._ids)
        req.submitted_at = self._clock()
        browned = False
        if (self.brownout_tokens is not None and req.slo is not None
                and req.slo.best_effort
                and req.max_new_tokens > self.brownout_tokens):
            # Brownout: truncate best-effort generations instead of
            # shedding them (graceful degradation under a cap).  Applied
            # before any event so the monitor accounts the served cost.
            req.max_new_tokens = self.brownout_tokens
            browned = True
        self._publish(EventKind.TASK_SUBMITTED, req.request_id,
                      req.type_name, req.cost)
        if browned:
            self._publish(EventKind.DEGRADE, req.request_id,
                          req.type_name, req.cost,
                          data={"mode": "brownout"})
        self._publish(EventKind.TASK_READY, req.request_id,
                      req.type_name, req.cost)
        if self.admission is not None:
            reason = self.admission.shed_reason(
                now=req.submitted_at, queue_depth=len(self.queue),
                slo=req.slo, submitted_at=req.submitted_at,
                est_wait_s=self._est_wait_s(),
                est_service_s=self._est_service_s(req))
            if reason is not None:
                # Monitor saw the READY above (bus-subscribed); reverse
                # it so shed work stops inflating Δ.
                self.monitor.on_task_shed(req.request_id, req.type_name,
                                          req.cost)
                req.done_at = req.submitted_at
                self.shed.append(req)
                self._publish(EventKind.SHED, req.request_id,
                              req.type_name, req.cost,
                              data={"reason": reason})
                return req
        self.queue.append(req)
        return req

    def _est_service_s(self, req: Request) -> float:
        """Predicted service seconds for ``req`` (0 while α is cold)."""
        alpha = self.monitor.unitary_cost(req.type_name)
        return req.cost * alpha if alpha is not None else 0.0

    def _est_wait_s(self) -> float:
        """Predicted queue wait: outstanding queued work over the batch
        width (0 while the α estimates are cold)."""
        total = 0.0
        for r in self.queue:
            alpha = self.monitor.unitary_cost(r.type_name)
            if alpha is not None:
                total += r.cost * alpha
        return total / max(1, self.max_batch)

    def _pop_next(self) -> Request:
        """Highest-priority queued request; FIFO within a priority
        class (all-default priorities reduce to plain ``pop(0)``)."""
        best = 0
        best_pri = self.queue[0].priority
        for i in range(1, len(self.queue)):
            pri = self.queue[i].priority
            if pri > best_pri:
                best, best_pri = i, pri
        return self.queue.pop(best)

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self._pop_next()
            self._publish(EventKind.TASK_EXECUTE, req.request_id,
                          req.type_name, req.cost)
            t0 = self._clock()
            toks = req.prompt
            if self._bucketing:
                bucket = max(16, 1 << (len(toks) - 1).bit_length())
                toks = toks + [0] * (bucket - len(toks))
            prompt = torch.tensor([toks], dtype=torch.long,
                                  device=self.device)
            logits, cache1 = self._prefill(self.params, prompt,
                                           len(req.prompt))
            self.prefills += 1
            if self._bucketing:
                logits = logits[:, len(req.prompt) - 1]
            first = int(torch.argmax(logits[0, :self.cfg.vocab]))
            self.cache = _scatter_cache(self.cache, cache1, slot)
            self.active[slot] = req
            req.output.append(first)
            self.tokens[slot] = first
            self.pos[slot] = len(req.prompt)
            self.remaining[slot] = req.max_new_tokens - 1
            elapsed = self._clock() - t0
            self._publish(EventKind.TASK_COMPLETED, req.request_id * 2 + 1,
                          "prefill", float(len(req.prompt)), elapsed)

    # -- decode tick ------------------------------------------------------------

    def tick(self) -> int:
        """Admit + one batched decode step.  Returns #active slots."""
        self._admit()
        live = [s for s, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        t0 = self._clock()
        logits, self.cache = self._decode(self.params, self.tokens,
                                          self.pos, self.cache)
        nxt = torch.argmax(logits[:, :self.cfg.vocab], dim=-1)
        self.tokens = nxt
        self.pos = self.pos + 1
        # The host copies wait for the device, so ``elapsed`` is the
        # step's device time too (the reference read it before its copy).
        nxt_host = nxt.cpu().numpy()
        pos_host = self.pos.cpu().numpy()
        elapsed = self._clock() - t0
        self._publish(EventKind.TASK_COMPLETED, next(self._ids) * 2,
                      "decode_tick", float(len(live)), elapsed)
        self.ticks += 1
        for s in live:
            req = self.active[s]
            assert req is not None
            tok = int(nxt_host[s])
            req.output.append(tok)
            self.tokens_out += 1
            self.remaining[s] -= 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if self.remaining[s] <= 0 or hit_eos \
                    or int(pos_host[s]) >= self.max_len - 1:
                req.done_at = self._clock()
                self._publish(EventKind.TASK_COMPLETED, req.request_id,
                              req.type_name, req.cost,
                              req.done_at - req.submitted_at)
                self.active[s] = None
        return len(live)

    def run_until_drained(self, max_ticks: int = 100_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.active):
                return
            self.tick()
        now = self._clock()
        live = [r for r in self.active if r is not None]
        oldest = min((r.submitted_at for r in self.queue + live),
                     default=now)
        raise RuntimeError(
            f"engine did not drain after {max_ticks} ticks: "
            f"{len(self.queue)} queued, {len(live)} active slots, "
            f"oldest request age {now - oldest:.3f}s")

    # -- autoscaler inputs ---------------------------------------------------------

    @property
    def load(self) -> int:
        return len(self.queue) + sum(r is not None for r in self.active)
