"""Roofline terms of a step on one card — the port of
:mod:`repro.launch.roofline`.

The reference walks the compiled HLO of a jitted step.  The port runs
eagerly, so it counts the step as it runs, on the card, on the CPU or on
the meta device (where nothing is allocated and nothing is computed:
:mod:`repro_torch.launch.cells`):

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode``'s formulas
  (its ``flop_registry``): the products, and the kernels' analytic
  FLOPs (:mod:`repro_torch.kernels.ops` registers them for its
  operators).  They are summed in :class:`StepMeter` itself, not under
  a ``FlopCounterMode``: that mode's module tracker hooks every module's
  outputs through a reference cycle that keeps their autograd graph —
  and the tensors it saved — alive until the garbage collector runs,
  which would move the peak by tens of GB at full size, from run to
  run.  ``chip_smoke.py`` holds the sum equal to ``FlopCounterMode``'s
  count of the same step on the card;
* HBM bytes as the input plus output bytes of every operator that is
  not a view — eager PyTorch's unfused traffic, each operator reading
  its inputs from device memory and writing its outputs there; a
  kernel's operator counts its own inputs and outputs, and on meta the
  kernel backwards' stand-in counts the traffic of the operators it
  stands in for;
* peak live bytes, by following each storage from the operator that
  creates it (or first touches it) until its last reference dies.

Terms (seconds, one card)::

    compute    = flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = 0 — one card has no collective

The least time of each kernel on the card, which ``chip_smoke.py``
prints beside each kernel's time, is here too (:func:`attention_bound`,
:func:`decode_bound`, :func:`scan_bound`, :func:`wkv_bound`).
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.ops import attention_flops, attention_pairs, wkv_flops
from .mesh import HW

__all__ = ["StepCount", "StepMeter", "count_step", "roofline_terms",
           "Terms", "model_flops", "attention_bound", "decode_bound",
           "scan_bound", "wkv_bound"]

_aten = torch.ops.aten
#: operators that move no data: they allocate, or alias an input
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
               _aten.lift_fresh}
#: the meta stand-ins of the kernels' backwards, which carry their traffic
#: and their working set on the card and on the CPU as their third to
#: fifth arguments (:mod:`repro_torch.kernels.ops`)
_GRADS = {getattr(torch.ops.repro_torch, f"{name}_grad")
          for name in ("flash_attention", "rglru_scan", "wkv6")}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _key(x):
    """A hashable stand-in for an operator argument: a tensor by its
    metadata; raises ``TypeError`` on what cannot be keyed."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    hash(x)
    return x


def _spec(out):
    """``out``'s tensors as (shape, stride, dtype), if every leaf is a
    meta tensor; else ``None``."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)):
        specs = [_spec(o) for o in out]
        return None if None in specs else (type(out), specs)
    return None


def _build(spec):
    if isinstance(spec[0], type):
        return spec[0](_build(s) for s in spec[1])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class _MetaMemo(TorchDispatchMode):
    """On the meta device an operator's outputs depend on nothing but
    its inputs' metadata and its other arguments, so each functional
    operator (no view, no mutation, no output on an input's storage)
    runs once per distinct call and is answered from then on with fresh
    meta tensors of the same metadata.
    It sits below the counters, which still see every call; the dry-run
    repeats the same layer, chunk and microbatch many times over."""

    def __init__(self) -> None:
        super().__init__()
        self._memo: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if func.is_view or schema.is_mutable \
                or any(r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        spec = self._memo.get(key, False)
        if spec:
            return _build(spec)
        out = func(*args, **kwargs)
        if spec is False:
            # an output on an input's storage (``_unsafe_view`` has no
            # alias annotation) must stay that storage: not memoized
            held = {t.untyped_storage()._cdata
                    for t in _tensors((args, kwargs))}
            shared = any(t.untyped_storage()._cdata in held
                         for t in _tensors(out))
            self._memo[key] = None if shared else _spec(out)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """Counts, for the operators run under it, their FLOPs (``flops``),
    the HBM bytes they move (``hbm_bytes``) and the bytes of the storages
    alive at once (``live``, and its ``peak``).  ``tensors`` are alive
    when it starts (a step's arguments); any other storage an operator
    touches counts from then on.  A meta stand-in of a kernel's backward
    adds the working set it carries for ``device`` (``"cuda"``, the
    card, or ``"cpu"``) to the peak, over its outputs."""

    def __init__(self, tensors: Iterable[torch.Tensor] = (),
                 device: str = "cuda") -> None:
        super().__init__()
        self.device = device
        self.flops = 0
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}
        for t in tensors:
            self._track(t)
        self.argument_bytes = self.live

    @property
    def storages(self) -> int:
        """The storages alive, of those it has seen."""
        return len(self._refs)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, partial(self._free, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int, _ref) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = _tensors((args, kwargs))
        for t in inputs:
            self._track(t)
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        for t in outputs:
            self._track(t)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        packet = func._overloadpacket
        if packet in _GRADS:
            self.hbm_bytes += args[2]
            held = args[3] if self.device == "cuda" else args[4]
            self.peak = max(self.peak, self.live + held)
        elif not (func.is_view or packet in _NO_TRAFFIC):
            self.hbm_bytes += sum(map(_nbytes, inputs)) \
                + sum(map(_nbytes, outputs))
        return out


@dataclass
class StepCount:
    """What :func:`count_step` counted over one call."""

    flops: int
    hbm_bytes: int
    peak_bytes: int
    argument_bytes: int
    collective_bytes: float = 0.0

    def to_json(self) -> dict:
        return self.__dict__.copy()


def count_step(fn: Callable, args: tuple,
               tensors: Iterable[torch.Tensor] | None = None,
               device: str = "cuda") -> StepCount:
    """Run ``fn(*args)`` under a :class:`StepMeter` (on meta, over a
    memo of the operators' outputs) that models ``device``'s kernel
    backward.  ``tensors`` are the step's arguments as tensors (default:
    the tensors in ``args``); they are alive throughout, and their bytes
    open the live count."""
    tensors = _tensors(args) if tensors is None else list(tensors)
    meter = StepMeter(tensors, device)
    on_meta = all(t.device.type == "meta" for t in tensors)
    with contextlib.ExitStack() as stack:
        if on_meta:
            stack.enter_context(_MetaMemo())
        stack.enter_context(meter)
        fn(*args)
    return StepCount(meter.flops, meter.hbm_bytes, meter.peak,
                     meter.argument_bytes)


@dataclass
class Terms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float
    hlo_flops_per_dev: float
    useful_ratio: float
    dominant: str

    def to_json(self) -> dict:
        return self.__dict__.copy()


def roofline_terms(analysis: StepCount, n_chips: int,
                   model_flops_total: float, n_links: int = 4) -> Terms:
    """The reference's terms for the counts of one step
    (``hlo_flops_per_dev`` keeps its name: the FLOPs counted a card)."""
    compute = analysis.flops / HW.PEAK_FLOPS
    memory = analysis.hbm_bytes / HW.HBM_BW
    coll = analysis.collective_bytes / (n_links * HW.ICI_BW)
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    useful = model_flops_total / max(analysis.flops * n_chips, 1.0)
    return Terms(compute, memory, coll, model_flops_total,
                 analysis.flops, useful, dominant)


def model_flops(cfg, shape, kind: str) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active."""
    _, active = cfg.param_count()
    if kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch


# -- the kernels' least times on the card ---------------------------------------


def attention_bound(B, S, H, KV, D, window=None,
                    softcap=None) -> tuple[float, str]:
    """Least time on the card for causal bf16 attention, ms: its
    operations (:func:`~repro_torch.kernels.ops.attention_flops`, 4·D
    per unmasked query-key pair, at the tensor-core peak, and with a
    softcap 3 more a pair — divide, tanh, multiply — at the float32
    peak), or the bytes of q, k, v and o once each at the memory rate,
    whichever is larger."""
    ops_s = attention_flops(B, S, H, D, window) / HW.PEAK_FLOPS
    if softcap is not None:
        ops_s += 3 * B * H * attention_pairs(S, window) / HW.PEAK_F32_FLOPS
    bytes_s = (2 * B * S * H * D + 2 * B * S * KV * D) * 2 / HW.HBM_BW
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def decode_bound(Sc, H, KV, D, pos) -> tuple[float, str]:
    """Least time on the card for one-token bf16 attention against a
    cache of Sc slots (K4), ms, given each slot's position ``pos`` (a
    sequence of ints, one a batch row): the bytes of its valid K and V
    rows (min(pos + 1, Sc) of each row's Sc), of q and of o once each at
    the memory rate, or 4·D operations a valid slot and query head at the
    tensor-core peak, whichever is larger."""
    B = len(pos)
    valid = sum(min(max(int(p) + 1, 0), Sc) for p in pos)
    bytes_s = (2 * valid * KV * D + 2 * B * H * D) * 2 / HW.HBM_BW
    ops_s = 4 * valid * H * D / HW.PEAK_FLOPS
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")


def scan_bound(*tensors) -> tuple[float, str]:
    """Least time on the card for the scan, ms: the bytes of its inputs
    (a, b, h0) read once and its outputs (h, h_final) written once, at
    the memory rate.  Two flops a step: the bytes bound it."""
    return sum(map(_nbytes, tensors)) / HW.HBM_BW * 1e3, "bytes"


def wkv_bound(inputs, outputs) -> tuple[float, str]:
    """Least time on the card for the WKV, ms: the bytes of its inputs
    (r, k, v, w, u and s0 where one is passed) read once and its outputs
    (y, s_final) written once at the memory rate, or the recurrence's
    operations (:func:`~repro_torch.kernels.ops.wkv_flops`, 5·N² + 5·N a
    token and head), of which the two products r_t S and k_tᵀv_t (4·N²)
    at the TF32 tensor-core peak and the rest (N² + 5·N) at the float32
    peak outside the tensor cores — whichever is larger."""
    B, H, S, N = inputs[0].shape
    bytes_s = sum(map(_nbytes, list(inputs) + list(outputs))) / HW.HBM_BW
    on_tc = 4 * B * H * S * N * N
    ops_s = (on_tc / HW.PEAK_TF32_FLOPS
             + (wkv_flops(B, H, S, N) - on_tc) / HW.PEAK_F32_FLOPS)
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s > bytes_s else "bytes")
