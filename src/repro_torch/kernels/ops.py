"""Dispatch between each kernel and its plain version, by device.

Each kernel is a PyTorch custom operator (``torch.library.custom_op``):
``repro_torch::flash_attention`` (K1), ``repro_torch::rglru_scan`` (K2),
``repro_torch::wkv6`` (K3) and ``repro_torch::flash_decode`` (K4).  Its
CPU implementation is the plain PyTorch version in :mod:`.ref` (the CPU
tests, and the truth the kernels are held against); its CUDA
implementation is the hand-written kernel, and if the kernel cannot be
built or launched the call raises — nothing falls back to the plain
version on the card.  On the meta device (the
dry-run of :mod:`repro_torch.launch.cells`) the operator's fake returns
outputs of the right shapes and runs nothing.  Mirrors
:mod:`repro.kernels.ops`, whose ``impl=`` switch this replaces.

Being operators, the kernel calls are what ``FlopCounterMode`` and the
dry-run's dispatch modes see: each is counted by its analytic FLOPs
(:func:`attention_flops`, :func:`scan_flops`, :func:`wkv_flops`,
:func:`decode_flops`), the same on the card, on the CPU and on meta,
and a selective-checkpoint policy sees each kernel call as one op.

Gradients.  Each kernel computes a forward only, as its TPU counterpart
does: the JAX package has no backward kernel, and its train step
differentiates the model code around each kernel's call site — query-
chunked attention, the associative scan, the chunked WKV — which
:mod:`.grad` ports.  So each operator's autograd formula takes the
gradient of that formula on the saved inputs (K1 chunk by chunk,
:func:`.grad.attention_grads`; K2 and K3 by autograd through
:func:`.grad.associative_scan` and :func:`.grad.chunked_wkv`), linear in
S as the reference's is; the plain versions of :mod:`.ref` run in no
backward.  This is no fallback: the forward on the card is always the
kernel (its launch count shows it), and a gradient is a different
function from the kernel's, for which neither package has a kernel.  On
meta the backward is stood in for by ``repro_torch::<op>_grad``, a
meta-only operator that counts the formula's products
(:func:`grad_flops`) and carries its traffic (:func:`grad_traffic`) and
its working set on the card and on the CPU (:func:`grad_workspace`) as
arguments, which :class:`repro_torch.launch.roofline.StepMeter` counts,
so that the dry-run's counts are those of the backward pass it models.
K4, the one-token attention of a decode step, serves inference only and
has no gradient.
"""

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

from . import flash_attention as _fa
from . import flash_decode as _fd
from . import grad as _grad
from . import ref
from . import rglru as _rglru
from . import wkv6 as _wkv6
from ..trace import spans

__all__ = ["attention", "decode_attention", "wkv", "rglru",
           "attention_pairs", "attention_flops", "decode_flops",
           "scan_flops", "wkv_flops", "grad_flops",
           "grad_workspace", "grad_traffic", "backward"]

Tensor = torch.Tensor


# -- analytic counts ----------------------------------------------------------


def attention_pairs(S: int, window: int | None = None) -> int:
    """Query-key pairs causal attention over S positions computes: each
    query sees itself and the ``window − 1`` keys before it (all before
    it without a window)."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def attention_flops(B: int, S: int, H: int, D: int,
                    window: int | None = None) -> int:
    """K1's products: QKᵀ and PV, 2·D each per unmasked query-key pair
    and head."""
    return 4 * B * H * attention_pairs(S, window) * D


def decode_flops(B: int, H: int, Sc: int, D: int) -> int:
    """K4's products as its plain version counts them: QKᵀ and PV of one
    query against every slot of the cache, 2·D each per slot and head —
    the valid slots are known only on the device."""
    return 4 * B * H * Sc * D


def scan_flops(B: int, S: int, R: int) -> int:
    """K2's work: a multiply and an add per step and channel."""
    return 2 * B * S * R


def wkv_flops(B: int, H: int, S: int, N: int) -> int:
    """K3's work a token and head: y_t = r_t S + (r_t·(u⊙k_t)) v_t and
    S = w_t⊙S + k_tᵀv_t, 5·N² + 5·N."""
    return B * H * S * (5 * N * N + 5 * N)


def grad_flops(op: str, shapes: list, options: tuple = ()) -> int:
    """The products that ``FlopCounterMode`` counts in an operator's
    backward (:mod:`.grad`), given the shapes of its inputs and its
    other arguments: attention's five products a query chunk over the
    chunk's key span — the scores, and the gradients of v, of the
    probabilities, of q and of k (10·B·H·D·Σ c·span,
    :func:`.grad.attention_area`); the chunked
    WKV's three a chunk (scores·v, the chunk's kᵀv sum, r·state), once
    forward and twice backward (6·B·H·S'·(L·N + 2·N²), S' = S padded to
    a whole chunk L); the scan has none."""
    if op == "flash_attention":
        B, S, H, D = shapes[0]
        return 10 * B * H * D * _grad.attention_area(S, options[0])
    if op == "wkv6":
        B, H, S, N = shapes[0]
        L = options[0]
        return 6 * B * H * (S + -S % L) * (L * N + 2 * N * N)
    return 0


def _attention_sizes(shapes: list, options: tuple) -> tuple:
    """Attention's backward in bytes: all chunks' float32 scores over
    their key spans (B·H·Σ c·span·4), the largest chunk's, its boolean
    mask (c·span), and q's and k's float32 sizes; and the chunks."""
    (B, S, H, D), (_, _, KV, _) = shapes[0], shapes[1]
    window = options[0] if options else None
    spans = _grad._spans(S, window)
    largest = max((q1 - q0) * (k1 - k0) for q0, q1, k0, k1 in spans)
    return (4 * B * H * _grad.attention_area(S, window),
            4 * B * H * largest, largest, 4 * B * S * H * D,
            4 * B * S * KV * D, len(spans))


def _wkv_sizes(shapes: list, options: tuple) -> tuple:
    """The chunked WKV in bytes: the float32 pairwise (B, H, S', L, N)
    decays (S' = S padded to whole chunks of L), a (B, H, S', N) float32
    input, and the (B, H, S'/L, N, N) float32 states entering the
    chunks."""
    B, H, S, N = shapes[0]
    L = options[0]
    Sp = S + -S % L
    return (4 * B * H * Sp * L * N, 4 * B * H * Sp * N,
            4 * B * H * (Sp // L) * N * N)


def grad_workspace(op: str, shapes: list, dtype: torch.dtype,
                   options: tuple = (), device: str = "cuda") -> int:
    """Bytes an operator's backward holds at its peak beyond its inputs,
    the output gradients and the input gradients, given the shapes of
    the inputs, their dtype, the operator's other arguments and the
    device (measured around the backward: on the card with
    ``max_memory_allocated`` by ``chip_smoke.py`` phase 22, on the CPU
    by :class:`repro_torch.launch.roofline.StepMeter` in
    ``tests/test_torch_dryrun.py``).  Attention: two float32 tensors
    of the largest query chunk's scores over its key span (the
    probabilities and their gradient, into which the scores' is written;
    three with a softcap, its tanh), two of its boolean masks and a
    float32 k-sized key gradient; where q, k and v are not float32,
    their float32 copies, the output gradient's and the query
    gradient's (about 2 + 1/n q-sized, n chunks, and three k-sized); on
    the card a quarter of a chunk's scores and half a float32 q more,
    which CUDA's operators allocate inside themselves (a fit at phase
    22's first three shapes, held there and at two it was not fit to).  The scan: about six and a half float32 (B, S,
    R) on the CPU, five and a half on the card — the recursion's levels
    sum to twice the input, saved and differentiated — and one more with
    h0, which is folded into a new b.
    The WKV: seven of the pairwise (B, H, S', L, N) float32 decays
    (the exponents, their clip, the decays, r·k and its product with
    them, and their gradients), the chunks' states, and two (B, H, S',
    N) float32 temporaries, five where r, k and v are not float32."""
    f32 = dtype == torch.float32
    if op == "flash_attention":
        _, chunk, mask, xq, xkv, n = _attention_sizes(shapes, options)
        capped = len(options) > 1 and options[1] is not None
        return (2 + capped) * chunk + 2 * mask \
            + (xkv if f32 else 2 * xq + xq // n + 3 * xkv) \
            + (0 if device == "cpu" else chunk // 4 + xq // 2)
    if op == "rglru_scan":
        B, S, R = shapes[0]
        halves = (11 if device != "cpu" else 13) + 2 * (shapes[2] is not None)
        return halves * 4 * B * S * R // 2
    pairs, x, states = _wkv_sizes(shapes, options)
    return 7 * pairs + states + (2 if f32 else 5) * x


def grad_traffic(op: str, shapes: list, dtype: torch.dtype,
                 options: tuple = ()) -> int:
    """Bytes an operator's backward reads and writes, operator by
    operator, as :class:`repro_torch.launch.roofline.StepMeter` counts
    them on the CPU (a least-squares fit over chunk-spanning shapes,
    held within 10 % there by ``tests/test_torch_dryrun.py``, and within
    15 % at shapes it was not fit to).  Attention:
    about 22 passes over all chunks' float32 scores, 13 more with a
    softcap, and 32 over q's float32 size.  The scan: 110 passes over a
    float32 (B, S, R), 12 more with h0.  The WKV: 51 passes over the
    pairwise decays, 209 over a (B, H, S', N) float32 input and 25 over
    the chunks' states."""
    if op == "flash_attention":
        scores, _, _, xq, _, _ = _attention_sizes(shapes, options)
        capped = len(options) > 1 and options[1] is not None
        return (22 + 13 * capped) * scores + 32 * xq
    if op == "rglru_scan":
        B, S, R = shapes[0]
        return (110 + 12 * (shapes[2] is not None)) * 4 * B * S * R
    pairs, x, states = _wkv_sizes(shapes, options)
    return 51 * pairs + 209 * x + 25 * states


def _grads_of(fn: Callable, inputs: tuple, grads: tuple) -> list:
    """Gradients of ``fn(*inputs)`` for the output gradients ``grads``,
    with respect to each tensor of ``inputs`` (``None`` for the ``None``
    inputs); an input no output reaches gets zeros."""
    xs = [None if t is None else t.detach().requires_grad_(True)
          for t in inputs]
    wrt = [x for x in xs if x is not None]
    with torch.enable_grad():
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        # an output that no input reaches (WKV's final state from u)
        # adds nothing
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if o.requires_grad and g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    out = []
    for x in xs:
        g = None if x is None else next(got)
        out.append(torch.zeros_like(x) if x is not None and g is None else g)
    return out


def _autograd_of(formula: Callable) -> Callable:
    """The backward that differentiates ``formula`` by autograd:
    ``(inputs, output grads, *options) -> input grads``."""
    return lambda xs, grads, *options: _grads_of(
        lambda *ts: formula(*ts, *options), xs, grads)


#: each operator's backward on a real device, by name
_BACKWARDS: dict[str, Callable] = {}


def backward(name: str, inputs: tuple, grads: tuple,
             options: tuple = ()) -> list:
    """What the backward of ``repro_torch::<name>`` returns for the
    saved tensor ``inputs``, the output gradients ``grads`` and the
    operator's other arguments ``options``: each input's gradient
    (``None`` for a ``None`` input)."""
    return _BACKWARDS[name](inputs, grads, *options)


def _define(name: str, cpu: Callable, cuda: Callable, fake: Callable,
            flops: Callable, backward_of: Callable, n_args: int):
    """Register ``repro_torch::<name>``: its CPU implementation ``cpu``
    (the plain version; its annotations give the schema), its CUDA one
    ``cuda`` (the kernel), its ``fake``, its FLOPs, and an autograd
    formula whose backward is ``backward_of(inputs, output grads,
    *options)`` on the saved tensor inputs (the first ``n_args``); and
    the meta stand-in ``repro_torch::<name>_grad`` of that backward."""
    _BACKWARDS[name] = backward_of
    op = torch.library.custom_op(f"repro_torch::{name}", cpu,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    register_flop_formula(getattr(torch.ops.repro_torch, name))(
        lambda *args, out_shape=None, **kw: flops(*args))

    def stand_in(inputs: list[Tensor], grads: list[Tensor], traffic: int,
                 held_cuda: int, held_cpu: int, flops: int) -> list[Tensor]:
        raise RuntimeError(f"repro_torch::{name}_grad stands in for "
                           "the backward on the meta device only")

    grad_op = torch.library.custom_op(f"repro_torch::{name}_grad",
                                      stand_in, mutates_args=(),
                                      device_types="cpu")
    grad_op.register_fake(lambda inputs, grads, *counts:
                          [torch.empty_like(x) for x in inputs])
    register_flop_formula(getattr(torch.ops.repro_torch, f"{name}_grad"))(
        lambda inputs, grads, traffic, held_cuda, held_cpu, flops,
        out_shape=None, **kw: flops)

    def setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_args])
        ctx.options = inputs[n_args:]

    def through(ctx, *grads):
        xs = ctx.saved_tensors
        if xs[0].device.type != "meta":
            with spans.span(f"kernels.{name}.backward"):
                got = backward_of(xs, grads, *ctx.options)
        else:
            args = (name, [None if x is None else x.shape for x in xs],
                    xs[0].dtype, ctx.options)
            given = iter(grad_op([x for x in xs if x is not None],
                                 list(grads), grad_traffic(*args),
                                 grad_workspace(*args, "cuda"),
                                 grad_workspace(*args, "cpu"),
                                 grad_flops(name, args[1], ctx.options)))
            got = [None if x is None else next(given) for x in xs]
        need = ctx.needs_input_grad
        return tuple(g if need[i] else None for i, g in enumerate(got)) \
            + (None,) * len(ctx.options)

    op.register_autograd(through, setup_context=setup)
    return op


# -- K1 -------------------------------------------------------------------------


def _attention_cpu(q: Tensor, k: Tensor, v: Tensor, window: int | None,
                   softcap: float | None) -> Tensor:
    return ref.attention_ref(q, k, v, window=window, softcap=softcap)


def _attention_cuda(q, k, v, window, softcap):
    return _fa.flash_attention(q, k, v, window=window, softcap=softcap)


_attention = _define(
    "flash_attention", _attention_cpu, _attention_cuda,
    lambda q, k, v, window, softcap: torch.empty_like(q),
    lambda q, k, v, window, softcap: attention_flops(
        q[0], q[1], q[2], q[3], window),
    lambda xs, grads, window, softcap: _grad.attention_grads(
        *xs, grads[0], window, softcap), 3)


def attention(q: Tensor, k: Tensor, v: Tensor, *,
              window: int | None = None,
              softcap: float | None = None) -> Tensor:
    """Causal GQA attention.  q: (B, S, H, D); k, v: (B, S, KV, D)."""
    return _attention(q, k, v, window, softcap)


# -- K4 -------------------------------------------------------------------------


def _decode_cpu(q: Tensor, k_cache: Tensor, v_cache: Tensor, pos: Tensor,
                softcap: float | None) -> Tensor:
    return ref.decode_attention_ref(q, k_cache, v_cache, pos,
                                    softcap=softcap)


def _decode_cuda(q, k_cache, v_cache, pos, softcap):
    return _fd.flash_decode(q, k_cache, v_cache, pos, softcap=softcap)


_decode = torch.library.custom_op("repro_torch::flash_decode", _decode_cpu,
                                  mutates_args=(), device_types="cpu")
_decode.register_kernel("cuda")(_decode_cuda)
_decode.register_fake(lambda q, k_cache, v_cache, pos, softcap:
                      q.new_empty(q.shape, dtype=v_cache.dtype))
register_flop_formula(torch.ops.repro_torch.flash_decode)(
    lambda q, k_cache, v_cache, pos, softcap, out_shape=None, **kw:
    decode_flops(q[0], q[2], k_cache[1], q[3]))


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     pos: Tensor, *, softcap: float | None = None) -> Tensor:
    """One-token GQA attention against a cache, ring or linear (the slots
    ``<= pos`` are valid in both).  q: (B, 1, H, D); caches:
    (B, Sc, KV, D); ``pos`` on q's device, scalar or (B,).  Returns
    (B, 1, H, D) in the cache's dtype."""
    return _decode(q, k_cache, v_cache, pos, softcap)


# -- K2 -------------------------------------------------------------------------


def _rglru_plain(a: Tensor, b: Tensor, h0: Tensor | None
                 ) -> tuple[Tensor, Tensor]:
    h = ref.rglru_ref(a, b, h0)
    return h, h[:, -1]


def _rglru_cpu(a: Tensor, b: Tensor, h0: Tensor | None
               ) -> tuple[Tensor, Tensor]:
    h, last = _rglru_plain(a, b, h0)
    return h, last.clone()      # an operator's outputs do not alias


def _rglru_cuda(a, b, h0):
    return _rglru.rglru_scan(a, b, h0)


def _rglru_fake(a, b, h0):
    B, S, R = a.shape
    return (a.new_empty((B, S, R), dtype=torch.float32),
            a.new_empty((B, R), dtype=torch.float32))


_rglru_op = _define(
    "rglru_scan", _rglru_cpu, _rglru_cuda, _rglru_fake,
    lambda a, b, h0: scan_flops(*a), _autograd_of(_grad.associative_scan),
    3)


def rglru(a: Tensor, b: Tensor, h0: Tensor | None = None
          ) -> tuple[Tensor, Tensor]:
    """The linear scan h_t = a_t h_{t−1} + b_t.  a, b: (B, S, R); h0:
    (B, R) or None.  Returns (h (B, S, R), h_final (B, R)), fp32."""
    return _rglru_op(a, b, h0)


# -- K3 -------------------------------------------------------------------------


def _wkv_cpu(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
             s0: Tensor | None, chunk: int) -> tuple[Tensor, Tensor]:
    return ref.wkv6_ref(r, k, v, w, u, s0)


def _wkv_cuda(r, k, v, w, u, s0, chunk):
    return _wkv6.wkv6(r, k, v, w, u, s0, chunk=chunk)


def _wkv_fake(r, k, v, w, u, s0, chunk):
    B, H, S, N = r.shape
    return (r.new_empty((B, H, S, N), dtype=torch.float32),
            r.new_empty((B, H, N, N), dtype=torch.float32))


_wkv_op = _define(
    "wkv6", _wkv_cpu, _wkv_cuda, _wkv_fake,
    lambda r, k, v, w, u, s0, chunk: wkv_flops(*r),
    _autograd_of(_grad.chunked_wkv), 6)


def wkv(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
        s0: Tensor | None = None, *, chunk: int = 16
        ) -> tuple[Tensor, Tensor]:
    """The RWKV-6 WKV.  r, k, v, w: (B, H, S, N); u: (H, N); s0:
    (B, H, N, N) or None.  Returns (y (B, H, S, N), s_final (B, H, N, N)),
    fp32.  ``chunk`` is the kernel's chunk length; the plain version walks
    the recurrence step by step."""
    return _wkv_op(r, k, v, w, u, s0, chunk)
