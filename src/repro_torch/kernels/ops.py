"""Dispatch between each kernel and its plain version, by device.

Each kernel is a PyTorch custom operator (``torch.library.custom_op``):
``repro_torch::flash_attention`` (K1), ``repro_torch::rglru_scan`` (K2)
and ``repro_torch::wkv6`` (K3).  Its CPU implementation is the plain
PyTorch version in :mod:`.ref` (the CPU tests, and the truth the kernels
are held against); its CUDA implementation is the hand-written kernel,
and if the kernel cannot be built or launched the call raises — nothing
falls back to the plain version on the card.  On the meta device (the
dry-run of :mod:`repro_torch.launch.cells`) the operator's fake returns
outputs of the right shapes and runs nothing.  Mirrors
:mod:`repro.kernels.ops`, whose ``impl=`` switch this replaces.

Being operators, the kernel calls are what ``FlopCounterMode`` and the
dry-run's dispatch modes see: each is counted by its analytic FLOPs
(:func:`attention_flops`, :func:`scan_flops`, :func:`wkv_flops`), the
same on the card, on the CPU and on meta, and a selective-checkpoint
policy sees each kernel call as one op.

Gradients.  Each kernel computes a forward only, as its TPU counterpart
does: the JAX package has no backward kernel, and its train step
differentiates the XLA formula.  So each operator's autograd formula
recomputes the plain version from :mod:`.ref` on the saved inputs and
returns the gradients of that recomputation.  This is no fallback: the
forward on the card is always the kernel (its launch count shows it),
and a gradient is a different function from the kernel's, for which
neither package has a kernel.  On meta the recomputation is stood in
for by ``repro_torch::<op>_plain_grad``, a meta-only operator that
counts the plain version's products (:func:`plain_grad_flops`) and
carries its traffic (:func:`plain_grad_traffic`) and its working set
on the card and on the CPU (:func:`plain_grad_workspace`) as arguments,
which :class:`repro_torch.launch.roofline.StepMeter` counts, so that
the dry-run's counts are those of the backward pass it models.
"""

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

from . import flash_attention as _fa
from . import ref
from . import rglru as _rglru
from . import wkv6 as _wkv6

__all__ = ["attention", "wkv", "rglru", "attention_pairs",
           "attention_flops", "scan_flops", "wkv_flops", "plain_grad_flops",
           "plain_grad_workspace", "plain_grad_traffic"]

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


def scan_flops(B: int, S: int, R: int) -> int:
    """K2's work: a multiply and an add per step and channel."""
    return 2 * B * S * R


def wkv_flops(B: int, H: int, S: int, N: int) -> int:
    """K3's work a token and head: y_t = r_t S + (r_t·(u⊙k_t)) v_t and
    S = w_t⊙S + k_tᵀv_t, 5·N² + 5·N."""
    return B * H * S * (5 * N * N + 5 * N)


def plain_grad_flops(op: str, shapes: list) -> int:
    """The products that ``FlopCounterMode`` counts in the plain
    version's recomputation and its gradient, given the shapes of the
    operator's inputs: attention's two einsums over the full S × S
    scores, once forward and twice backward (12·B·H·S²·D); the WKV's
    ``r_t S`` a step, likewise (6·B·H·S·N²); the scan has none."""
    if op == "flash_attention":
        B, S, H, D = shapes[0]
        return 12 * B * H * S * S * D
    if op == "wkv6":
        B, H, S, N = shapes[0]
        return 6 * B * H * S * N * N
    return 0


def plain_grad_workspace(op: str, shapes: list, dtype: torch.dtype,
                         options: tuple = (), device: str = "cuda") -> int:
    """Bytes the plain version's recomputation and its gradient hold at
    their peak beyond the operator's inputs, the output gradients and
    the input gradients, given the shapes of the inputs, their dtype,
    the operator's other arguments and the device (measured around the
    plain backward: on the card with ``max_memory_allocated`` by
    ``chip_smoke.py`` phase 22, on the CPU by
    :class:`repro_torch.launch.roofline.StepMeter` in
    ``tests/test_torch_dryrun.py``).  Attention: (B, H, S, S) float32
    score-sized tensors — three at once on the CPU (the saved
    probabilities, their gradient and the scores'), five on the card,
    where the batched products copy their permuted score-sized operands
    inside the operator — and one more with a softcap (its saved tanh);
    two q-sized and two k-sized float32 temporaries, and float32 copies
    of q, k and v where they are not float32.  The scan: five float32
    (B, S, R) on the CPU, four on the card.  The WKV: about three
    (B, H, N, N) float32 states saved at every step, and float32 copies
    of r, k and v where they are not float32."""
    f32 = dtype == torch.float32
    card = device != "cpu"
    if op == "flash_attention":
        (B, S, H, D), (_, _, KV, _) = shapes[0], shapes[1]
        softcap = options[1] if len(options) > 1 else None
        xq, xkv = 4 * B * S * H * D, 4 * B * S * KV * D
        scores = ((5 if card else 3) + (softcap is not None)) \
            * 4 * B * H * S * S
        return scores + 2 * xq + 2 * xkv + (0 if f32 else xq + 2 * xkv)
    if op == "rglru_scan":
        B, S, R = shapes[0]
        return (4 if card else 5) * 4 * B * S * R
    B, H, S, N = shapes[0]
    return 3 * 4 * B * H * S * N * N + (0 if f32 else 3 * 4 * B * H * S * N)


def plain_grad_traffic(op: str, shapes: list, dtype: torch.dtype,
                       options: tuple = ()) -> int:
    """Bytes the plain version's recomputation and its gradient read and
    write, operator by operator, as
    :class:`repro_torch.launch.roofline.StepMeter` counts them around
    the plain backward on the CPU (a fit, held within 10 % by
    ``tests/test_torch_dryrun.py``).  Attention: about 21 passes over
    the (B, H, S, S) float32 scores, 14 more with a softcap, and 13 over
    q's float32 size; the scan and the WKV write each step
    into a slice of their whole output, whose gradient every step then
    reads: 11·S passes over a float32 (B, S, R) for the scan, and
    38 + 19·S/N over the (B, H, S, N, N) float32 states for the WKV."""
    if op == "flash_attention":
        (B, S, H, D) = shapes[0]
        capped = len(options) > 1 and options[1] is not None
        return (21 + 14 * capped) * 4 * B * H * S * S + 13 * 4 * B * S * H * D
    if op == "rglru_scan":
        B, S, R = shapes[0]
        return 11 * S * 4 * B * S * R
    B, H, S, N = shapes[0]
    return (38 * N + 19 * S) * 4 * B * H * S * N


def _plain_grads(plain: Callable, inputs: tuple, grads: tuple) -> list:
    """Gradients of ``plain(*inputs)`` for the output gradients
    ``grads``, with respect to each tensor of ``inputs`` (``None`` for
    the ``None`` inputs); an input no output reaches gets zeros."""
    xs = [None if t is None else t.detach().requires_grad_(True)
          for t in inputs]
    wrt = [x for x in xs if x is not None]
    with torch.enable_grad():
        outs = plain(*xs)
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


def _define(name: str, cpu: Callable, cuda: Callable, fake: Callable,
            flops: Callable, plain: Callable, n_args: int):
    """Register ``repro_torch::<name>``: its CPU implementation ``cpu``
    (the plain version; its annotations give the schema), its CUDA one
    ``cuda`` (the kernel), its ``fake``, its FLOPs, and an autograd
    formula whose backward recomputes ``plain`` on the saved tensor
    inputs (the first ``n_args``); and the meta stand-in
    ``repro_torch::<name>_plain_grad`` of that backward."""
    op = torch.library.custom_op(f"repro_torch::{name}", cpu,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    register_flop_formula(getattr(torch.ops.repro_torch, name))(
        lambda *args, out_shape=None, **kw: flops(*args))

    def stand_in(inputs: list[Tensor], grads: list[Tensor], traffic: int,
                 held_cuda: int, held_cpu: int) -> list[Tensor]:
        raise RuntimeError(f"repro_torch::{name}_plain_grad stands in for "
                           "the plain backward on the meta device only")

    grad_op = torch.library.custom_op(f"repro_torch::{name}_plain_grad",
                                      stand_in, mutates_args=(),
                                      device_types="cpu")
    grad_op.register_fake(lambda inputs, grads, *counts:
                          [torch.empty_like(x) for x in inputs])
    register_flop_formula(
        getattr(torch.ops.repro_torch, f"{name}_plain_grad"))(
        lambda inputs, grads, *counts, out_shape=None, **kw:
        plain_grad_flops(name, inputs))

    def setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_args])
        ctx.options = inputs[n_args:]

    def backward(ctx, *grads):
        xs = ctx.saved_tensors
        if xs[0].device.type != "meta":
            got = _plain_grads(lambda *ts: plain(*ts, *ctx.options), xs,
                               grads)
        else:
            args = (name, [None if x is None else x.shape for x in xs],
                    xs[0].dtype, ctx.options)
            given = iter(grad_op([x for x in xs if x is not None],
                                 list(grads), plain_grad_traffic(*args),
                                 plain_grad_workspace(*args, "cuda"),
                                 plain_grad_workspace(*args, "cpu")))
            got = [None if x is None else next(given) for x in xs]
        need = ctx.needs_input_grad
        return tuple(g if need[i] else None for i, g in enumerate(got)) \
            + (None,) * len(ctx.options)

    op.register_autograd(backward, setup_context=setup)
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
    _attention_cpu, 3)


def attention(q: Tensor, k: Tensor, v: Tensor, *,
              window: int | None = None,
              softcap: float | None = None) -> Tensor:
    """Causal GQA attention.  q: (B, S, H, D); k, v: (B, S, KV, D)."""
    return _attention(q, k, v, window, softcap)


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
    lambda a, b, h0: scan_flops(*a), _rglru_plain, 3)


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
    lambda r, k, v, w, u, s0, chunk: ref.wkv6_ref(r, k, v, w, u, s0), 6)


def wkv(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
        s0: Tensor | None = None, *, chunk: int = 16
        ) -> tuple[Tensor, Tensor]:
    """The RWKV-6 WKV.  r, k, v, w: (B, H, S, N); u: (H, N); s0:
    (B, H, N, N) or None.  Returns (y (B, H, S, N), s_final (B, H, N, N)),
    fp32.  ``chunk`` is the kernel's chunk length; the plain version walks
    the recurrence step by step."""
    return _wkv_op(r, k, v, w, u, s0, chunk)
