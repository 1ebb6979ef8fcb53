"""The kernel operators' gradients against the reference's, on the CPU.

The JAX package trains through the model code around each kernel's call
site, not through the kernel: query-chunked ``gqa_attention``, the
associative ``rglru_scan`` and ``wkv6_chunked``.  The port's operators
differentiate torch ports of those formulas (``kernels/grad.py``).  Here
each formula and each operator's gradient is held against ``jax.grad`` of
the reference's own function, for a seeded random linear functional of
the outputs, with the same numpy inputs on both sides; and the backward's
costs are held to their shape: no plain version of ``kernels/ref.py``
runs in a backward, attention's working set is bounded by its query
chunk, and the operators the scan's and the WKV's backwards dispatch grow
as log₂S and S/chunk.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro_torch.kernels import grad, ops, ref
from repro_torch.launch.roofline import StepMeter

#: float32 gradients, as a share of each gradient's largest magnitude:
#: attention and the scan differ from the reference only in summation
#: order; the WKV as tests/test_kernels.py holds its forward
F32_TOL = {"attention": 1e-5, "scan": 1e-5, "wkv": 1e-4}
#: bfloat16 attention: both sides round to 8 bits of mantissa, the
#: reference also its probabilities before the PV product
BF16_TOL = 2e-2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _coefficients(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_grads(fn, arrays, coefs):
    """``jax.grad`` of Σ coef · output (float32) with respect to each
    array (``None`` entries are passed through as ``None``)."""
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def loss(*xs):
        args = list(arrays)
        for i, x in zip(idx, xs):
            args[i] = x
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o.astype(jnp.float32) * c).sum()
                   for o, c in zip(outs, coefs))
    got = jax.jit(jax.grad(loss, argnums=tuple(range(len(idx)))))(
        *[arrays[i] for i in idx])
    return [np.asarray(g, np.float32) for g in got]


def _torch_grads(fn, tensors, coefs):
    """Autograd of Σ coef · output with respect to each tensor (zeros for
    one that no output reaches)."""
    xs = [None if t is None else t.detach().clone().requires_grad_(True)
          for t in tensors]
    wrt = [x for x in xs if x is not None]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(outs, coefs))
    got = torch.autograd.grad(loss, wrt, allow_unused=True)
    return [np.zeros(x.shape, np.float32) if g is None
            else g.float().numpy() for x, g in zip(wrt, got)]


def _assert_close(got, want, tol, what=""):
    """Each gradient within ``tol`` of its largest magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (what, i, err, scale)


# -- K1: gqa_attention ------------------------------------------------------


def _attention_arrays(S, G, dtype, seed, K=2, D=32):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((1, S, n, D)).astype(np.float32)
              for n in (K * G, K, K)]
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays])


VARIANTS = {"global": (None, None), "window": (64, None),
            "softcap": (None, 30.0)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("S", [1024, 1536])
def test_attention_gradient_is_the_references(S, variant, G, dtype):
    """The formula and the operator against ``jax.grad`` of the
    reference's ``gqa_attention`` (two and three query chunks)."""
    window, softcap = VARIANTS[variant]
    jx, tx = _attention_arrays(S, G, dtype, seed=S + G)
    coefs = _coefficients([(1, S, 2 * G, 32)], seed=1)
    want = _jax_grads(lambda q, k, v: jlayers.gqa_attention(
        q, k, v, window=window, softcap=softcap), jx, coefs)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL["attention"]
    formula = _torch_grads(lambda q, k, v: grad.chunked_attention(
        q, k, v, window, softcap), tx, coefs)
    _assert_close(formula, want, tol, "formula")
    op = _torch_grads(lambda q, k, v: ops.attention(
        q, k, v, window=window, softcap=softcap), tx, coefs)
    _assert_close(op, want, tol, "operator")


@pytest.mark.parametrize("S,window,softcap", [
    (1100, 64, None), (600, None, 30.0), (1030, 700, None), (513, None, None)])
def test_ragged_attention_gradient_is_the_plain_versions(S, window, softcap):
    """A short last query chunk (the reference asserts whole chunks):
    against the gradient of the plain version, in float32."""
    _, tx = _attention_arrays(S, 2, "float32", seed=S)
    coefs = _coefficients([(1, S, 4, 32)], seed=2)
    want = _torch_grads(lambda q, k, v: ref.attention_ref(
        q, k, v, window=window, softcap=softcap), tx, coefs)
    for fn in (lambda q, k, v: grad.chunked_attention(q, k, v, window,
                                                      softcap),
               lambda q, k, v: ops.attention(q, k, v, window=window,
                                             softcap=softcap)):
        _assert_close(_torch_grads(fn, tx, coefs), want,
                      F32_TOL["attention"])


def test_attention_grads_are_the_formulas():
    """The operator's chunk-by-chunk backward, with the softmax's
    derivative written out, equals autograd through the checkpointed
    formula within float32 rounding, on a local layer with a softcap."""
    _, (q, k, v) = _attention_arrays(1100, 2, "float32", seed=5)
    go = torch.randn((1, 1100, 4, 32), generator=torch.Generator()
                     .manual_seed(0))
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(grad.chunked_attention(*xs, 64, 20.0), xs, go)
    got = grad.attention_grads(q, k, v, go, 64, 20.0)
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want],
                  F32_TOL["attention"])


# -- K2: rglru_scan ---------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 2, 17, 64, 1000])
def test_scan_gradient_is_the_references(S, with_h0):
    """The associative scan and the operator against ``jax.grad`` of the
    reference's ``rglru_scan``."""
    rng = np.random.default_rng(S)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, S, 16))))).astype(
        np.float32)
    b = (rng.standard_normal((2, S, 16)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) \
        if with_h0 else None
    arrays = [a, b, h0]
    coefs = _coefficients([(2, S, 16)], seed=3)
    want = _jax_grads(jrglru.rglru_scan,
                      [None if x is None else jnp.asarray(x)
                       for x in arrays], coefs)
    tensors = [None if x is None else torch.from_numpy(x) for x in arrays]
    for fn in (grad.associative_scan, ops.rglru):
        got = _torch_grads(lambda *x: fn(*x)[0], tensors, coefs)
        _assert_close(got, want, F32_TOL["scan"], fn.__name__)


def test_associative_scan_equals_the_recurrence():
    """Its output is the plain version's within float32 rounding."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 1000, 8), generator=g)
    b = torch.randn((2, 1000, 8), generator=g)
    h0 = torch.randn((2, 8), generator=g)
    h, last = grad.associative_scan(a, b, h0)
    want = ref.rglru_ref(a, b, h0)
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(last, h[:, -1])


# -- K3: wkv6_chunked -------------------------------------------------------


def _wkv_arrays(S, seed, with_s0, decay=None, B=1, H=2, N=64):
    """As tests/test_kernels.py makes them: r, k, v × 0.5, w =
    exp(−exp(n − 1)) (or the constant ``decay``), u × 0.1, s0 × 0.5."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, H, S, N)) - 1.0))
    if decay is not None:
        w = np.full_like(w, decay)
    u = rng.standard_normal((H, N)) * 0.1
    s0 = rng.standard_normal((B, H, N, N)) * 0.5
    return [a.astype(np.float32) for a in (r, k, v, w, u)] \
        + [s0.astype(np.float32) if with_s0 else None]


#: the decays below which w's gradient is held as w ⊙ ∂/∂w
W_SPLIT = 0.05


def _wkv_grads(arrays, chunk, reference):
    """The reference's, the formula's and the operator's gradients, w's
    split in two: ∂/∂w where w ≥ ``W_SPLIT`` and, below, w ⊙ ∂/∂w (its
    gradient with respect to log w), each zero elsewhere.  The chunked
    form takes log w, so ∂/∂w divides its rounding by w, by up to 1e9
    here; at w ≥ 0.05 by at most 20."""
    B, H, S, N = arrays[0].shape
    coefs = _coefficients([(B, H, S, N), (B, H, N, N)], seed=4)
    want = _jax_grads(reference, [None if x is None else jnp.asarray(x)
                                  for x in arrays], coefs)
    tensors = [None if x is None else torch.from_numpy(x) for x in arrays]
    got = [_torch_grads(lambda *x: grad.chunked_wkv(*x, chunk=chunk),
                        tensors, coefs),
           _torch_grads(lambda *x: ops.wkv(*x, chunk=chunk), tensors,
                        coefs)]
    big = arrays[3] >= W_SPLIT
    for grads in [want] + got:
        dw = grads[3]
        grads[3:4] = [np.where(big, dw, 0.0), np.where(big, 0.0,
                                                       dw * arrays[3])]
    return want, got


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 100])
def test_wkv_gradient_is_the_references(S, chunk, with_s0):
    """The chunked WKV and the operator against ``jax.grad`` of the
    reference's ``wkv6_chunked`` at the same chunk."""
    arrays = _wkv_arrays(S, seed=S, with_s0=with_s0)
    want, got = _wkv_grads(arrays, chunk, lambda *x: jrwkv.wkv6_chunked(
        *x, chunk=chunk))
    for g in got:
        _assert_close(g, want, F32_TOL["wkv"])


@pytest.mark.parametrize("S", [17, 100])
def test_wkv_gradient_at_no_decay_is_the_references(S):
    """w = 1: every decay exponent sits on the clip's upper bound, where
    ``jnp.clip`` splits the gradient in half; the port's clip splits it
    as JAX does."""
    arrays = _wkv_arrays(S, seed=S, with_s0=True, decay=1.0)
    want, got = _wkv_grads(arrays, 16, lambda *x: jrwkv.wkv6_chunked(
        *x, chunk=16))
    for g in got:
        _assert_close(g, want, F32_TOL["wkv"])


@pytest.mark.parametrize("S", [17, 100])
def test_wkv_gradient_at_the_decay_floor(S):
    """w = 1e-38, clipped before the log.  XLA on the CPU flushes the
    subnormal 1e-38 to 0, so ``wkv6_chunked`` takes log 0 there and its
    gradient is NaN: r, k, v, u and s0's gradients are held against
    ``jax.grad`` of the reference's step-by-step ``wkv6_scan_ref``, which
    differs from the chunked form only below the e^−40 clip, and w's
    must be finite."""
    arrays = _wkv_arrays(S, seed=S, with_s0=True, decay=1e-38)
    want, got = _wkv_grads(arrays, 16, jrwkv.wkv6_scan_ref)
    for g in got:
        assert np.isfinite(g[3]).all() and np.isfinite(g[4]).all()
        del g[3:5]
        _assert_close(g, want[:3] + want[5:], F32_TOL["wkv"])


# -- what the backwards cost ------------------------------------------------


def _operator_cases():
    g = torch.Generator().manual_seed(0)

    def t(*shape, f=None):
        x = torch.randn(shape, generator=g)
        return (x if f is None else f(x)).requires_grad_(True)
    return {
        "attention": lambda: ops.attention(
            t(1, 1100, 4, 16), t(1, 1100, 2, 16), t(1, 1100, 2, 16),
            window=64, softcap=30.0),
        "rglru": lambda: ops.rglru(t(2, 100, 8, f=torch.sigmoid),
                                   t(2, 100, 8), t(2, 8)),
        "wkv": lambda: ops.wkv(
            t(1, 2, 40, 64), t(1, 2, 40, 64), t(1, 2, 40, 64),
            t(1, 2, 40, 64, f=lambda x: torch.exp(-torch.exp(x - 1))),
            t(2, 64), t(1, 2, 64, 64)),
    }


@pytest.mark.parametrize("op", ["attention", "rglru", "wkv"])
def test_no_plain_version_runs_in_a_backward(op, monkeypatch):
    """A spy on every function of ``kernels/ref.py``: the CPU forward
    calls its plain version, the backward none."""
    called = []
    for name in ref.__all__:
        def spy(*a, _fn=getattr(ref, name), _name=name, **k):
            called.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(ref, name, spy)
    outs = _operator_cases()[op]()
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert len(called) == 1
    called.clear()
    sum(o.sum() for o in outs).backward()
    assert called == []


def test_attention_backward_working_set_is_bounded_by_its_chunk():
    """K1's backward at B=1, H=2, S=2048 (four query chunks), under
    :class:`StepMeter` on the CPU: within 10 % of the refitted model
    (``ops.grad_workspace``) and below a fifth of the plain backward's
    (three (B, H, S, S) float32 score tensors)."""
    B, S, H, KV, D = 1, 2048, 2, 1, 16
    g = torch.Generator().manual_seed(0)
    q, k, v, go = (torch.randn((B, S, n, D), generator=g)
                   for n in (H, KV, KV, H))
    meter = StepMeter([q, k, v, go], device="cpu")
    base = meter.live
    with meter:
        got = ops.backward("flash_attention", (q, k, v), (go,),
                           (None, None))
    held = meter.peak - base - sum(x.numel() * 4 for x in got)
    model = ops.grad_workspace("flash_attention", [q.shape, k.shape,
                                                   v.shape],
                               torch.float32, (None, None), device="cpu")
    assert abs(model - held) <= 0.10 * held
    assert held < 3 * 4 * B * H * S * S / 5


class _Count(TorchDispatchMode):
    """Counts the operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(name, S):
    g = torch.Generator().manual_seed(0)
    if name == "rglru_scan":
        inputs = (torch.rand((1, S, 8), generator=g),
                  torch.randn((1, S, 8), generator=g), None)
        grads = (torch.randn((1, S, 8), generator=g), None)
        options = ()
    else:
        inputs = tuple(torch.randn((1, 1, S, 64), generator=g)
                       for _ in range(3)) \
            + (torch.rand((1, 1, S, 64), generator=g),
               torch.randn((1, 64), generator=g), None)
        grads = (torch.randn((1, 1, S, 64), generator=g), None)
        options = (16,)
    with _Count() as count:
        ops.backward(name, inputs, grads, options)
    return count.n


def test_scan_backward_dispatches_log_s_operators():
    """The same number of operators a level of the recursion: as many
    more from S=512 to 2048 as twice from 512 to 1024; and at S=2048
    fewer in all than 2·log₂S levels' worth, itself far below S."""
    n = {S: _backward_ops("rglru_scan", S) for S in (512, 1024, 2048)}
    level = n[1024] - n[512]
    assert 0 < level and n[2048] - n[512] == 2 * level
    assert n[2048] < 2 * math.log2(2048) * level < 2048


def test_wkv_backward_dispatches_s_over_chunk_operators():
    """The same number of operators a chunk: from S=512 to 2048 (32 to
    128 chunks of 16) three times as many more as from 512 to 1024, a
    handful a chunk."""
    n = {S: _backward_ops("wkv6", S) for S in (512, 1024, 2048)}
    per_chunk = (n[1024] - n[512]) / (512 // 16)
    assert n[2048] - n[512] == 3 * (n[1024] - n[512])
    assert 0 < per_chunk <= 12
