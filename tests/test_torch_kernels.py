"""The port's attention against the reference: on the CPU the port's
:func:`repro_torch.kernels.ops.attention` runs its plain version, held
against ``repro.kernels.ref.attention_ref`` and against the Pallas kernel
in interpret mode, over the sweep of ``tests/test_kernels.py`` with its
tolerances.  The CUDA kernel itself is held against the plain version
in the ``gpu``-marked tests, which need a card.  JAX is imported inside
the CPU tests only: the machine with the card has none."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str) -> dict:
    # tests/test_kernels.py: bf16 rounds each output to 8 bits of
    # mantissa; f32 differs only in summation order
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(B, S, H, K, D, *, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32) * scale
    k = rng.standard_normal((B, S, K, D), dtype=np.float32) * scale
    v = rng.standard_normal((B, S, K, D), dtype=np.float32)
    return q, k, v


def _both(arrays, dtype: str):
    """The same numpy inputs as JAX arrays and torch CPU tensors in
    ``dtype`` (both round float32 to bfloat16 to nearest even)."""
    import jax.numpy as jnp
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays])


def _reference(name, q, k, v, **kw):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    if name == "ref":
        return jref.attention_ref(q, k, v, **kw)
    return jops.attention(q, k, v, impl="interpret", block_q=64,
                          block_k=64, **kw)


def _assert_close(o_port, o_ref, tol):
    np.testing.assert_allclose(o_port.float().numpy(),
                               np.asarray(o_ref, np.float32), **tol)


@pytest.mark.parametrize("reference", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 256, 4, 1, 128),     # MQA
    (2, 128, 2, 2, 128),
])
def test_attention_shapes(B, S, H, K, D, dtype, reference):
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(B, S, H, K, D), dtype)
    o = ops.attention(qt, kt, vt)
    assert o.dtype == DTYPES[dtype] and o.shape == (B, S, H, D)
    _assert_close(o, _reference(reference, qj, kj, vj), _tol(dtype))


@pytest.mark.parametrize("reference", ["ref", "interpret"])
@pytest.mark.parametrize("window", [64, 128])
def test_attention_window(window, reference):
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(2, 256, 4, 2, 64),
                                       "float32")
    o = ops.attention(qt, kt, vt, window=window)
    _assert_close(o, _reference(reference, qj, kj, vj, window=window),
                  _tol("float32"))


@pytest.mark.parametrize("reference", ["ref", "interpret"])
def test_attention_softcap(reference):
    (qj, kj, vj), (qt, kt, vt) = _both(
        _inputs(1, 128, 4, 2, 64, scale=3.0), "float32")
    o = ops.attention(qt, kt, vt, softcap=20.0)
    _assert_close(o, _reference(reference, qj, kj, vj, softcap=20.0),
                  _tol("float32"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (None, 20.0)])
def test_attention_ragged(window, softcap, dtype):
    """S = 24 is no multiple of any block: the reference kernel cannot
    take it, the port (and its kernel) must."""
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(2, 24, 8, 2, 64, seed=3),
                                       dtype)
    o = ops.attention(qt, kt, vt, window=window, softcap=softcap)
    _assert_close(o, _reference("ref", qj, kj, vj, window=window,
                                softcap=softcap), _tol(dtype))


def test_cpu_path_launches_no_kernel():
    """On the CPU the wrapper takes the plain version, and only there."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 64))
    before = fa.launches
    torch.testing.assert_close(ops.attention(q, k, v),
                               ref.attention_ref(q, k, v))
    assert fa.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel is "
                    "CUDA C++ for sm_90a and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,K,D,window,softcap", [
    (1, 32, 32, 8, 64, None, None),       # the serving path's prefill
    (2, 256, 8, 2, 64, None, None),
    (1, 256, 4, 1, 128, None, None),
    (2, 256, 4, 2, 64, 64, None),
    (1, 128, 4, 2, 64, None, 20.0),
    (1, 200, 8, 2, 128, 48, 20.0),        # ragged, window and softcap
])
def test_kernel_matches_plain(cuda, B, S, H, K, D, window, softcap, dtype):
    td = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda, td)
               for a in _inputs(B, S, H, K, D))
    before = fa.launches
    o = ops.attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref = ref.attention_ref(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol(dtype))
