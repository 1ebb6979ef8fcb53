"""The port's layers against the reference's on the CPU: the same numpy
inputs through :mod:`repro.models.layers` and
:mod:`repro_torch.models.layers`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    # bf16 outputs may round to neighbouring values; f32 differs only in
    # the order of sums
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(DTYPES[dtype][0])


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a)).to(DTYPES[dtype][1])


def _close(o_t, o_j, tol):
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64, scale=3.0), _rand(rng, 64, scale=0.1)
    o = tl.rmsnorm(_t(x, dtype), _t(w, dtype), 1e-6)
    assert o.dtype == DTYPES[dtype][1]
    _close(o, jl.rmsnorm(_j(x, dtype), _j(w, dtype), 1e-6), _tol(dtype))


@pytest.mark.parametrize("pos_shape", ["sequence", "per_slot"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope(dtype, pos_shape):
    rng = np.random.default_rng(1)
    if pos_shape == "sequence":
        x = _rand(rng, 2, 12, 4, 16)
        pos = np.arange(12, dtype=np.int32) + 3
    else:                                   # decode: (B, 1) positions
        x = _rand(rng, 3, 1, 4, 16)
        pos = np.array([[0], [7], [100]], np.int32)
    o = tl.rope(_t(x, dtype), torch.from_numpy(pos), 500_000.0)
    assert o.dtype == DTYPES[dtype][1]
    _close(o, jl.rope(_j(x, dtype), jnp.asarray(pos), 500_000.0),
           _tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("branch,window,q_chunk", [
    ("direct", None, 512),
    ("direct-window", 8, 512),
    ("chunked-global", None, 16),
    ("chunked-local", 16, 16),
])
def test_gqa_attention(branch, window, q_chunk, dtype):
    """The reference picks a branch by S and q_chunk; the port has one
    path (the flash kernel on the card, its plain version here)."""
    rng = np.random.default_rng(2)
    B, S, H, K, D = 2, 64, 8, 2, 16
    q, k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, K, D), \
        _rand(rng, B, S, K, D)
    o_j = jl.gqa_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                           window=window, q_chunk=q_chunk)
    o_t = tl.gqa_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                           window=window)
    assert o_t.shape == (B, S, H, D)
    _close(o_t, o_j, _tol(dtype))


@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("pos_kind,ring", [
    ("scalar", False), ("scalar", True), ("vector", False),
    ("vector", True),
])
def test_decode_gqa_attention(pos_kind, ring, softcap):
    rng = np.random.default_rng(3)
    B, Sc, H, K, D = 3, 16, 8, 2, 16
    q = _rand(rng, B, 1, H, D, scale=2.0)
    kc, vc = _rand(rng, B, Sc, K, D, scale=2.0), _rand(rng, B, Sc, K, D)
    if pos_kind == "scalar":
        pos = np.int32(21 if ring else 9)
    else:        # a ring wraps past Sc; a linear cache stays inside it
        pos = np.array([3, 21, 40] if ring else [0, 9, 15], np.int32)
    # the cache is bf16, as the model stores it
    o_j = jl.decode_gqa_attention(_j(q), _j(kc, "bfloat16"),
                                  _j(vc, "bfloat16"), jnp.asarray(pos),
                                  ring=ring, softcap=softcap)
    o_t = tl.decode_gqa_attention(_t(q), _t(kc, "bfloat16"),
                                  _t(vc, "bfloat16"), torch.as_tensor(pos),
                                  ring=ring, softcap=softcap)
    assert o_t.dtype == torch.bfloat16 and o_t.shape == (B, 1, H, D)
    _close(o_t, o_j, _tol("bfloat16"))


#: (pos of the three slots, ring, softcap) of each decode case: a softcap
#: (gemma2-9b's 50) inside the ring, a ring wrapped past Sc, and a
#: "dead" slot whose position ran far past the ring
DECODE_CASES = {"softcap": ([0, 9, 15], True, 50.0),
                "wrap": ([3, 21, 40], True, None),
                "dead": ([7, 1016, 15], True, None)}


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("G", [1, 6, 10])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_gqa_attention_shapes(D, G, case):
    """The decode operator's CPU path (K4's plain version) against the
    reference at every head_dim K4 takes and at group sizes 1, 6
    (mixtral-8x22b) and 10 (recurrentgemma-2b)."""
    pos, ring, softcap = DECODE_CASES[case]
    rng = np.random.default_rng(D + G)
    B, Sc, K = 3, 16, 2
    H = K * G
    q = _rand(rng, B, 1, H, D, scale=2.0)
    kc, vc = _rand(rng, B, Sc, K, D, scale=2.0), _rand(rng, B, Sc, K, D)
    pos = np.array(pos, np.int32)
    o_j = jl.decode_gqa_attention(_j(q, "bfloat16"), _j(kc, "bfloat16"),
                                  _j(vc, "bfloat16"), jnp.asarray(pos),
                                  ring=ring, softcap=softcap)
    o_t = tl.decode_gqa_attention(_t(q, "bfloat16"), _t(kc, "bfloat16"),
                                  _t(vc, "bfloat16"), torch.as_tensor(pos),
                                  ring=ring, softcap=softcap)
    assert o_t.dtype == torch.bfloat16 and o_t.shape == (B, 1, H, D)
    _close(o_t, o_j, _tol("bfloat16"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(kind, dtype):
    rng = np.random.default_rng(4)
    d, ff = 32, 64
    x = _rand(rng, 2, 5, d)
    p = {"w1": _rand(rng, d, ff, scale=d ** -0.5),
         "w2": _rand(rng, ff, d, scale=ff ** -0.5),
         "w3": _rand(rng, d, ff, scale=d ** -0.5)}
    o_j = jl.mlp_apply(_j(x, dtype), {n: _j(a, dtype) for n, a in
                                      p.items()}, kind)
    o_t = tl.mlp_apply(_t(x, dtype), {n: _t(a, dtype) for n, a in
                                      p.items()}, kind)
    _close(o_t, o_j, _tol(dtype))


def test_init_scales_and_shapes():
    """The port's init draws its own numbers; it keeps the reference's
    shapes, zero norms and 1/sqrt(fan-in) scales."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("llama3.2-1b").replace(d_model=256, d_ff=512)
    g = torch.Generator().manual_seed(0)
    layer = tl.init_attn_layer(g, cfg, dtype=torch.float32, device="cpu")
    H, K, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    assert layer.wq.shape == (256, H * D) and layer.wk.shape == (256, K * D)
    assert layer.wo.shape == (H * D, 256)
    assert layer.mlp.w2.shape == (512, 256)
    assert not layer.ln1.any() and not layer.ln2.any()
    for w, fan_in in ((layer.wq, 256), (layer.wo, H * D),
                      (layer.mlp.w1, 256), (layer.mlp.w2, 512)):
        assert w.std().item() == pytest.approx(fan_in ** -0.5, rel=0.1)
