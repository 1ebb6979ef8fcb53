"""The port's attention against the reference: on the CPU the port's
:func:`repro_torch.kernels.ops.attention` runs its plain version, held
against ``repro.kernels.ref.attention_ref`` and against the Pallas kernel
in interpret mode, over the sweep of ``tests/test_kernels.py`` with its
tolerances.  The CUDA kernels themselves (K1 flash attention, K2 the
RG-LRU scan, K3 the RWKV-6 WKV) are held against their plain versions in
the ``gpu``-marked tests, which need a card; K1's bf16 kernel (the
tensor cores) also at the S values around its tiles.  Gradients: each
kernel operator's backward (the reference's training formula,
``kernels/grad.py``) against autograd of that formula on the CPU, where
the operator's forward is the plain version run below autograd, and
against the plain version's autograd on the card with the real kernel.
JAX is imported
inside the CPU tests only: the machine with the card has none."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grad, ops, ref
from repro_torch.kernels import rglru as k2
from repro_torch.kernels import wkv6 as k3

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


#: S on each side of the bf16 kernel's tile edges: 64 query rows a
#: warpgroup, 128 a block at D=64 and 128, 64- or 128-key tiles
TILE_EDGES = [1, 63, 64, 65, 127, 128, 129, 2048]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", TILE_EDGES)
def test_attention_tile_edges(S, dtype):
    """The plain version that the card's tests trust, at the S values
    around the kernel's tiles, against the JAX reference."""
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(1, S, 4, 1, 64, seed=S),
                                       dtype)
    o = ops.attention(qt, kt, vt)
    assert o.shape == (1, S, 4, 64)
    _assert_close(o, _reference("ref", qj, kj, vj), _tol(dtype))


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("window", [64, 100])
def test_attention_window_crosses_tiles(window, D):
    """Windows of 64 (a tile) and 100 (across tile edges), bf16."""
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(1, 300, 4, 1, D, seed=D),
                                       "bfloat16")
    o = ops.attention(qt, kt, vt, window=window)
    _assert_close(o, _reference("ref", qj, kj, vj, window=window),
                  _tol("bfloat16"))


def test_attention_softcap_head_dim_128():
    (qj, kj, vj), (qt, kt, vt) = _both(
        _inputs(1, 300, 4, 2, 128, seed=7, scale=3.0), "bfloat16")
    o = ops.attention(qt, kt, vt, softcap=20.0)
    _assert_close(o, _reference("ref", qj, kj, vj, softcap=20.0),
                  _tol("bfloat16"))


@pytest.mark.parametrize("H,K", [(4, 4), (8, 2), (10, 1)])   # G = 1, 4, 10
def test_attention_groups_batch_two(H, K):
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(2, 129, H, K, 64, seed=H),
                                       "bfloat16")
    o = ops.attention(qt, kt, vt)
    _assert_close(o, _reference("ref", qj, kj, vj), _tol("bfloat16"))


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


def _wkv_inputs(B, H, S, *, seed=0, with_s0=False):
    """tests/test_kernels.py's WKV inputs: r, k, v × 0.5, w =
    exp(−exp(n − 1)), u × 0.1 (and an initial state), as float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, 64)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, H, S, 64)) - 1.0))
    u = rng.standard_normal((H, 64)) * 0.1
    s0 = rng.standard_normal((B, H, 64, 64)) * 0.5 if with_s0 else None
    return [None if a is None else a.astype(np.float32)
            for a in (r, k, v, w, u, s0)]


def test_cpu_wkv_launches_no_kernel():
    """On the CPU ``ops.wkv`` takes the plain version, and only there."""
    r, k, v, w, u, _ = (None if a is None else torch.from_numpy(a)
                        for a in _wkv_inputs(1, 2, 20))
    before = k3.launches
    y, s = ops.wkv(r, k, v, w, u)
    y_ref, s_ref = ref.wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref)
    torch.testing.assert_close(s, s_ref)
    assert k3.launches == before


def test_wkv_wrapper_refuses_what_it_cannot_launch():
    """K3's wrapper raises, launching nothing, on CPU tensors, on a
    layout the kernel does not take, on other dtypes and shapes, and on a
    chunk past its shared-memory tiles (on a meta tensor too, where
    ``ops.wkv`` gives its fake's shapes and launches nothing)."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(1, 2, 20, with_s0=True))
    before = k3.launches
    bad = [
        ({}, "CUDA device"),
        ({"k": k.transpose(1, 2).contiguous().transpose(1, 2)},
         "share one layout"),
        ({"r": r.bfloat16()}, "all float32 or all bfloat16"),
        ({"w": w.bfloat16()}, "w is torch.bfloat16"),
        ({"u": u[:1]}, "u is"),
        ({"s0": s0.transpose(2, 3)}, "s0 is"),
        ({"r": r[..., :32], "k": k[..., :32], "v": v[..., :32],
          "w": w[..., :32]}, r"want \(B, H, S, 64\)"),
        ({"chunk": 64}, "chunk 64"),
    ]
    for change, msg in bad:
        kw = {"r": r, "k": k, "v": v, "w": w, "u": u, "s0": s0,
              "chunk": 16} | change
        with pytest.raises(ValueError, match=msg):
            k3.wkv6(kw.pop("r"), kw.pop("k"), kw.pop("v"), kw.pop("w"),
                    kw.pop("u"), kw.pop("s0"), **kw)
    meta = torch.empty(1, 2, 8, 64, device="meta")
    u_meta = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        k3.wkv6(meta, meta, meta, meta, u_meta)     # the kernel: the card
    # the operator on meta: its fake's shapes, no kernel, no plain version
    y, s_final = ops.wkv(meta, meta, meta, meta, u_meta)
    assert (y.shape, s_final.shape) == ((1, 2, 8, 64), (1, 2, 64, 64))
    assert k3.launches == before


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels (K1 flash "
                    "attention, K2 RG-LRU scan, K3 RWKV-6 WKV) are CUDA "
                    "C++ for sm_90a and have no CPU mode")
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


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(4, 2048), (23, 2048), (512, 128)])
def test_kernel_head_dim_256(cuda, S, window):
    """K1 at recurrentgemma-2b's shapes: MQA, 10 heads, head_dim 256,
    its window of 2048 (and a window the sequence exceeds)."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(1, S, 10, 1, 256, seed=S))
    before = fa.launches
    o = ops.attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref = ref.attention_ref(q, k, v, window=window)
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol("bfloat16"))


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,K", [(64, 8, 2), (128, 8, 2), (256, 10, 1)])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_kernel_tile_edges(cuda, S, D, H, K):
    """The bf16 tensor-core kernel at S on each side of its tiles."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(1, S, H, K, D, seed=S))
    before = fa.launches
    o = ops.attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref = ref.attention_ref(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol("bfloat16"))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,D,window,softcap", [
    (1, 300, 8, 2, 64, 64, None),         # windows across tile edges
    (1, 300, 8, 2, 64, 100, None),
    (1, 300, 10, 1, 256, 64, None),
    (1, 300, 10, 1, 256, 100, None),
    (1, 300, 8, 2, 128, None, 20.0),      # softcap
    (2, 200, 8, 2, 64, None, None),       # B = 2
    (2, 200, 10, 1, 256, 2048, None),
    (1, 200, 8, 8, 64, None, None),       # G = 1
    (1, 200, 8, 2, 128, None, None),      # G = 4
    (1, 200, 20, 2, 128, None, None),     # G = 10
])
def test_kernel_bf16_bands(cuda, B, S, H, K, D, window, softcap):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(B, S, H, K, D, seed=S + D,
                                scale=3.0 if softcap else 1.0))
    o = ops.attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    o_ref = ref.attention_ref(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(o.float(), o_ref.float(), **_tol("bfloat16"))


@pytest.mark.gpu
def test_bf16_kernel_runs_on_the_tensor_cores(cuda):
    """Each bf16 instantiation holds wgmma (SASS ``HGMMA``) instructions;
    the float32 one holds none."""
    from repro_torch.kernels import _build
    counts = _build.sass_counts(fa._SOURCE, "HGMMA")
    tc = {n: c for n, c in counts.items() if "flash_attention_tc" in n}
    f32 = {n: c for n, c in counts.items() if "flash_attention_f32" in n}
    assert len(tc) == 3 and all(c > 0 for c in tc.values()), counts
    assert len(f32) == 3 and not any(f32.values()), counts


@pytest.mark.gpu
def test_bf16_kernel_refuses_unaligned_inputs(cuda):
    """TMA needs 16-byte aligned tensors: the wrapper raises, launching
    nothing."""
    q = torch.zeros(1 * 16 * 4 * 64 + 1, device=cuda,
                    dtype=torch.bfloat16)[1:].view(1, 16, 4, 64)
    k = torch.zeros(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k, k)
    assert fa.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,R,with_h0", [
    (1, 4, 2560, False),          # the serving path's prefill
    (1, 23, 2560, True),
    (2, 256, 512, False),
    (1, 1000, 300, True),         # ragged R and S
])
def test_scan_kernel_matches_plain(cuda, B, S, R, with_h0, dtype):
    """K2 against its plain version (f32 math both; bf16 inputs are read
    as f32), at tests/test_kernels.py's 1e-5."""
    rng = np.random.default_rng(S)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, R))))
    b = rng.standard_normal((B, S, R)) * 0.1
    at, bt = (torch.from_numpy(x.astype(np.float32)).to(cuda, DTYPES[dtype])
              for x in (a, b))
    h0 = (torch.from_numpy(rng.standard_normal((B, R), dtype=np.float32))
          .to(cuda) if with_h0 else None)
    before = k2.launches
    h, hf = ops.rglru(at, bt, h0)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = ref.rglru_ref(at, bt, h0)
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, want[:, -1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("B,H,S,dtype,with_s0", [
    (1, 2, 64, "float32", False),         # tests/test_kernels.py's sweep
    (2, 4, 128, "float32", False),
    (1, 64, 23, "bfloat16", True),        # the serving path's prefill
    (2, 4, 100, "float32", True),         # ragged S
])
def test_wkv_kernel_matches_plain(cuda, B, H, S, dtype, with_s0, chunk):
    """K3 against its plain version at tests/test_kernels.py's 1e-4 (f32
    math both; bf16 r, k, v are read as f32)."""
    r, k, v, w, u, s0 = (None if a is None else torch.from_numpy(a).to(cuda)
                         for a in _wkv_inputs(B, H, S, seed=S,
                                              with_s0=with_s0))
    r, k, v = (t.to(DTYPES[dtype]) for t in (r, k, v))
    before = k3.launches
    y, s = ops.wkv(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    y_ref, s_ref = ref.wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_wkv_kernel_takes_the_models_layout(cuda):
    """The model hands K3 head-transposed views of (B, S, H, N)
    projections; the kernel reads them through their strides."""
    B, S, H = 2, 40, 4
    r, k, v, w, u, _ = (None if a is None else torch.from_numpy(a).to(cuda)
                        for a in _wkv_inputs(B, H, S, seed=5))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (r, k, v, w)]
    assert not views[0].is_contiguous()
    y, s = ops.wkv(*views, u)
    y_ref, s_ref = ref.wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_wkv_kernel_extreme_decay(cuda):
    """w = 1e-6 everywhere: the clamp keeps every output finite."""
    r, k, v, _, u, _ = (None if a is None else torch.from_numpy(a).to(cuda)
                        for a in _wkv_inputs(1, 1, 64, seed=6))
    w = torch.full_like(r, 1e-6)
    y, s = ops.wkv(r, k, v, w, u)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_ref, _ = ref.wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 2048])
def test_scan_kernel_chunk_edges(cuda, S, with_h0, dtype):
    """K2 around its chunk T = 64: the one-pass loop up to T, the chunked
    scan (summaries, carries, rescan) past it; one entry-point call
    each, at 1e-5."""
    assert k2.chunk() == 64
    rng = np.random.default_rng(S)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((2, S, 300))))
    b = rng.standard_normal((2, S, 300)) * 0.1
    at, bt = (torch.from_numpy(x.astype(np.float32)).to(cuda, DTYPES[dtype])
              for x in (a, b))
    h0 = (torch.from_numpy(rng.standard_normal((2, 300), dtype=np.float32))
          .to(cuda) if with_h0 else None)
    before = k2.launches
    h, hf = ops.rglru(at, bt, h0)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = ref.rglru_ref(at, bt, h0)
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, want[:, -1], rtol=1e-5, atol=1e-5)


def _wkv_on(cuda, B, H, S, dtype, seed, with_s0=True):
    r, k, v, w, u, s0 = (None if a is None else torch.from_numpy(a).to(cuda)
                         for a in _wkv_inputs(B, H, S, seed=seed,
                                              with_s0=with_s0))
    r, k, v = (t.to(DTYPES[dtype]) for t in (r, k, v))
    return r, k, v, w, u, s0


def _wkv_held(got, r, k, v, w, u, s0):
    torch.cuda.synchronize()
    y_ref, s_ref = ref.wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(got[0], y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], s_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [1, 16, 32])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 31, 32, 33, 2048])
def test_wkv_kernel_chunk_edges(cuda, S, chunk, dtype):
    """K3 around its chunks and two-chunk blocks, B=2 with a random
    initial state, at 1e-4."""
    r, k, v, w, u, s0 = _wkv_on(cuda, 2, 2, S, dtype, seed=S + chunk)
    before = k3.launches
    got = ops.wkv(r, k, v, w, u, s0, chunk=chunk)
    assert k3.launches == before + 1
    _wkv_held(got, r, k, v, w, u, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wkv_kernel_takes_the_models_layout_in_both_dtypes(cuda, dtype):
    """Head-transposed views of (B, S, H, N) projections, in float32 and
    bfloat16 r/k/v."""
    r, k, v, w, u, s0 = _wkv_on(cuda, 2, 4, 40, dtype, seed=7)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (r, k, v, w)]
    assert not views[0].is_contiguous()
    _wkv_held(ops.wkv(*views, u, s0), r, k, v, w, u, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("decay", ["1e-38", "1", "1e-6|0.999"])
def test_wkv_kernel_decay_edges(cuda, decay, dtype):
    """w = 1e-38 (clipped before the log) and w = 1 everywhere; half the
    channels at 1e-6, half at 0.999."""
    r, k, v, w, u, s0 = _wkv_on(cuda, 1, 4, 100, dtype, seed=8)
    w = {"1e-38": torch.full_like(w, 1e-38), "1": torch.ones_like(w),
         "1e-6|0.999": torch.where(torch.arange(64, device=cuda) < 32, 1e-6,
                                   0.999).expand_as(w).contiguous()}[decay]
    got = ops.wkv(r, k, v, w, u, s0)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    _wkv_held(got, r, k, v, w, u, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wkv_kernel_continuation(cuda, dtype):
    """From a random s0: two halves (the first ending mid-chunk) equal the
    whole, and the whole equals the plain version."""
    r, k, v, w, u, s0 = _wkv_on(cuda, 1, 8, 128, dtype, seed=9)
    whole = ops.wkv(r, k, v, w, u, s0)
    first = [t[:, :, :57] for t in (r, k, v, w)]
    second = [t[:, :, 57:] for t in (r, k, v, w)]
    y1, s1 = ops.wkv(*first, u, s0)
    y2, s2 = ops.wkv(*second, u, s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 2), whole[0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s2, whole[1], rtol=1e-4, atol=1e-4)
    _wkv_held(whole, r, k, v, w, u, s0)


@pytest.mark.gpu
def test_wkv_kernel_refuses_unaligned_inputs(cuda):
    """The kernel copies 16-byte pieces of each row: a tensor off a
    16-byte boundary raises, launching nothing."""
    r, k, v, w, u, _ = _wkv_on(cuda, 1, 2, 16, "float32", seed=10)
    off = torch.zeros(r.numel() + 1, device=cuda)[1:].view(r.shape)
    off.copy_(r)
    before = k3.launches
    with pytest.raises(ValueError, match="16-byte"):
        k3.wkv6(off, k, v, w, u)
    assert k3.launches == before


@pytest.mark.gpu
def test_wkv_kernel_runs_on_the_tensor_cores_in_clusters(cuda):
    """Both instantiations hold mma.sync (SASS ``HMMA``) instructions, and
    the runtime launches them in clusters of a head's 4 CTAs."""
    from repro_torch.kernels import _build
    counts = {n: c for n, c in _build.sass_counts(k3._SOURCE, "HMMA").items()
              if "wkv6_kernel" in n}
    assert len(counts) == 2 and all(c > 0 for c in counts.values()), counts
    for dtype in DTYPES.values():
        info = k3.cluster_info(dtype)
        assert info["cluster_width"] == 2 and info["max_active_clusters"] > 0


# -- gradients through the kernels' dispatch ---------------------------------------


def _grads_of(outs, inputs, seed=0):
    """Gradients of a random linear functional of ``outs`` (coefficients
    drawn on their device from ``seed``) with respect to ``inputs``."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    dev = outs[0].device
    g = torch.Generator(device=dev).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                        device=dev)).sum() for o in outs)
    return torch.autograd.grad(loss, inputs)


@pytest.mark.parametrize("op", ["attention", "rglru", "wkv"])
def test_kernel_function_takes_the_plain_gradient(op):
    """Each kernel operator's autograd formula: its output, computed
    below autograd (on the CPU by the plain version, as the card's
    kernel writes fresh tensors), is attached to autograd, and its
    gradients are those of the reference's training formula in
    ``kernels/grad.py`` (the name is older than that formula), input by
    input (None inputs and an output that no input reaches included):
    attention's chunk-by-chunk backward, at a length of three query
    chunks, the last one short; autograd through the scan and the
    chunked WKV."""
    rng = np.random.default_rng(3)

    def t(*shape, f=lambda x: x):
        return torch.from_numpy(f(rng.standard_normal(shape))
                                .astype(np.float32)).requires_grad_(True)
    if op == "attention":
        def kernel(q, k, v):
            return ops.attention(q, k, v, window=5, softcap=20.0)
        inputs = [t(2, 1100, 4, 8), t(2, 1100, 2, 8), t(2, 1100, 2, 8)]
        out = kernel(*inputs)
        assert out.requires_grad and out.grad_fn is not None
        # _grads_of's functional: its coefficients are the output gradient
        go = torch.randn(out.shape, generator=torch.Generator()
                         .manual_seed(0))
        want = grad.attention_grads(*inputs, go, 5, 20.0)
        for g, w in zip(_grads_of(out, inputs), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        return
    elif op == "rglru":
        formula, kernel = grad.associative_scan, ops.rglru
        inputs = [t(2, 7, 3, f=lambda x: 1 / (1 + np.exp(-x))), t(2, 7, 3),
                  t(2, 3)]
    else:
        def formula(*x):
            return grad.chunked_wkv(*x, chunk=16)
        kernel = ops.wkv
        inputs = [t(1, 2, 5, 64) for _ in range(3)] \
            + [t(1, 2, 5, 64, f=lambda x: np.exp(-np.exp(x - 1))),
               t(2, 64), None]
    outs = kernel(*inputs)
    first = outs[0] if isinstance(outs, tuple) else outs
    assert first.requires_grad and first.grad_fn is not None
    wrt = [x for x in inputs if x is not None]
    got = _grads_of(outs, wrt)
    want = _grads_of(formula(*inputs), wrt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if op == "wkv":         # u alone: the final state does not depend on it
        u_only = [x.detach() if x is not None else None for x in inputs]
        u_only[4].requires_grad_(True)
        outs = kernel(*u_only)
        torch.testing.assert_close(_grads_of(outs, [u_only[4]])[0],
                                   _grads_of(formula(*u_only),
                                             [u_only[4]])[0],
                                   rtol=0, atol=0)


def _card_grads(cuda, fn, plain, inputs):
    """Gradients through ``fn`` (the dispatch: the kernel's forward) and
    through ``plain``, of the same functional, on the card."""
    inputs = [None if x is None else x.to(cuda).requires_grad_(True)
              for x in inputs]
    wrt = [x for x in inputs if x is not None]
    got = _grads_of(fn(*inputs), wrt)
    want = _grads_of(plain(*inputs), wrt)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,H,K,window,softcap", [
    (64, 8, 2, None, None), (64, 8, 2, 16, 20.0), (128, 8, 2, 24, None),
    (256, 10, 1, None, 20.0)])
def test_attention_gradient_on_the_card(cuda, D, H, K, window, softcap,
                                        dtype):
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(td) for s in ((2, 40, H, D), (2, 40, K, D),
                                 (2, 40, K, D)))
    before = fa.launches
    got, want = _card_grads(
        cuda, lambda *x: ops.attention(*x, window=window, softcap=softcap),
        lambda *x: ref.attention_ref(*x, window=window, softcap=softcap),
        [q, k, v])
    assert fa.launches == before + 1
    for g, w in zip(got, want):
        scale = 2e-2 * float(w.float().abs().max()) \
            if dtype == "bfloat16" else 1e-5
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=scale)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 17, 65])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_gradient_on_the_card(cuda, S, with_h0):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(1 / (1 + np.exp(-rng.standard_normal((2, S, 64)))))
    b = torch.from_numpy(rng.standard_normal((2, S, 64)) * 0.1)
    h0 = torch.from_numpy(rng.standard_normal((2, 64)))
    inputs = [a.float(), b.float(), h0.float() if with_h0 else None]
    before = k2.launches
    got, want = _card_grads(cuda, ops.rglru, ops._rglru_plain, inputs)
    assert k2.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 17, 65])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_gradient_on_the_card(cuda, S, with_s0):
    rng = np.random.default_rng(S)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    r, k, v = (f(1, 4, S, 64) * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(f(1, 4, S, 64) - 1.0))
    inputs = [r, k, v, w, f(4, 64) * 0.1,
              f(1, 4, 64, 64) * 0.5 if with_s0 else None]
    before = k3.launches
    got, want = _card_grads(cuda, ops.wkv, ref.wkv6_ref, inputs)
    assert k3.launches == before + 1
    # w's gradient as ∂/∂w where w ≥ 0.05, as w ⊙ ∂/∂w below: the
    # chunked formula takes log w, so ∂/∂w divides its rounding by w
    w = w.to(cuda)
    big = w >= 0.05
    got, want = ([*x[:3], torch.where(big, x[3], 0.0),
                  torch.where(big, 0.0, x[3] * w), *x[4:]]
                 for x in (got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
