"""The port's RWKV-6 slice (rwkv6-7b) against the reference, on the CPU:
the WKV (kernel K3's plain version) against ``repro.kernels``' ``wkv6_ref``,
the model's ``wkv6_chunked`` and the Pallas kernel in interpret mode; the
block's pieces against :mod:`repro.models.rwkv`; and the smoke model
against the JAX model with weights carried across by
:func:`repro_torch.convert.params_from_jax`.  Kernel K3 itself is held
against its plain version in the ``gpu``-marked tests of
``tests/test_torch_kernels.py``, which need a card and no JAX."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.models import rwkv as jr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models import rwkv as tr
from repro_torch.models.rwkv import RWKVLayer
from repro_torch.models.transformer import Transformer

ARCH = "rwkv6-7b"
#: the WKV: tests/test_kernels.py's tolerance (f32; the chunked and the
#: step-by-step forms sum in other orders, and the clamp flushes below
#: e^-40)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
#: logits in f32, as tests/test_torch_model.py: 1e-4
F32_LOGIT_TOL = 1e-4
#: logits in bf16, as a share of the logits' scale.  PRs 12 and 13 held
#: bf16 logits at 2e-2 of the scale; for this model the reference is not
#: that close to itself: its jitted and its eager bf16 forward differ by
#: up to 2.49 % of the scale on these inputs
#: (test_reference_bf16_spread), since XLA's fusions round bf16 at other
#: places than op-by-op execution and every flipped rounding cascades
#: through the exp(-exp()) decay and the squared ReLU.  The port's bf16
#: logits are held at 5e-2, twice the reference's own spread.
BF16_LOGIT_SHARE = 5e-2
#: token seeds of the bf16 comparisons
BF16_SEEDS = (7, 8, 9)
#: the RWKV leaves that stay float32 in a bfloat16 model
F32_LEAVES = ("tm.u", "tm.w0", "tm.gn_w", "tm.gn_b")


def _wkv_inputs(B, H, S, N=64, seed=0):
    """As tests/test_kernels.py makes them: r, k, v × 0.5, w =
    exp(−exp(n − 1)), u × 0.1, and an initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, N)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, H, S, N)) - 1.0))
    u = rng.standard_normal((H, N)) * 0.1
    s0 = rng.standard_normal((B, H, N, N)) * 0.5
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def _jax_wkv(reference, r, k, v, w, u, s0=None, chunk=16):
    args = [jnp.asarray(a) for a in (r, k, v, w, u)]
    s0 = None if s0 is None else jnp.asarray(s0)
    if reference == "ref":
        return jref.wkv6_ref(*args, s0)
    if reference == "chunked":
        return jr.wkv6_chunked(*args, s0, chunk=chunk)
    return jops.wkv(*args, s0, impl="interpret", chunk=chunk)


# ---------------------------------------------------------------------------
# The WKV (K3's plain version on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["ref", "chunked", "interpret"])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("B,H,S,N", [(1, 2, 64, 64), (2, 4, 128, 64)])
def test_wkv_matches_reference(B, H, S, N, chunk, reference):
    r, k, v, w, u, _ = _wkv_inputs(B, H, S, N)
    y, s = ops.wkv(*(_t(a) for a in (r, k, v, w, u)), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, H, S, N) and s.shape == (B, H, N, N)
    yj, sj = _jax_wkv(reference, r, k, v, w, u, chunk=chunk)
    _close(y, yj, WKV_TOL)
    _close(s, sj, WKV_TOL)


def test_wkv_reads_bf16_as_f32():
    """The serving path's inputs: bf16 r, k, v; f32 w and u; a zero
    initial state passed in."""
    r, k, v, w, u, _ = _wkv_inputs(1, 4, 23, seed=1)
    rb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (r, k, v))
    zero = np.zeros((1, 4, 64, 64), np.float32)
    y, s = ops.wkv(*(tensor_from_numpy(np.asarray(a)) for a in (rb, kb, vb)),
                   _t(w), _t(u), _t(zero))
    yj, sj = jref.wkv6_ref(rb, kb, vb, jnp.asarray(w), jnp.asarray(u),
                           jnp.asarray(zero))
    _close(y, yj, WKV_TOL)
    _close(s, sj, WKV_TOL)


@pytest.mark.parametrize("reference", ["ref", "interpret"])
def test_wkv_initial_state_continuation(reference):
    """Two halves, the second started from the first's final state, equal
    the whole; with ``s0`` the whole matches the reference."""
    B, H, S, N = 1, 2, 128, 64
    r, k, v, w, u, s0 = _wkv_inputs(B, H, S, N, seed=2)
    args = [_t(a) for a in (r, k, v, w)]
    whole, s_whole = ops.wkv(*args, _t(u), _t(s0))
    h = S // 2
    y1, s1 = ops.wkv(*(a[:, :, :h] for a in args), _t(u), _t(s0))
    y2, s2 = ops.wkv(*(a[:, :, h:] for a in args), _t(u), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 2), whole, **WKV_TOL)
    torch.testing.assert_close(s2, s_whole, **WKV_TOL)
    yj, sj = _jax_wkv(reference, r, k, v, w, u, s0)
    _close(whole, yj, WKV_TOL)
    _close(s_whole, sj, WKV_TOL)


def test_wkv_extreme_decay_stays_finite():
    """w = 1e-6 (near-total decay each step): finite, and equal to the
    reference's interpret-mode kernel, whose clamp is at work here."""
    B, H, S, N = 1, 1, 64, 64
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, H, S, N)).astype(np.float32)
               for _ in range(3))
    w = np.full((B, H, S, N), 1e-6, np.float32)
    u = np.zeros((H, N), np.float32)
    y, s = ops.wkv(*(_t(a) for a in (r, k, v, w, u)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    for reference in ("ref", "interpret"):
        yj, _ = _jax_wkv(reference, r, k, v, w, u)
        _close(y, yj, WKV_TOL)


@pytest.mark.parametrize("S", [23, 37])
def test_wkv_ragged_matches_chunked(S):
    """An S that is no multiple of the chunk: the reference's model pads
    it (k = v = r = 0, w = 1); the Pallas kernel cannot take it."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 2, S, seed=S)
    y, s = ops.wkv(*(_t(a) for a in (r, k, v, w, u, s0)))
    yj, sj = _jax_wkv("chunked", r, k, v, w, u, s0, chunk=16)
    _close(y, yj, WKV_TOL)
    _close(s, sj, WKV_TOL)


@pytest.mark.parametrize("reference", ["ref", "chunked"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 31, 32, 33, 2048])
def test_wkv_chunk_edges_match_reference(S, reference):
    """The S values around K3's chunks that the card tests use, with a
    random initial state: the plain version the card trusts against the
    reference's step-by-step WKV and its chunked WKV (which pads a ragged
    S, as the kernel masks it)."""
    B, H = (1, 1) if S == 2048 else (1, 2)
    r, k, v, w, u, s0 = _wkv_inputs(B, H, S, seed=S)
    y, s = ops.wkv(*(_t(a) for a in (r, k, v, w, u, s0)))
    yj, sj = _jax_wkv(reference, r, k, v, w, u, s0, chunk=16)
    _close(y, yj, WKV_TOL)
    _close(s, sj, WKV_TOL)


@pytest.mark.parametrize("decay,reference", [
    ("1e-38", "ref"), ("1", "ref"), ("1", "chunked"),
    ("1e-6|0.999", "ref"), ("1e-6|0.999", "chunked")])
def test_wkv_decay_edges_match_reference(decay, reference):
    """Decays at the clamp's edges, as the card tests hold K3 there: w =
    1e-38 (clipped before the log), w = 1, and half the channels at 1e-6,
    half at 0.999.  At w = 1e-38 only the step-by-step reference: XLA on
    the CPU flushes the subnormal 1e-38 to 0, so the reference's chunked
    forms take log 0 there and return NaN."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 2, 40, seed=11)
    w = {"1e-38": np.full_like(w, 1e-38), "1": np.ones_like(w),
         "1e-6|0.999": np.broadcast_to(
             np.where(np.arange(64) < 32, 1e-6, 0.999).astype(np.float32),
             w.shape).copy()}[decay]
    y, s = ops.wkv(*(_t(a) for a in (r, k, v, w, u, s0)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yj, sj = _jax_wkv(reference, r, k, v, w, u, s0, chunk=16)
    _close(y, yj, WKV_TOL)
    _close(s, sj, WKV_TOL)


@pytest.mark.parametrize("chunk", [16, 32])
def test_k3_products_need_the_tf32_split(chunk):
    """K3's products on the tensor cores, emulated (launch/k3_split.py):
    with 3xTF32 operands the chunked WKV holds the kernel's 1e-4 against
    the plain version, as unrounded products do; one TF32 pass does
    not."""
    from repro_torch.launch import k3_split
    errs = k3_split.errors(1, 4, 70, bf16=True, with_s0=True, chunk=chunk)
    assert errs["f32"] < 2e-5 and errs["3x"] < 2e-5, errs
    assert errs["1x"] > k3_split.WKV_TOL, errs


# ---------------------------------------------------------------------------
# The block's pieces against repro.models.rwkv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_scan_ref_matches_reference(with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(2, 2, 5, seed=4)
    s0 = s0 if with_s0 else None
    y, s = tr.wkv6_scan_ref(*(_t(a) for a in (r, k, v, w, u)),
                            None if s0 is None else _t(s0))
    yj, sj = jr.wkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                              None if s0 is None else jnp.asarray(s0))
    _close(y, yj, dict(rtol=1e-5, atol=1e-5))
    _close(s, sj, dict(rtol=1e-5, atol=1e-5))


def _layer_leaves(cfg, dtype: str, seed=5):
    """One RWKV layer's leaves from the reference's ``init_rwkv``, with
    nonzero norms and GroupNorm affine so that every leaf matters."""
    p = jr.init_rwkv(jax.random.PRNGKey(seed), cfg, jnp.dtype(dtype))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for name in ("ln1", "ln2"):
        p[name] = np.asarray(jnp.asarray(
            rng.standard_normal(p[name].shape) * 0.1, jnp.dtype(dtype)))
    for name in ("gn_w", "gn_b"):
        p["tm"][name] = p["tm"][name] + rng.standard_normal(
            p["tm"][name].shape).astype(np.float32) * 0.1
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddlerp_matches_reference(dtype):
    cfg = get_smoke_config(ARCH)
    tm = _layer_leaves(cfg, dtype)["tm"]
    rng = np.random.default_rng(6)
    x, xx = (jnp.asarray(rng.standard_normal((2, 7, 128)), jnp.dtype(dtype))
             for _ in range(2))
    want = jr._ddlerp(x, xx, *(jnp.asarray(tm[n])
                               for n in ("mu_r", "a_r", "b_r")))
    got = tr._ddlerp(*(tensor_from_numpy(np.asarray(a)) for a in
                       (x, xx, tm["mu_r"], tm["a_r"], tm["b_r"])))
    assert got.dtype == tensor_from_numpy(np.asarray(want)).dtype
    _close(got, want, dict(rtol=1e-5, atol=1e-6))


def _layer(cfg, leaves) -> RWKVLayer:
    """A port layer holding the reference leaves (the reference's own
    tree walk, through a one-layer model's conversion)."""
    tree = {"embed": np.zeros((cfg.padded_vocab(), cfg.d_model),
                              np.float32),
            "final_ln": np.zeros(cfg.d_model, np.float32),
            "lm_head": np.zeros((cfg.d_model, cfg.padded_vocab()),
                                np.float32),
            "blocks": (jax.tree.map(lambda a: a[None], leaves),),
            "rest": ()}
    return params_from_jax(tree, cfg.replace(n_layers=1), device="cpu") \
        .layers[0]


@pytest.mark.parametrize("S,with_state", [(12, False), (1, True),
                                          (5, True)])
def test_rwkv_layer_matches_block(S, with_state):
    """One layer in float32: a sequence without a state (the WKV through
    ``ops.wkv``), the decode step (S = 1 with a state, the plain scan) and
    a sequence continued from a state."""
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    leaves = _layer_leaves(cfg, "float32")
    layer = _layer(cfg, leaves)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jstate = state = None
    if with_state:
        st = {"shift_t": rng.standard_normal((2, 128)),
              "shift_c": rng.standard_normal((2, 128)),
              "wkv": rng.standard_normal((2, 2, 64, 64)) * 0.5}
        st = {k: v.astype(np.float32) for k, v in st.items()}
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
        state = {k: _t(v) for k, v in st.items()}
    want, jns = jr.rwkv_block(jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                           leaves),
                              cfg, jstate)
    with torch.no_grad():
        got, ns = layer(_t(x), state)
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    if not with_state:
        assert ns is None and jns is None
        return
    assert set(ns) == set(jns)
    for name in ns:
        assert ns[name].dtype == torch.float32
        _close(ns[name], jns[name], dict(rtol=1e-4, atol=1e-4))


# ---------------------------------------------------------------------------
# The smoke model against the JAX model
# ---------------------------------------------------------------------------


def _models(param_dtype: str):
    cfg = get_smoke_config(ARCH).replace(param_dtype=param_dtype)
    jcfg = jax_smoke_config(ARCH).replace(param_dtype=param_dtype)
    assert asdict(cfg) == asdict(jcfg)      # the port's config is a copy
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return cfg, jcfg, jparams, tparams


def _tokens(cfg, B, S, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def test_config_is_the_published_one():
    """rwkv6-7b at full width: 32 RWKV layers of d 4096 (64 heads of 64),
    d_ff 14336, vocab 65536, untied — 7.58 B parameters, 15.2 GB in
    bf16, counted on the meta device and equal, layer by layer, to the
    reference's tree (shapes only, through ``jax.eval_shape``)."""
    from repro.configs import get_config as jax_config
    cfg = get_config(ARCH)
    assert asdict(cfg) == asdict(jax_config(ARCH))
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (32, 4096, 14336, 65536)
    assert not cfg.tie_embeddings and cfg.param_dtype == "bfloat16"
    model = Transformer(cfg, device="meta")
    assert all(isinstance(m, RWKVLayer) for m in model.layers)
    per_layer = sum(p.numel() for p in model.layers[0].parameters())
    total = sum(p.numel() for p in model.parameters())
    jtree = jax.eval_shape(lambda key: j_init(key, jax_config(ARCH)),
                           jax.random.PRNGKey(0))
    assert per_layer * 32 == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jtree["blocks"]))
    assert total == sum(int(np.prod(x.shape))
                        for x in jax.tree.leaves(jtree))
    assert per_layer == 219_992_064
    assert 7.57e9 < total < 7.58e9
    assert model.layers[0].tm.u.shape == (64, 64)


def test_converted_weights_keep_layout_and_dtypes():
    """``blocks[0][name][i]`` → layer ``i``, bit for bit, through the
    nested ``tm``/``cm`` leaves; u, w0, gn_w and gn_b stay float32 in a
    bfloat16 model."""
    cfg, _, jparams, tparams = _models("bfloat16")
    assert (cfg.n_units, cfg.n_remainder) == (2, 0)
    for i, layer in enumerate(tparams.layers):
        assert isinstance(layer, RWKVLayer)
        for name, p in layer.named_parameters():
            leaf = jparams["blocks"][0]
            for key in name.split("."):
                leaf = leaf[key]
            assert torch.equal(p, tensor_from_numpy(np.asarray(leaf)[i])), \
                (i, name)
            want = torch.float32 if name in F32_LEAVES else torch.bfloat16
            assert p.dtype == want, (i, name)
    assert torch.equal(tparams.lm_head,
                       tensor_from_numpy(np.asarray(jparams["lm_head"])))


def test_convert_refuses_a_dtype_mismatch():
    """A bfloat16 ``u`` leaf (float32 in the port) raises instead of
    being cast."""
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                           jax_smoke_config(ARCH)))
    tree["blocks"][0]["tm"]["u"] = np.asarray(
        jnp.asarray(tree["blocks"][0]["tm"]["u"], jnp.bfloat16))
    with pytest.raises(ValueError, match=r"layers\.0\.tm\.u: reference "
                                         r"dtype torch\.bfloat16, port "
                                         r"dtype torch\.float32"):
        params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("param_dtype,seed", [("float32", 7)] + [
    ("bfloat16", s) for s in BF16_SEEDS])
def test_forward_matches_reference(param_dtype, seed):
    cfg, jcfg, jparams, tparams = _models(param_dtype)
    toks = _tokens(cfg, 2, 24, seed)
    lj, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        lt, aux = forward(tparams, torch.from_numpy(toks), cfg)
    assert lt.shape == (2, 24, cfg.padded_vocab()) and float(aux) == 0.0
    want = np.asarray(lj, np.float32)
    if param_dtype == "float32":
        np.testing.assert_allclose(lt.numpy(), want, rtol=F32_LOGIT_TOL,
                                   atol=F32_LOGIT_TOL)
    else:
        err = np.abs(lt.float().numpy() - want).max()
        assert err <= BF16_LOGIT_SHARE * np.abs(want).max(), err


def test_reference_bf16_spread():
    """Why the bf16 logits are not held at 2e-2 of the scale: the
    reference's jitted forward and the same forward run op by op differ
    by more than that on these inputs (2.05, 2.49 and 1.65 % of the scale
    for token seeds 7, 8 and 9), and by less than half of the tolerance
    used instead."""
    _, jcfg, jparams, _ = _models("bfloat16")
    spreads = []
    for seed in BF16_SEEDS:
        toks = jnp.asarray(_tokens(jcfg, 2, 24, seed))
        jit = np.asarray(j_forward(jparams, toks, jcfg)[0], np.float32)
        with jax.disable_jit():
            eager = np.asarray(j_forward(jparams, toks, jcfg)[0], np.float32)
        spreads.append(np.abs(jit - eager).max() / np.abs(jit).max())
    assert max(spreads) > 2e-2, spreads
    assert max(spreads) <= BF16_LOGIT_SHARE / 2, spreads


def test_prefill_state_matches_reference():
    """Last-token logits and every layer's state after a 12-token prompt,
    against the reference's prefill; the shifts come back float32 in a
    float32 model, as the reference returns them."""
    cfg, jcfg, jparams, tparams = _models("float32")
    toks = _tokens(cfg, 2, 12)
    lj, cj = j_prefill(jparams, jnp.asarray(toks), jcfg, max_len=24)
    with torch.no_grad():
        lt, ct = prefill(tparams, torch.from_numpy(toks), cfg, max_len=24)
    _close(lt, lj, dict(rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL))
    for i, c in enumerate(ct):
        want = jax.tree.map(lambda x: x[i], cj["blocks"][0])
        assert set(c) == {"shift_t", "shift_c", "wkv"}
        assert c["wkv"].shape == (2, 2, 64, 64)
        for name in c:
            assert c[name].dtype == torch.float32, name
            _close(c[name], want[name], dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("source", ["port_forward", "reference_decode"])
def test_decode_matches_forward(source):
    """Prefill 8 tokens, decode to 24: each step matches the port's own
    forward and the reference's decode (f32, 1e-4)."""
    cfg, jcfg, jparams, tparams = _models("float32")
    B, S, T = 2, 24, 8
    toks = _tokens(cfg, B, S)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = forward(tparams, tt, cfg)
        _, cache = prefill(tparams, tt[:, :T], cfg, max_len=S)
    _, jcache = j_prefill(jparams, jnp.asarray(toks[:, :T]), jcfg,
                          max_len=S)
    for t in range(T, S):
        with torch.no_grad():
            step, cache = decode_step(tparams, tt[:, t], torch.tensor(t),
                                      cache, cfg)
        if source == "port_forward":
            torch.testing.assert_close(step, full[:, t], rtol=1e-4,
                                       atol=1e-4)
        else:
            jstep, jcache = j_decode(jparams, jnp.asarray(toks[:, t]),
                                     jnp.asarray(t, jnp.int32), jcache,
                                     jcfg)
            _close(step, jstep, dict(rtol=F32_LOGIT_TOL,
                                     atol=F32_LOGIT_TOL))


def test_shift_state_dtypes_follow_the_reference():
    """``init_cache`` makes the shifts bfloat16; prefill and decode hand
    back the model's dtype, and decode replaces the cache's entries
    rather than rounding into them (ROADMAP §3)."""
    cfg, _, _, tparams = _models("float32")
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert cache[0]["shift_t"].dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(cfg, 2, 3, seed=9))
    with torch.no_grad():
        _, cache = decode_step(tparams, toks[:, 0], torch.tensor(0), cache,
                               cfg)
    assert cache[0]["shift_t"].dtype == cache[0]["shift_c"].dtype == \
        torch.float32
    assert cache[0]["wkv"].dtype == torch.float32


def test_init_params_on_cpu():
    cfg = get_smoke_config(ARCH)
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))
    layer = m.layers[0]
    assert isinstance(layer, RWKVLayer)
    for name, p in layer.named_parameters():
        want = torch.float32 if name in F32_LEAVES else torch.bfloat16
        assert p.dtype == want, name
    # the reference's init_rwkv: w0 evenly from -6 to -0.5, μ = 0.5,
    # GroupNorm 1 and 0, N(0, 1/d) projections, N(0, 0.1²) u
    torch.testing.assert_close(layer.tm.w0, torch.linspace(-6.0, -0.5, 128))
    assert bool((layer.tm.mu_w == 0.5).all()) and \
        bool((layer.cm.mu_r == 0.5).all())
    assert bool((layer.tm.gn_w == 1).all()) and not layer.tm.gn_b.any()
    assert abs(float(layer.tm.wr.float().std()) * 128 ** 0.5 - 1.0) < 0.2
    assert abs(float(layer.tm.u.std()) / 0.1 - 1.0) < 0.2
    assert abs(float(layer.tm.b_w2.float().std()) / 0.01 - 1.0) < 0.2
    cache = init_cache(cfg, 3, 32, device="cpu")
    assert cache[1]["shift_c"].shape == (3, 128)
    assert cache[1]["wkv"].shape == (3, 2, 64, 64) and \
        cache[1]["wkv"].dtype == torch.float32
    with torch.no_grad():
        logits, _ = forward(m, torch.from_numpy(_tokens(cfg, 1, 6)), cfg)
    assert torch.isfinite(logits.float()).all()
