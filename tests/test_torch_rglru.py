"""The port's RG-LRU slice (recurrentgemma) against the reference, on the
CPU: the scan (kernel K2's plain version) against ``repro.kernels``'
``rglru_ref`` and the Pallas kernel in interpret mode, the block's
pieces against :mod:`repro.models.rglru`, and the smoke model against
the JAX model with weights carried across by
:func:`repro_torch.convert.params_from_jax`.  Kernel K2 itself (and K1
at head_dim 256) is held against its plain version in the ``gpu``-marked
tests of ``tests/test_torch_kernels.py``, which need a card and no
JAX."""

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
from repro.models import rglru as jr
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as k2
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models import rglru as tr
from repro_torch.models.rglru import RGLRULayer

ARCH = "recurrentgemma-2b"
#: the scan: tests/test_kernels.py's tolerance (f32, order of sums only)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
#: logits, as tests/test_torch_model.py: f32 1e-4; bf16 (or through the
#: bf16 conv state) 2e-2 of the logits' scale
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the RG-LRU leaves that stay float32 in a bfloat16 model
GATE_LEAVES = ("wa", "ba", "wx", "bx", "lam")


def _scan_inputs(B, S, R, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, R))))
    b = rng.standard_normal((B, S, R)) * 0.1
    h0 = rng.standard_normal((B, R))
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# The scan (K2's plain version on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["ref", "interpret"])
@pytest.mark.parametrize("B,S,R,t_blk,r_blk", [
    (1, 128, 256, 64, 256),      # tests/test_kernels.py's sweep
    (2, 256, 512, 128, 128),
    (1, 64, 1024, 64, 512),
    (1, 23, 256, 23, 256),       # ragged: a serving prompt's length
])
def test_rglru_scan_matches_reference(B, S, R, t_blk, r_blk, reference):
    a, b, _ = _scan_inputs(B, S, R)
    h, hf = ops.rglru(_t(a), _t(b))
    assert h.dtype == hf.dtype == torch.float32
    assert h.shape == (B, S, R) and hf.shape == (B, R)
    if reference == "ref":
        want = jref.rglru_ref(jnp.asarray(a), jnp.asarray(b))
        want_f = want[:, -1]
    else:
        want, want_f = jops.rglru(jnp.asarray(a), jnp.asarray(b),
                                  impl="interpret", t_blk=t_blk,
                                  r_blk=r_blk)
    _close(h, want, SCAN_TOL)
    _close(hf, want_f, SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 2048])
def test_rglru_scan_chunk_edges_match_reference(S, with_h0):
    """The S values around K2's chunk of 64 that the card tests use (the
    one-pass loop up to 64, the chunked scan past it): the plain version
    the card trusts against the reference's scan, and against its Pallas
    kernel in interpret mode where 64 divides S."""
    a, b, h0 = _scan_inputs(1, S, 128, seed=S)
    h0 = h0 if with_h0 else None
    h, hf = ops.rglru(_t(a), _t(b), None if h0 is None else _t(h0))
    args = [jnp.asarray(x) for x in (a, b)] \
        + ([jnp.asarray(h0)] if h0 is not None else [])
    want = jref.rglru_ref(*args)
    _close(h, want, SCAN_TOL)
    _close(hf, want[:, -1], SCAN_TOL)
    if S % 64 == 0:
        want, want_f = jops.rglru(*args, impl="interpret", t_blk=64,
                                  r_blk=128)
        _close(h, want, SCAN_TOL)
        _close(hf, want_f, SCAN_TOL)


def test_rglru_scan_reads_bf16_as_f32():
    a, b, _ = _scan_inputs(2, 24, 128, seed=1)
    aj, bj = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    h, _ = ops.rglru(_t(a).bfloat16(), _t(b).bfloat16())
    assert h.dtype == torch.float32
    _close(h, jref.rglru_ref(aj, bj), SCAN_TOL)


@pytest.mark.parametrize("reference", ["ref", "interpret"])
def test_rglru_scan_initial_state(reference):
    """Two halves, the second started from the first's final state,
    equal the whole; with ``h0`` both match the reference."""
    B, S, R = 2, 64, 256
    a, b, h0 = _scan_inputs(B, S, R, seed=2)
    whole, _ = ops.rglru(_t(a), _t(b), _t(h0))
    h1, hf1 = ops.rglru(_t(a[:, :32]), _t(b[:, :32]), _t(h0))
    h2, hf2 = ops.rglru(_t(a[:, 32:]), _t(b[:, 32:]), hf1)
    torch.testing.assert_close(torch.cat([h1, h2], 1), whole, **SCAN_TOL)
    torch.testing.assert_close(hf2, whole[:, -1], **SCAN_TOL)
    if reference == "ref":
        want = jref.rglru_ref(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(h0))
    else:
        want, _ = jops.rglru(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(h0), impl="interpret", t_blk=32,
                             r_blk=256)
    _close(whole, want, SCAN_TOL)


def test_cpu_scan_launches_no_kernel():
    a, b, _ = _scan_inputs(1, 8, 64)
    before = k2.launches
    h, _ = ops.rglru(_t(a), _t(b))
    torch.testing.assert_close(h, ref.rglru_ref(_t(a), _t(b)))
    assert k2.launches == before


def test_scan_wrapper_refuses_what_it_cannot_launch():
    a, b, _ = _scan_inputs(1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        k2.rglru_scan(_t(a), _t(b))
    meta = torch.empty(1, 8, 64, device="meta")
    before = k2.launches
    with pytest.raises(ValueError, match="CUDA device"):
        k2.rglru_scan(meta, meta)           # the kernel runs on the card
    # the operator on meta: its fake's shapes, no kernel, no plain version
    h, last = ops.rglru(meta, meta)
    assert (h.shape, last.shape) == ((1, 8, 64), (1, 64))
    assert h.device.type == "meta"
    assert k2.launches == before


# ---------------------------------------------------------------------------
# The block's pieces against repro.models.rglru
# ---------------------------------------------------------------------------


def _block_params(cfg, dtype: str, seed=3):
    """One RG-LRU layer's leaves from the reference's ``init_rglru``,
    with a nonzero Λ spread and biases, as numpy."""
    p = jr.init_rglru(jax.random.PRNGKey(seed), cfg, jnp.dtype(dtype))
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    for name in ("ba", "bx"):
        p[name] = rng.standard_normal(p[name].shape).astype(np.float32)
    p["conv_b"] = np.asarray(jnp.asarray(
        rng.standard_normal(p["conv_b"].shape) * 0.1, jnp.dtype(dtype)))
    return p


def _torch_leaves(p):
    return {k: tensor_from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_match_reference(dtype):
    cfg = get_smoke_config(ARCH)
    p = _block_params(cfg, dtype)
    x = np.random.default_rng(4).standard_normal((2, 9, 64))
    xj = jnp.asarray(x, jnp.dtype(dtype))
    aj, gj = jr._gates(xj, {k: jnp.asarray(v) for k, v in p.items()})
    at, gt = tr._gates(tensor_from_numpy(np.asarray(xj)), _torch_leaves(p))
    assert at.dtype == gt.dtype == torch.float32    # JAX promotes to f32
    _close(at, aj, dict(rtol=1e-5, atol=1e-6))
    _close(gt, gj, dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_causal_matches_reference(dtype, with_state):
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 7, 32)), jnp.dtype(dtype))
    w = jnp.asarray(rng.standard_normal((4, 32)) * 0.5, jnp.dtype(dtype))
    b = jnp.asarray(rng.standard_normal(32) * 0.1, jnp.dtype(dtype))
    st = jnp.asarray(rng.standard_normal((2, 3, 32)), jnp.bfloat16) \
        if with_state else None
    want = jr.conv1d_causal(x, w, b, st)
    got = tr.conv1d_causal(*(tensor_from_numpy(np.asarray(v))
                             for v in (x, w, b)),
                           None if st is None
                           else tensor_from_numpy(np.asarray(st)))
    assert got.dtype == tensor_from_numpy(np.asarray(want)).dtype
    # the same left-to-right sum of products in the input dtype: exact
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("decode", [False, True])
def test_rglru_block_matches_reference(decode):
    """The block in float32: the sequence (through the scan) and the
    one-step decode formula with a state."""
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    p = _block_params(cfg, "float32")
    rng = np.random.default_rng(6)
    S = 1 if decode else 12
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    state = jstate = None
    if decode:
        h = rng.standard_normal((2, 64)).astype(np.float32)
        conv = np.asarray(jnp.asarray(rng.standard_normal((2, 3, 64)),
                                      jnp.bfloat16))
        jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        state = {"h": _t(h), "conv": tensor_from_numpy(conv)}
    want, jns = jr.rglru_block(jnp.asarray(x), {k: jnp.asarray(v)
                                                for k, v in p.items()},
                               cfg, jstate)
    got, ns = tr.rglru_block(_t(x), _torch_leaves(p), cfg, state)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    if decode:
        _close(ns["h"], jns["h"], dict(rtol=1e-5, atol=1e-5))
        assert ns["conv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(ns["conv"].float().numpy(),
                                      np.asarray(jns["conv"], np.float32))


# ---------------------------------------------------------------------------
# The smoke model against the JAX model
# ---------------------------------------------------------------------------


def _models(param_dtype: str, **overrides):
    cfg = get_smoke_config(ARCH).replace(param_dtype=param_dtype,
                                         **overrides)
    jcfg = jax_smoke_config(ARCH).replace(param_dtype=param_dtype,
                                          **overrides)
    assert asdict(cfg) == asdict(jcfg)      # the port's config is a copy
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return cfg, jcfg, jparams, tparams


def _tokens(cfg, B, S, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _logits_close(t, j, tol: float):
    want = np.asarray(j, np.float32)
    scale = 1.0 if tol < 1e-3 else float(np.abs(want).max())
    np.testing.assert_allclose(t.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def test_config_is_the_published_one():
    from repro.configs import get_config as jax_config
    cfg = get_config(ARCH)
    assert asdict(cfg) == asdict(jax_config(ARCH))
    kinds = cfg.layer_kinds()
    assert (cfg.n_layers, cfg.n_units, cfg.n_remainder) == (26, 8, 2)
    assert kinds.count(kinds[0]) == 18 and len(kinds) - 18 == 8


def test_converted_weights_keep_layout_and_dtypes():
    """``blocks[pos][name][i]`` → layer ``3i + pos`` and ``rest[j]`` →
    layer ``6 + j``, bit for bit; the gate leaves stay float32 in a
    bfloat16 model."""
    cfg, _, jparams, tparams = _models("bfloat16")
    assert (cfg.n_units, cfg.n_remainder) == (2, 2)
    for i, layer in enumerate(tparams.layers):
        unit, pos = divmod(i, 3)
        src = (jparams["blocks"][pos] if unit < cfg.n_units
               else jparams["rest"][i - 6])
        for name, p in layer.named_parameters():
            leaf = src
            for key in name.split("."):
                leaf = leaf[key]
            leaf = np.asarray(leaf)
            if unit < cfg.n_units:
                leaf = leaf[unit]
            assert torch.equal(p, tensor_from_numpy(leaf)), (i, name)
        if isinstance(layer, RGLRULayer):
            for name, p in layer.leaves().items():
                want = torch.float32 if name in GATE_LEAVES \
                    else torch.bfloat16
                assert p.dtype == want, (i, name)
    assert [type(m).__name__ for m in tparams.layers] == \
        ["RGLRULayer", "RGLRULayer", "AttnLayer"] * 2 + ["RGLRULayer"] * 2


def test_convert_refuses_a_dtype_mismatch():
    """A float32 gate leaf converted from a bfloat16 tree, or a bfloat16
    model fed float32 weights, raises instead of casting."""
    cfg = get_smoke_config(ARCH)                      # bfloat16
    jcfg = jax_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    tree["rest"][0]["wa"] = np.asarray(
        jnp.asarray(tree["rest"][0]["wa"], jnp.bfloat16))
    with pytest.raises(ValueError, match=r"layers\.6\.wa: reference dtype "
                                         r"torch\.bfloat16, port dtype "
                                         r"torch\.float32"):
        params_from_jax(tree, cfg, device="cpu")
    f32 = jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(0), jcfg.replace(param_dtype="float32")))
    with pytest.raises(ValueError, match="embed: reference dtype"):
        params_from_jax(f32, cfg, device="cpu")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(param_dtype):
    cfg, jcfg, jparams, tparams = _models(param_dtype)
    toks = _tokens(cfg, 2, 24)
    lj, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    lt, aux = forward(tparams, torch.from_numpy(toks), cfg)
    assert lt.shape == (2, 24, cfg.padded_vocab()) and float(aux) == 0.0
    _logits_close(lt, lj, LOGIT_TOL[param_dtype])


def test_prefill_state_matches_reference():
    """Last-token logits, the recurrent states and the ring-cache keys
    after a prompt of 12 tokens, against the reference's prefill."""
    cfg, jcfg, jparams, tparams = _models("float32")
    toks = _tokens(cfg, 2, 12)
    lj, cj = j_prefill(jparams, jnp.asarray(toks), jcfg, max_len=24)
    lt, ct = prefill(tparams, torch.from_numpy(toks), cfg, max_len=24)
    _logits_close(lt, lj, LOGIT_TOL["float32"])
    for i, c in enumerate(ct):
        unit, pos = divmod(i, 3)
        want = (jax.tree.map(lambda x: x[unit], cj["blocks"][pos])
                if unit < cfg.n_units else cj["rest"][i - 6])
        if "h" in c:
            assert c["h"].dtype == torch.float32
            assert c["conv"].dtype == torch.bfloat16
            assert c["conv"].shape == (2, cfg.conv_width - 1, 64)
            _close(c["h"], want["h"], dict(rtol=1e-5, atol=1e-5))
            # one bf16 ulp where the f32 inputs round differently
            _close(c["conv"], want["conv"], dict(rtol=2e-2, atol=2e-2))
        else:
            assert c["k"].shape == (2, 16, 1, 16)   # ring: the window
            _close(c["k"], want["k"], dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("source", ["port_forward", "reference_decode"])
def test_decode_matches_forward(source):
    """Prefill 8 tokens, decode to 24 through the 16-slot ring of the
    local layers: each step matches the port's forward (2e-2, the conv
    state is bf16) and the reference's own decode."""
    cfg, jcfg, jparams, tparams = _models("float32")
    assert cfg.window == 16
    B, S, T = 2, 24, 8
    toks = _tokens(cfg, B, S)
    tt = torch.from_numpy(toks)
    full, _ = forward(tparams, tt, cfg)
    _, cache = prefill(tparams, tt[:, :T], cfg, max_len=S)
    _, jcache = j_prefill(jparams, jnp.asarray(toks[:, :T]), jcfg,
                          max_len=S)
    for t in range(T, S):
        step, cache = decode_step(tparams, tt[:, t], torch.tensor(t),
                                  cache, cfg)
        if source == "port_forward":
            torch.testing.assert_close(step, full[:, t], rtol=2e-2,
                                       atol=2e-2)
        else:
            jstep, jcache = j_decode(jparams, jnp.asarray(toks[:, t]),
                                     jnp.asarray(t, jnp.int32), jcache,
                                     jcfg)
            _logits_close(step, jstep, LOGIT_TOL["bfloat16"])


@pytest.mark.parametrize("T", [1, 2])
def test_short_prompt_decode_matches_forward(T):
    """Prompts shorter than ``conv_width − 1``: the port left-pads the
    conv state with zeros, so its decode after prefill equals its own
    forward.  (The reference's does not: it keeps T rows and its serving
    cache holds a stale one — ROADMAP §3.)"""
    cfg, _, _, tparams = _models("float32")
    assert T < cfg.conv_width - 1
    B, S = 2, 10
    tt = torch.from_numpy(_tokens(cfg, B, S, seed=11))
    full, _ = forward(tparams, tt, cfg)
    first, cache = prefill(tparams, tt[:, :T], cfg, max_len=S)
    torch.testing.assert_close(first, full[:, T - 1], rtol=1e-4, atol=1e-4)
    for c in cache:
        if "conv" in c:
            assert c["conv"].shape[1] == cfg.conv_width - 1
            assert not c["conv"][:, :cfg.conv_width - 1 - T].any()
    for t in range(T, S):
        step, cache = decode_step(tparams, tt[:, t], torch.full((B,), t),
                                  cache, cfg)
        torch.testing.assert_close(step, full[:, t], rtol=2e-2, atol=2e-2)


def test_init_params_on_cpu():
    cfg = get_smoke_config(ARCH)
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))
    layer = m.layers[0]
    assert isinstance(layer, RGLRULayer)
    assert layer.wa.dtype == torch.float32 and layer.w_y.dtype == \
        torch.bfloat16
    torch.testing.assert_close(layer.lam, torch.linspace(-2.0, 1.0, 64))
    # the reference's init scales: N(0, 1/k) gate blocks, N(0, 1/d) in
    k = cfg.rnn_width // cfg.n_heads
    assert abs(float(layer.wa.std()) * k ** 0.5 - 1.0) < 0.2
    assert abs(float(layer.w_y.float().std()) * 64 ** 0.5 - 1.0) < 0.2
    assert all(torch.isfinite(p.float()).all() for p in m.parameters())
    cache = init_cache(cfg, 3, 32, device="cpu")
    assert cache[0]["h"].shape == (3, 64) and \
        cache[0]["h"].dtype == torch.float32
    assert cache[0]["conv"].shape == (3, 3, 64) and \
        cache[0]["conv"].dtype == torch.bfloat16
    assert cache[2]["k"].shape == (3, 16, 1, 16)
    toks = torch.from_numpy(_tokens(cfg, 1, 6))
    logits, _ = forward(m, toks, cfg)
    assert torch.isfinite(logits.float()).all()


def _hidden(params, tokens, upto):
    """The residual stream entering layer ``upto`` (RG-LRU layers before
    it)."""
    h = params.embed_tokens(tokens)
    for layer in params.layers[:upto]:
        h, _ = layer(h)
    return h


def test_prompt_longer_than_the_ring():
    """A 21-token prompt into the 16-slot ring of the local layers (21 is
    no multiple of 16: the reference's prefill asserts there): each key
    lands at slot position % 16, and decode matches forward."""
    cfg, _, _, tparams = _models("float32")
    B, S, T = 1, 26, 21
    tt = torch.from_numpy(_tokens(cfg, B, S, seed=12))
    full, _ = forward(tparams, tt, cfg)
    first, cache = prefill(tparams, tt[:, :T], cfg, max_len=64)
    torch.testing.assert_close(first, full[:, T - 1], rtol=1e-4, atol=1e-4)
    _, k_all, _ = tparams.layers[2].qkv(
        _hidden(tparams, tt[:, :T], upto=2),
        torch.arange(T))
    for pos in range(T - 16, T):
        torch.testing.assert_close(cache[2]["k"][0, pos % 16],
                                   k_all[0, pos].to(torch.bfloat16))
    for t in range(T, S):
        step, cache = decode_step(tparams, tt[:, t], torch.tensor(t),
                                  cache, cfg)
        torch.testing.assert_close(step, full[:, t], rtol=2e-2, atol=2e-2)
