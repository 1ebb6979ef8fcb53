"""The port's decoder against the reference's, at smoke size on the CPU.

The weights come from the reference's ``init_params`` and are carried
across with :func:`repro_torch.convert.params_from_jax` (the two inits
draw different numbers from one seed, so they are never compared)."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)

ARCH = "llama3.2-1b"
#: Logits.  float32: the two frameworks differ only in the order of sums.
#: bfloat16 (or a bf16 cache): 2e-2, tests/test_models.py's tolerance,
#: taken of the logits' scale — XLA and PyTorch round some bf16
#: elementwise ops differently (``silu`` lands one ulp apart on about a
#: third of its inputs), and that noise is the same size on logits near
#: zero as on the largest ones.
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


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


def _close(t, j, tol: float):
    want = np.asarray(j, np.float32)
    scale = 1.0 if tol < 1e-3 else float(np.abs(want).max())
    np.testing.assert_allclose(t.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def test_converted_weights_are_bit_exact():
    cfg, _, jparams, tparams = _models("bfloat16")
    blocks = jparams["blocks"][0]
    for i in range(cfg.n_layers):
        want = np.asarray(blocks["mlp"]["w3"][i])
        got = tparams.layers[i].mlp.w3
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, tensor_from_numpy(want))
    assert torch.equal(tparams.embed,
                       tensor_from_numpy(np.asarray(jparams["embed"])))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(param_dtype):
    cfg, jcfg, jparams, tparams = _models(param_dtype)
    toks = _tokens(cfg, 2, 24)
    lj, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    lt, aux = forward(tparams, torch.from_numpy(toks), cfg)
    assert lt.shape == (2, 24, cfg.padded_vocab()) and float(aux) == 0.0
    _close(lt, lj, LOGIT_TOL[param_dtype])


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_prefill_cache_matches_reference(cache_dtype):
    """The port keeps the k/v its attention computed; the reference
    recomputes them — the stored caches agree."""
    cfg, jcfg, jparams, tparams = _models("float32",
                                          cache_dtype=cache_dtype)
    toks = _tokens(cfg, 2, 12)
    lj, cj = j_prefill(jparams, jnp.asarray(toks), jcfg, max_len=16)
    lt, ct = prefill(tparams, torch.from_numpy(toks), cfg, max_len=16)
    _close(lt, lj, LOGIT_TOL["float32"])
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            want = np.asarray(cj["blocks"][0][name][i], np.float32)
            got = ct[i][name]
            assert got.shape == (2, 16, cfg.kv_heads, cfg.head_dim)
            # one bf16 ulp (or int8 step) where float32 rounding differs
            atol = 1.0 if cache_dtype == "int8" else 2e-2
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2e-2, atol=atol)


@pytest.mark.parametrize("source", ["port_forward", "reference_decode"])
def test_decode_matches_forward(source):
    """Prefill T tokens, decode the rest one by one: each step's logits
    match the port's full-sequence forward (2e-2 as the reference test:
    the cache is bf16) and the reference's own decode."""
    cfg, jcfg, jparams, tparams = _models("float32")
    B, S, T = 2, 24, 16
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
            _close(step, jstep, LOGIT_TOL["bfloat16"])   # bf16 cache


def test_vector_pos_decode_matches_scalar():
    cfg, _, _, tparams = _models("float32")
    B, T = 2, 8
    toks = torch.from_numpy(_tokens(cfg, B, T))
    _, c1 = prefill(tparams, toks, cfg, max_len=16)
    _, c2 = prefill(tparams, toks, cfg, max_len=16)
    l1, _ = decode_step(tparams, toks[:, -1], torch.tensor(T), c1, cfg)
    l2, _ = decode_step(tparams, toks[:, -1], torch.full((B,), T), c2, cfg)
    torch.testing.assert_close(l1, l2, rtol=1e-5, atol=1e-6)
    for a, b in zip(c1, c2):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_int8_cache_decode_matches_reference():
    cfg, jcfg, jparams, tparams = _models("float32", cache_dtype="int8")
    B, S, T = 2, 12, 8
    toks = _tokens(cfg, B, S)
    _, cache = prefill(tparams, torch.from_numpy(toks[:, :T]), cfg,
                       max_len=S)
    _, jcache = j_prefill(jparams, jnp.asarray(toks[:, :T]), jcfg,
                          max_len=S)
    for t in range(T, S):
        step, cache = decode_step(tparams, torch.from_numpy(toks[:, t]),
                                  torch.full((B,), t), cache, cfg)
        jstep, jcache = j_decode(jparams, jnp.asarray(toks[:, t]),
                                 jnp.full((B,), t, jnp.int32), jcache,
                                 jcfg)
        _close(step, jstep, LOGIT_TOL["bfloat16"])


def test_init_params_on_cpu():
    cfg = get_smoke_config(ARCH)
    g = torch.Generator().manual_seed(0)
    m = init_params(cfg, g, device="cpu")
    assert m.embed.shape == (cfg.padded_vocab(), cfg.d_model)
    assert m.embed.dtype == torch.bfloat16
    assert len(m.layers) == cfg.n_layers
    assert all(torch.isfinite(p.float()).all() for p in m.parameters())
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))
    cache = init_cache(cfg, 3, 32, device="cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0]["k"].shape == (3, 32, cfg.kv_heads, cfg.head_dim)
