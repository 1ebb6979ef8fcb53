"""The mixture-of-experts configs — mixtral-8x22b (every layer MoE; at
smoke size 4 experts, top-2, window 16) and llama4-maverick-400b-a17b
(dense and MoE layers 1:1; at smoke size 8 experts, top-1, one shared
expert, 4 layers) — against the reference, at smoke size on the CPU:
``moe_apply``, the MoE block, ``forward`` and its aux, ``prefill`` +
``decode_step``, the engine, ``lm_loss`` and its gradients, the train
step, weights, checkpoints and the init.

Weights come from the reference's init (norms drawn nonzero, as in
tests/test_torch_dense.py) through
:func:`repro_torch.convert.params_from_jax`; inputs are made with numpy
from a seed.  Attention goes through the reference's XLA path and the
port's plain version.  Tolerances:

* ``moe_apply`` and the MoE block in float32: outputs and aux at 2e-5;
  in bfloat16 outputs at 2e-2 of their scale, and the aux at 2e-5 for
  ``moe_apply`` (the same bfloat16 input, float32 router math) and at
  2e-2 for the block (whose attention rounds the router's input apart);
* logits at 1e-4 in float32 and 2e-2 of their scale in bfloat16; the
  aux of ``forward`` at 2e-5;
* ``lm_loss`` at rtol 1e-6, gradients at 1e-5 of each leaf's largest
  |g|; a train step as tests/test_torch_train.py holds it;
* greedy tokens and engine events exactly, in float32.

Routing is discrete: a near-tie in the router, or in a capacity cut,
sends a token to another expert and moves its output by O(1).  Where
bfloat16 rounds the two frameworks' inputs to a router apart, the tests
do not widen the tolerance: each side's routes are computed from its own
inputs to every MoE layer, the tokens routed apart are counted, printed
and held apart, and the rest is compared.
"""

import itertools
import math
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.models.transformer as j_transformer
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import lm_loss as j_lm_loss
from repro.models import prefill as j_prefill
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.transformer import _attn_block
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.serving import AutoScaler as JAutoScaler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.train.steps import StepConfig as JStepConfig
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import (named_from_tree, params_from_jax,
                                 params_to_jax, reference_leaves,
                                 tree_from_named)
from repro_torch.launch.serve import report, serve
from repro_torch.models import (decode_step, forward, init_params, lm_loss,
                                prefill)
from repro_torch.models.layers import ZERO_INIT, MoELayer
from repro_torch.models.moe import moe_apply
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import AutoScaler, Request, ServingEngine
from repro_torch.train.steps import StepConfig, make_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]
MOE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: capacity_factor 16 makes every smoke chunk dropless
CAPACITY = {"default": {}, "dropless": {"capacity_factor": 16.0}}


def _cfgs(arch, **overrides):
    cfg = get_smoke_config(arch).replace(**overrides)
    jcfg = jax_smoke_config(arch).replace(**overrides)
    assert asdict(cfg) == asdict(jcfg)      # the port's config is a copy
    return cfg, jcfg


def _nonzero(tree, seed: int):
    """``tree`` (numpy leaves) with every zero-initialised norm drawn from
    N(0, 0.1²), in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if getattr(path[-1], "key", None) not in ZERO_INIT:
            return x
        return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(fill, tree)


_MODELS: dict = {}


def _models(arch: str, param_dtype: str = "float32", **overrides):
    """(cfg, jcfg, jparams, tparams) with nonzero norms; cached, as every
    test reads them only."""
    key = (arch, param_dtype, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        cfg, jcfg = _cfgs(arch, param_dtype=param_dtype, **overrides)
        tree = _nonzero(jax.tree.map(
            np.asarray, j_init(jax.random.PRNGKey(0), jcfg)), seed=1)
        _MODELS[key] = (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
                        params_from_jax(tree, cfg, device="cpu"))
    return _MODELS[key]


def _tokens(cfg, B, S, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _close(t, j, tol: float):
    want = np.asarray(j, np.float32)
    scale = 1.0 if tol < 1e-3 else float(np.abs(want).max())
    np.testing.assert_allclose(t.detach().float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


# -- routes -------------------------------------------------------------------


def _port_choices(x: torch.Tensor, router: torch.Tensor, k: int):
    """The port's top-k experts for each token of x (B, S, d)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    return torch.topk(probs, k, dim=-1).indices.numpy()


def _ref_choices(x, router, k: int):
    """The reference's top-k experts for each token of x (B, S, d)."""
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.float32)
                           @ jnp.asarray(router, jnp.float32), axis=-1)
    return np.asarray(lax.top_k(probs, k)[1])


def _kept(idx: np.ndarray, cfg) -> np.ndarray:
    """Which (token, slot) routes of ``idx`` (B, S, k) fit their expert's
    capacity: per chunk and batch row, slot-major, every route counted."""
    B, S, k = idx.shape
    chunk = cfg.moe_seq_chunk
    c = S if chunk <= 0 or S <= chunk else chunk
    C = max(k, int(math.ceil(c * k / cfg.n_experts * cfg.capacity_factor)))
    kept = np.zeros(idx.shape, bool)
    for b in range(B):
        for c0 in range(0, S, c):
            fill = np.zeros(cfg.n_experts, int)
            for slot in range(k):
                for t in range(c0, c0 + c):
                    e = idx[b, t, slot]
                    kept[b, t, slot] = fill[e] < C
                    fill[e] += 1
    return kept


def _routed_apart(port_in, ref_in, cfg) -> np.ndarray:
    """(B, S) mask of the tokens whose routes (experts, and whether each
    fits) differ between the port and the reference, each from its own
    inputs ``(x, router)`` to one MoE layer."""
    ip = _port_choices(*port_in, cfg.top_k)
    ir = _ref_choices(*ref_in, cfg.top_k)
    return ((ip != ir) | (_kept(ip, cfg) != _kept(ir, cfg))).any(-1)


@pytest.fixture
def ref_moe_inputs(monkeypatch):
    """The (x, router) of every call of the reference's ``moe_apply``
    from its transformer, in call order — through ``jax.debug.callback``,
    so also from inside the scan over layers."""
    seen = []
    inner = j_transformer.moe_apply

    def recording(x, p, cfg, **kw):
        jax.debug.callback(
            lambda a, r: seen.append((np.asarray(a), np.asarray(r))),
            x, p["router"], ordered=True)
        return inner(x, p, cfg, **kw)
    monkeypatch.setattr(j_transformer, "moe_apply", recording)
    return seen


def _port_moe_inputs(layers) -> tuple[list, list]:
    """Forward pre-hooks that record the (x, router) of every MoE call of
    ``layers``; returns (records, hooks)."""
    seen, hooks = [], []
    for layer in layers:
        if isinstance(layer, MoELayer):
            hooks.append(layer.moe.register_forward_pre_hook(
                lambda m, args: seen.append((args[0].detach(),
                                             m.router.detach()))))
    return seen, hooks


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    assert asdict(get_config(arch)) == asdict(jax_config(arch))
    assert asdict(get_smoke_config(arch)) == asdict(jax_smoke_config(arch))
    assert get_config(arch).param_count() == jax_config(arch).param_count()


# -- moe_apply ----------------------------------------------------------------


def _moe_case(arch, dtype, seed=0, **overrides):
    """The config, the reference's expert weights (float32 numpy, router
    float32 on both sides, the rest cast to ``dtype``) and an input (2,
    32, d) whose tokens share a common direction, so that they crowd the
    same experts and the default capacity drops routes."""
    cfg, jcfg = _cfgs(arch, param_dtype=dtype, **overrides)
    p = jax.tree.map(np.asarray,
                     j_init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 32, cfg.d_model))
         + 1.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]

    def to_j(path, a):
        keep = getattr(path[-1], "key", None) == "router"
        return jnp.asarray(a) if keep else jnp.asarray(a).astype(jdt)

    def to_t(path, a):
        keep = getattr(path[-1], "key", None) == "router"
        return torch.from_numpy(np.array(a)).to(
            torch.float32 if keep else tdt)
    jp = jax.tree_util.tree_map_with_path(to_j, p)
    tp = jax.tree_util.tree_map_with_path(to_t, p)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    return cfg, jcfg, p, jp, tp, xj, xt


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, capacity, chunk):
    """float32 outputs and aux against the reference's ``moe_apply``: at
    the default capacity (where routes are dropped) and dropless, the
    sequence whole and in chunks of 16, llama4's shared expert
    included."""
    cfg, jcfg, p, jp, tp, xj, xt = _moe_case(
        arch, "float32", moe_seq_chunk=chunk, **CAPACITY[capacity])
    oj, aj = j_moe_apply(xj, jp, jcfg)
    ot, at = moe_apply(xt, tp, cfg)
    assert ot.shape == xt.shape and at.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(at.item(), float(aj), rtol=2e-5, atol=2e-5)
    idx = _port_choices(xt, tp["router"], cfg.top_k)
    assert (idx == _ref_choices(xj, jp["router"], cfg.top_k)).all()
    dropped = int((~_kept(idx, cfg)).sum())
    assert (dropped > 0) if capacity == "default" else (dropped == 0)
    assert ("shared" in tp) == (arch == "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    """bfloat16 weights and the same bfloat16 input on both sides, at the
    default capacity: the tokens that route alike at 2e-2 of the output's
    scale, the aux at 2e-5; tokens routed apart are counted and held
    apart."""
    cfg, jcfg, p, jp, tp, xj, xt = _moe_case(arch, "bfloat16")
    oj, aj = j_moe_apply(xj, jp, jcfg)
    ot, at = moe_apply(xt, tp, cfg)
    assert ot.dtype == torch.bfloat16
    apart = _routed_apart((xt, tp["router"]), (xj, jp["router"]), cfg)
    print(f"{arch}: {int(apart.sum())} of {apart.size} tokens routed apart")
    assert apart.mean() < 0.1
    want = np.asarray(oj, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(ot.float().numpy()[~apart], want[~apart],
                               rtol=2e-2, atol=2e-2 * scale)
    np.testing.assert_allclose(at.item(), float(aj), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("leaf", ["router", "w3", "shared.w2"])
def test_the_moe_test_sees_each_leaf(leaf):
    """Zeroing the router, w3 or the shared expert's w2 on the reference's
    side only moves its output far past the float32 tolerance from the
    port's, so the parity test above would see the port lose one."""
    cfg, jcfg, p, jp, tp, xj, xt = _moe_case("llama4-maverick-400b-a17b",
                                             "float32")
    ot, _ = moe_apply(xt, tp, cfg)
    *path, last = leaf.split(".")
    d = jp
    for key in path:
        d = d[key]
    d[last] = jnp.zeros_like(d[last])
    oj, _ = j_moe_apply(xj, jp, jcfg)
    assert float(np.abs(ot.numpy() - np.asarray(oj)).max()) \
        > 100 * MOE_TOL["float32"]


# -- the MoE block ------------------------------------------------------------


def _block_weights(cfg, seed: int) -> dict:
    """A reference MoE block's weights: attention and norms drawn
    nonzero, the experts from the reference's ``init_moe``, float32."""
    rng = np.random.default_rng(seed)
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def n(*shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return {"ln1": n(d, s=0.1), "ln2": n(d, s=0.1),
            "wq": n(d, H * D, s=d ** -0.5), "wk": n(d, K * D, s=d ** -0.5),
            "wv": n(d, K * D, s=d ** -0.5),
            "wo": n(H * D, d, s=(H * D) ** -0.5),
            "moe": jax.tree.map(np.asarray, j_init_moe(
                jax.random.PRNGKey(seed), cfg, jnp.float32))}


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_the_reference_block(arch, dtype, local,
                                               ref_moe_inputs):
    """``MoELayer`` against the reference's ``_attn_block`` with ``moe``
    in place of ``mlp``: the block's output and its aux.  Local, with
    the smoke window (16) shorter than the 32 positions."""
    cfg, jcfg = _cfgs(arch, param_dtype=dtype)
    p = _block_weights(jcfg, seed=3)
    jdt, tdt = DTYPES[dtype]
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a) if path[-1].key == "router"
        else jnp.asarray(a).astype(jdt), p)
    layer = MoELayer(cfg, dtype=tdt, device="cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            leaf = p
            for key in name.split("."):
                leaf = leaf[key]
            w.copy_(torch.from_numpy(np.array(leaf)).to(w.dtype))
    assert layer.moe.router.dtype == torch.float32
    B, S = 2, 32
    h = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    oj, aj, cache = _attn_block(jnp.asarray(h).astype(jdt), jp, jcfg, None,
                                local=local, positions=jnp.arange(S))
    jax.effects_barrier()
    assert cache is None
    seen, hooks = _port_moe_inputs([layer])
    ot, k, v, at = layer(torch.from_numpy(h).to(tdt), torch.arange(S),
                         local=local)
    for hk in hooks:
        hk.remove()
    assert ot.dtype == tdt and k.shape == (B, S, cfg.kv_heads, cfg.head_dim)
    apart = _routed_apart(seen[0], ref_moe_inputs[0], cfg)
    print(f"{arch} {dtype} local={local}: {int(apart.sum())} of "
          f"{apart.size} tokens routed apart")
    if dtype == "float32":
        assert not apart.any()
    assert apart.mean() < 0.1
    want = np.asarray(oj, np.float32)
    tol = MOE_TOL[dtype]
    scale = 1.0 if dtype == "float32" else float(np.abs(want).max())
    np.testing.assert_allclose(ot.float().numpy()[~apart], want[~apart],
                               rtol=tol, atol=tol * scale)
    if not apart.any():
        # in bfloat16 the routers' inputs differ by the attention's
        # rounding, and the aux with them
        np.testing.assert_allclose(at.item(), float(aj), rtol=tol, atol=tol)


# -- the model: forward, prefill and decode -----------------------------------


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, capacity):
    """float32 logits (1e-4) and the summed aux (2e-5), 24 positions (past
    mixtral's smoke window of 16)."""
    cfg, jcfg, jparams, tparams = _models(arch, **CAPACITY[capacity])
    toks = _tokens(cfg, 2, 24)
    lj, aj = j_forward(jparams, jnp.asarray(toks), jcfg)
    lt, at = forward(tparams, torch.from_numpy(toks), cfg)
    assert lt.shape == (2, 24, cfg.padded_vocab())
    _close(lt, lj, LOGIT_TOL["float32"])
    assert float(at) > 0.0
    np.testing.assert_allclose(at.item(), float(aj), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_reference(arch, ref_moe_inputs):
    """bfloat16 logits at 2e-2 of their scale.  The two frameworks round
    each layer's input apart, so a near-tie in a router can send a token
    to another expert: every MoE layer's routes are compared, and from
    the first token routed apart in a batch row on, that row's positions
    (which attend to it, or share its capacity) are held apart."""
    cfg, jcfg, jparams, tparams = _models(arch, "bfloat16")
    toks = _tokens(cfg, 2, 24)
    seen, hooks = _port_moe_inputs(tparams.layers)
    with torch.no_grad():
        lt, _ = forward(tparams, torch.from_numpy(toks), cfg)
    for hk in hooks:
        hk.remove()
    lj, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    jax.effects_barrier()
    assert len(seen) == len(ref_moe_inputs) == sum(
        isinstance(layer, MoELayer) for layer in tparams.layers)
    apart = np.zeros(toks.shape, bool)
    for port_in, ref_in in zip(seen, ref_moe_inputs):
        apart |= _routed_apart(port_in, ref_in, cfg)
    held = ~np.maximum.accumulate(apart, axis=1)
    print(f"{arch} bf16: {int(apart.sum())} tokens routed apart over "
          f"{len(seen)} MoE layers; {int(held.sum())} of {held.size} "
          "positions compared")
    assert held.mean() >= 0.5
    want = np.asarray(lj, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(lt.float().numpy()[held], want[held],
                               rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, capacity):
    """16 prompt tokens, 4 decoded (past mixtral's smoke window of 16),
    float32 with a float32 cache: prefill
    and every step's logits against the reference's (1e-4) — at the
    default capacity the prefill drops routes, as the reference's —
    and, dropless, against the port's own forward, as the reference's
    test_decode_matches_forward holds it (capacity differs between a
    20-token forward and a one-token step)."""
    cfg, jcfg, jparams, tparams = _models(arch, cache_dtype="float32",
                                          **CAPACITY[capacity])
    B, T, S = 2, 16, 20
    toks = _tokens(cfg, B, S)
    tt = torch.from_numpy(toks)
    full, _ = forward(tparams, tt, cfg)
    lt, cache = prefill(tparams, tt[:, :T], cfg, max_len=S)
    lj, jcache = j_prefill(jparams, jnp.asarray(toks[:, :T]), jcfg,
                           max_len=S)
    _close(lt, lj, LOGIT_TOL["float32"])
    if capacity == "dropless":
        _close(lt, full[:, T - 1].numpy(), LOGIT_TOL["float32"])
    for t in range(T, S):
        pos = np.full((B,), t, np.int32) if t % 2 else np.int32(t)
        step, cache = decode_step(tparams, tt[:, t], torch.as_tensor(pos),
                                  cache, cfg)
        jstep, jcache = j_decode(jparams, jnp.asarray(toks[:, t]),
                                 jnp.asarray(pos), jcache, jcfg)
        _close(step, jstep, LOGIT_TOL["float32"])
        if capacity == "dropless":
            _close(step, full[:, t].numpy(), LOGIT_TOL["float32"])
    assert len(cache) == cfg.n_layers


# -- the engine ---------------------------------------------------------------


def _step_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _key(e):
    """What must agree: everything but PREDICTION times, which the
    clock-less autoscaler governor reads from the wall clock."""
    if e.kind.name == "PREDICTION":
        return e.kind.name, dict(e.data)
    return (e.kind.name, e.time, e.task_id, e.type_name, e.cost, e.elapsed,
            dict(e.data))


def _serve(cfg, params, engine_cls, request_cls, scaler_cls, prompts,
           max_new, max_batch, **kw):
    engine = engine_cls(cfg, params, max_batch=max_batch, max_len=64,
                        clock=_step_clock(), **kw)
    events = []
    engine.bus.subscribe(events.append)
    scaler = scaler_cls(engine.monitor, max_replicas=max_batch,
                        policy="prediction", bus=engine.bus)
    reqs = [engine.submit(request_cls(prompt=list(p),
                                      max_new_tokens=max_new))
            for p in prompts]
    targets = []
    while engine.load:
        targets.append(scaler.target(
            len(engine.queue), sum(r is not None for r in engine.active)))
        engine.tick()
    return [r.output for r in reqs], [_key(e) for e in events], targets


#: prompts in the 16 bucket (4, 11 and 16 tokens) and the 32 bucket (20
#: tokens, and 32 exactly: past mixtral's smoke window of 16 the
#: reference keeps bucket padding in its rings (R4, ROADMAP §3), and a
#: 32-token prompt has none)
ENGINE_PROMPTS = {
    "mixtral-8x22b": [[5, 9, 2, 7], list(range(30, 46)),
                      list(range(100, 132)), list(range(60, 71))],
    "llama4-maverick-400b-a17b": [[5, 9, 2, 7], list(range(30, 46)),
                                  list(range(100, 120)),
                                  list(range(60, 71))],
}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """Greedy tokens, events and the Δ trace against the JAX engine, in
    float32 at the default capacity: bucketed prefills (the MoE runs on
    the padded prompt on both sides) and decode ticks over every slot."""
    cfg, jcfg, jparams, tparams = _models(arch)
    prompts = ENGINE_PROMPTS[arch]
    want = _serve(jcfg, jparams, JServingEngine, JRequest, JAutoScaler,
                  prompts, 14, 2)
    got = _serve(cfg, tparams, ServingEngine, Request, AutoScaler,
                 prompts, 14, 2, device="cpu")
    assert got[0] == want[0]                      # greedy tokens
    assert got[1] == want[1]                      # events, ids, costs
    assert got[2] == want[2]                      # AutoScaler Δ trace
    assert any(len(set(o)) > 1 for o in got[0])   # not a repeated token


#: a prompt seed for which bucket padding changes mixtral's first token
#: (R8): found by trying seeds 0, 1, …; seed 0 shows it
R8_SEED = 0


def test_bucket_sets_moe_capacity_r8():
    """R8 (ROADMAP §3): the engine pads a 12-token prompt to its 16
    bucket, and the MoE runs on the padded length — capacity from the
    bucket, and the pads' first choices counted in ``fill`` before the
    real tokens' second.  The port's engine gives the JAX engine's first
    token, which here is not ``forward``'s on the unpadded prompt."""
    cfg, jcfg, jparams, tparams = _models("mixtral-8x22b")
    prompt = np.random.default_rng(R8_SEED).integers(
        0, cfg.vocab, 12).tolist()
    firsts = []
    for eng_cls, req_cls, params, kw in (
            (JServingEngine, JRequest, jparams, {}),
            (ServingEngine, Request, tparams, {"device": "cpu"})):
        eng = eng_cls(cfg if eng_cls is ServingEngine else jcfg, params,
                      max_batch=1, max_len=64, **kw)
        req = eng.submit(req_cls(prompt=list(prompt), max_new_tokens=1))
        eng.run_until_drained()
        firsts.append(req.output[0])
    with torch.no_grad():
        lt, _ = forward(tparams, torch.tensor([prompt]), cfg)
    lj, _ = j_forward(jparams, jnp.asarray([prompt]), jcfg)
    unpadded = int(torch.argmax(lt[0, -1, :cfg.vocab]))
    assert unpadded == int(jnp.argmax(lj[0, -1, :cfg.vocab]))
    assert firsts[0] == firsts[1] != unpadded


# -- loss, gradients and the train step ---------------------------------------


def _batch(cfg, A, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (A, B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., -1] = -1
    labels[..., :3] = -1
    return toks, labels


@pytest.mark.parametrize("remat,chunk", [("none", 0), ("full", 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, remat, chunk):
    """``lm_loss`` (CE + 0.01 × the aux) and every parameter's gradient
    against ``jax.value_and_grad`` of the reference's, at the default
    capacity: the router's through the gates and the aux; without remat
    and the MoE whole, and with remat and the MoE in checkpointed chunks
    of 16."""
    cfg, jcfg, jparams, tparams = _models(arch, remat=remat,
                                          moe_seq_chunk=chunk)
    toks, labels = _batch(cfg, 1, 2, 32, seed=0)
    lj, gj = jax.value_and_grad(j_lm_loss)(
        jparams, jnp.asarray(toks[0]), jnp.asarray(labels[0]), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu").requires_grad_(True)
    lt = lm_loss(model, torch.from_numpy(toks[0]).long(),
                 torch.from_numpy(labels[0]).long(), cfg)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    lt.backward()
    want = named_from_tree(jax.tree.map(np.asarray, gj), cfg)
    for name, p in model.named_parameters():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
        if name.endswith("router"):
            assert float(p.grad.abs().max()) > 0, name


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One step of llama4-maverick at smoke size (warmup 0): loss (rtol
    1e-6), grad norm (1e-5), and every parameter within one AdamW step
    and 1e-6 at all but 0.1 % of the elements."""
    cfg, jcfg, jparams, _ = _models("llama4-maverick-400b-a17b")
    tree = jax.tree.map(np.asarray, jparams)
    model = params_from_jax(tree, cfg, device="cpu")
    jstep = jax.jit(j_make_train_step(jcfg, None, JAdamWConfig(),
                                      JStepConfig(accum=accum, warmup=0)))
    tstep = make_train_step(cfg, AdamWConfig(),
                            StepConfig(accum=accum, warmup=0))
    toks, labels = _batch(cfg, accum, 2, 16, seed=4)
    jp, js, jm = jstep(jparams, j_adamw_init(jparams, JAdamWConfig()),
                       jnp.asarray(0, jnp.int32),
                       {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    model, ts, tm = tstep(model, adamw_init(dict(model.named_parameters()),
                                            AdamWConfig()), 0,
                          {"tokens": torch.from_numpy(toks).long(),
                           "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-5)
    want = named_from_tree(jax.tree.map(np.asarray, jp), cfg)
    for name, p in model.named_parameters():
        got = p.detach().float().numpy()
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(got, w, rtol=0, atol=3e-4, err_msg=name)
        assert np.mean(np.abs(got - w) > 1e-6) <= 1e-3, name


# -- weights, checkpoints and the init ----------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_port(arch):
    """bf16 weights come back bit for bit in the reference's tree: the
    float32 router, the 3-D expert stacks (4-D once stacked over
    units), llama4's nested ``moe.shared`` and its two pattern
    positions; one group of port parameters for each reference leaf."""
    cfg, jcfg = _cfgs(arch)
    tree = _nonzero(jax.tree.map(np.asarray,
                                 j_init(jax.random.PRNGKey(2), jcfg)), 3)
    model = params_from_jax(tree, cfg, device="cpu")
    back = params_to_jax(model, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, _bits(b))
    moe = tree["blocks"][len(cfg.pattern) - 1]["moe"]
    assert moe["router"].dtype == np.float32
    assert moe["w1"].shape == (cfg.n_units, cfg.n_experts, cfg.d_model,
                               cfg.d_ff)
    assert ("shared" in moe) == bool(cfg.n_shared_experts)
    groups = reference_leaves([n for n, _ in model.named_parameters()], cfg)
    assert len(groups) == len(jax.tree.leaves(tree))
    if arch == "llama4-maverick-400b-a17b":
        assert "mlp" in tree["blocks"][0] and "moe" not in tree["blocks"][0]
        assert ["layers.1.moe.shared.w2", "layers.3.moe.shared.w2"] in groups
        assert ["layers.1.moe.w1", "layers.3.moe.w1"] in groups
    else:
        assert ["layers.0.moe.router", "layers.1.moe.router"] in groups


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_the_packages(arch, tmp_path):
    """The params tree saved by the port restores bit for bit in the
    reference, and the reference's in the port."""
    cfg, jcfg = _cfgs(arch)
    tree = _nonzero(jax.tree.map(np.asarray,
                                 j_init(jax.random.PRNGKey(4), jcfg)), 5)
    model = params_from_jax(tree, cfg, device="cpu")
    port_tree = tree_from_named(dict(model.named_parameters()), cfg)
    save_checkpoint(tmp_path / "port", 1, port_tree)
    got, step = j_restore(tmp_path / "port", None,
                          jax.tree.map(jnp.asarray, tree))
    assert step == 1
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    j_save(tmp_path / "jax", 2, jax.tree.map(jnp.asarray, tree))
    like = jax.tree.map(torch.zeros_like, port_tree)
    back, step = restore_checkpoint(tmp_path / "jax", None, like)
    assert step == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(port_tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_gives_the_moe_leaves(arch):
    """The port's own init: every leaf with the reference's name, shape
    and dtype (the router float32 in a bfloat16 model), and the MoE
    leaves at the reference's scales by their sample standard deviation
    (within 5 %): N(0, 1/d) for the router, w1 and w3, N(0, 1/ff) for
    w2, the shared expert as an MLP.  Widened (d_model 256, d_ff 512) so
    that each sample is large."""
    over = {"d_model": 256, "d_ff": 512}
    cfg, jcfg = _cfgs(arch, **over)
    shapes = named_from_tree(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))), cfg)
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    named = dict(model.named_parameters())
    assert set(named) == set(shapes)
    for name, p in named.items():
        assert tuple(p.shape) == shapes[name].shape, name
        assert str(p.dtype).removeprefix("torch.") \
            == str(shapes[name].dtype), name
    d, ff = cfg.d_model, cfg.d_ff
    scale = {"router": d, "w1": d, "w3": d, "w2": ff, "shared.w1": d,
             "shared.w3": d, "shared.w2": ff * cfg.n_shared_experts}
    seen = set()
    for name, p in named.items():
        _, _, leaf = name.partition(".moe.")
        if not leaf:
            continue
        assert p.float().std().item() == pytest.approx(
            scale[leaf] ** -0.5, rel=0.05), name
        seen.add(leaf)
    assert {"router", "w1", "w2", "w3"} <= seen
    assert named[next(n for n in named if n.endswith("moe.router"))].dtype \
        == torch.float32


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-9b"])
def test_dense_init_is_unchanged_by_the_expert_fill(arch):
    """The dense configs' seeded init draws each leaf whole, in the same
    order as before the MoE layers came: every parameter, bit for bit,
    replayed here from the generator (embed; lm_head when untied; per
    layer wq, wk, wv, wo, then the MLP's w1, w2, w3; zeros elsewhere)."""
    cfg = get_smoke_config(arch).replace(tie_embeddings=False)
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    g = torch.Generator().manual_seed(0)
    d = cfg.d_model

    def draw(shape, fan):
        return (torch.randn(shape, generator=g, dtype=torch.float32)
                * (1.0 / math.sqrt(fan))).to(torch.bfloat16)
    want = {"embed": (torch.randn((cfg.padded_vocab(), d), generator=g)
                      / math.sqrt(d)).to(torch.bfloat16)}
    want["lm_head"] = (torch.randn((d, cfg.padded_vocab()), generator=g)
                       / math.sqrt(d)).to(torch.bfloat16)
    H, K, D, ff = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
    for i in range(cfg.n_layers):
        for leaf, shape, fan in (
                ("wq", (d, H * D), d), ("wk", (d, K * D), d),
                ("wv", (d, K * D), d), ("wo", (H * D, d), H * D),
                ("mlp.w1", (d, ff), d), ("mlp.w2", (ff, d), ff),
                ("mlp.w3", (d, ff), d)):
            want[f"layers.{i}.{leaf}"] = draw(shape, fan)
    for name, p in model.named_parameters():
        w = want.get(name, torch.zeros_like(p))
        assert torch.equal(p.view(torch.int16), w.view(torch.int16)), name


# -- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu(arch):
    cfg = get_smoke_config(arch)
    result = serve(cfg, requests=5, max_batch=2, max_new=4, device="cpu")
    assert all(r.done and len(r.output) == 4 for r in result["requests"])
    assert result["engine"].prefills == 5
    assert "tok/s" in report(result)[0]


def test_serve_launcher_command_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x22b", "--smoke", "--requests", "3", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "3 requests" in out.stdout and "tok/s" in out.stdout
