"""The five dense attention configs the port gained — gemma2-9b,
qwen1.5-110b, deepseek-coder-33b, internvl2-1b and musicgen-medium —
against the reference, at smoke size on the CPU (their frontend prefix is
in tests/test_torch_prefix.py).

The reference initialises norms and qkv biases to zero, so a bias or a
post-norm that the port dropped or misplaced would pass a parity test
run on its init.  Every model here therefore gets nonzero random norm,
post-norm and bias weights (:func:`_nonzero`), the same on both sides:
the tree is changed in numpy and carried across with
:func:`repro_torch.convert.params_from_jax`.  Attention goes through the
reference's plain XLA path and the port's plain version (``ref.py``).

Tolerances, as tests/test_torch_model.py states them: float32 logits at
1e-4 (the frameworks differ in the order of sums), bfloat16 logits — or
logits read through the bfloat16 cache — at 2e-2 of the logits' scale;
an attention block's output at 2e-5 in float32 and 2e-2 of its scale in
bfloat16; greedy tokens and engine events exactly, in float32.
"""

import itertools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.models.transformer import _attn_block
from repro.serving import AutoScaler as JAutoScaler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import (params_from_jax, params_to_jax,
                                 reference_leaves, tree_from_named)
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.models.layers import ZERO_INIT, AttnLayer
from repro_torch.serving import AutoScaler, Request, ServingEngine

ARCHS = ["gemma2-9b", "qwen1.5-110b", "deepseek-coder-33b", "internvl2-1b",
         "musicgen-medium"]
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
BLOCK_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _nonzero(tree, seed: int):
    """``tree`` (numpy leaves) with every zero-initialised norm and bias
    drawn from N(0, 0.1²), in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if getattr(path[-1], "key", None) not in ZERO_INIT:
            return x
        return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(fill, tree)


def _cfgs(arch: str, **overrides):
    cfg = get_smoke_config(arch).replace(**overrides)
    jcfg = jax_smoke_config(arch).replace(**overrides)
    assert asdict(cfg) == asdict(jcfg)      # the port's config is a copy
    return cfg, jcfg


_MODELS: dict = {}


def _models(arch: str, param_dtype: str = "float32", **overrides):
    """(cfg, jcfg, jparams, tparams) with nonzero norms and biases;
    cached, as every test reads them only."""
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
    np.testing.assert_allclose(t.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


# -- configs ----------------------------------------------------------------------


def test_arch_ids_hold_the_ten_reference_configs():
    assert set(ARCH_IDS) == {
        "llama3.2-1b", "recurrentgemma-2b", "rwkv6-7b", "gemma2-9b",
        "qwen1.5-110b", "deepseek-coder-33b", "internvl2-1b",
        "musicgen-medium", "mixtral-8x22b", "llama4-maverick-400b-a17b"}
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    assert asdict(get_config(arch)) == asdict(jax_config(arch))
    assert asdict(get_smoke_config(arch)) == asdict(jax_smoke_config(arch))
    assert get_config(arch).param_count() == jax_config(arch).param_count()


# -- the attention block -----------------------------------------------------------

#: name → (arch, overrides): each of the block's options at least once
BLOCKS = {
    "gemma2": ("gemma2-9b", {}),                 # geglu, post-norms, cap 50
    "qwen": ("qwen1.5-110b", {}),                # qkv bias, swiglu
    "musicgen": ("musicgen-medium", {}),         # gelu, MHA
    "everything": ("gemma2-9b", {"qkv_bias": True, "attn_softcap": 5.0}),
}


def _block_weights(cfg, seed: int) -> dict:
    """A reference attention block's weights, all nonzero, float32."""
    rng = np.random.default_rng(seed)
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def n(*shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    p = {"ln1": n(d, s=0.1), "ln2": n(d, s=0.1),
         "wq": n(d, H * D, s=d ** -0.5), "wk": n(d, K * D, s=d ** -0.5),
         "wv": n(d, K * D, s=d ** -0.5), "wo": n(H * D, d, s=(H * D) ** -0.5),
         "mlp": {"w1": n(d, cfg.d_ff, s=d ** -0.5),
                 "w2": n(cfg.d_ff, d, s=cfg.d_ff ** -0.5)}}
    if cfg.mlp in ("swiglu", "geglu"):
        p["mlp"]["w3"] = n(d, cfg.d_ff, s=d ** -0.5)
    if cfg.qkv_bias:
        p.update(bq=n(H * D, s=0.5), bk=n(K * D, s=0.5), bv=n(K * D, s=0.5))
    if cfg.post_norms:
        p.update(ln1_post=n(d, s=0.1), ln2_post=n(d, s=0.1))
    return p


def _port_block(cfg, p: dict, dtype: str) -> AttnLayer:
    layer = AttnLayer(cfg, dtype=DTYPES[dtype][1], device="cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            leaf = p
            for key in name.split("."):
                leaf = leaf[key]
            w.copy_(torch.from_numpy(leaf).to(w.dtype))
    return layer


def _run_blocks(name, dtype, local, p=None):
    arch, over = BLOCKS[name]
    cfg, jcfg = _cfgs(arch, **over)
    p = _block_weights(cfg, seed=3) if p is None else p
    B, S = 2, 32                    # past the smoke window (16)
    h = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    oj, aux, cache = _attn_block(jnp.asarray(h).astype(jdt), jp, jcfg, None,
                                 local=local, positions=jnp.arange(S))
    assert float(aux) == 0.0 and cache is None
    ot, k, v = _port_block(cfg, p, dtype)(torch.from_numpy(h).to(tdt),
                                          torch.arange(S), local=local)
    assert ot.dtype == tdt and k.shape == (B, S, cfg.kv_heads, cfg.head_dim)
    return ot, oj


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(BLOCKS))
def test_attn_layer_matches_the_reference_block(name, dtype, local):
    """``AttnLayer`` against ``_attn_block`` with nonzero biases and
    post-norm weights: every MLP kind, the softcap and, local, the
    window."""
    ot, oj = _run_blocks(name, dtype, local)
    want = np.asarray(oj, np.float32)
    tol = BLOCK_TOL[dtype]
    scale = 1.0 if dtype == "float32" else float(np.abs(want).max())
    np.testing.assert_allclose(ot.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("leaf", ["bq", "bk", "bv", "ln1_post",
                                  "ln2_post"])
def test_the_block_test_sees_each_bias_and_post_norm(leaf):
    """Zeroing one of these leaves moves the reference block's output by
    far more than the float32 tolerance, so the parity test above would
    notice the port dropping it."""
    arch, over = BLOCKS["everything"]
    cfg, _ = _cfgs(arch, **over)
    p = _block_weights(cfg, seed=3)
    _, full = _run_blocks("everything", "float32", True, p)
    _, without = _run_blocks("everything", "float32", True,
                             {**p, leaf: np.zeros_like(p[leaf])})
    assert float(np.abs(np.asarray(full) - np.asarray(without)).max()) \
        > 100 * BLOCK_TOL["float32"]


# -- the model: forward, prefill and decode ---------------------------------------------


@pytest.mark.parametrize("param_dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, param_dtype):
    cfg, jcfg, jparams, tparams = _models(arch, param_dtype)
    toks = _tokens(cfg, 2, 24)        # past gemma2's smoke window of 16
    lj, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    lt, aux = forward(tparams, torch.from_numpy(toks), cfg)
    assert lt.shape == (2, 24, cfg.padded_vocab()) and float(aux) == 0.0
    _close(lt, lj, LOGIT_TOL[param_dtype])


def _decode_both(arch, T, S, cache_dtype="bfloat16", vector_pos=False):
    """Prefill T tokens in both packages, then decode to S: each step's
    logits against the reference's decode (2e-2 of the scale: the cache
    is bfloat16 or int8) and, with the bfloat16 cache, the port's
    forward."""
    cfg, jcfg, jparams, tparams = _models(arch, cache_dtype=cache_dtype)
    B = 2
    toks = _tokens(cfg, B, S)
    tt = torch.from_numpy(toks)
    full, _ = forward(tparams, tt, cfg)
    lt, cache = prefill(tparams, tt[:, :T], cfg, max_len=S)
    lj, jcache = j_prefill(jparams, jnp.asarray(toks[:, :T]), jcfg,
                           max_len=S)
    _close(lt, lj, LOGIT_TOL["float32"])
    torch.testing.assert_close(lt, full[:, T - 1], rtol=1e-4, atol=1e-4)
    for t in range(T, S):
        pos = np.full((B,), t, np.int32) if vector_pos else np.int32(t)
        step, cache = decode_step(tparams, tt[:, t], torch.as_tensor(pos),
                                  cache, cfg)
        jstep, jcache = j_decode(jparams, jnp.asarray(toks[:, t]),
                                 jnp.asarray(pos), jcache, jcfg)
        _close(step, jstep, LOGIT_TOL["bfloat16"])
        if cache_dtype == "bfloat16":   # int8 keys are 1/42 steps apart
            _close(step, full[:, t].numpy(), LOGIT_TOL["bfloat16"])
    return cfg, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """12 prompt tokens, 12 decoded: gemma2's local layers decode past
    their 16-slot ring."""
    cfg, cache = _decode_both(arch, 12, 24)
    assert len(cache) == cfg.n_layers


def test_gemma2_prefill_past_the_window_matches_reference():
    """A 32-token prompt fills gemma2's 16-slot local rings from its last
    16 positions (the reference's S % Sc == 0 case), then decodes with
    per-slot positions."""
    cfg, cache = _decode_both("gemma2-9b", 32, 40, vector_pos=True)
    assert [c["k"].shape[1] for c in cache] == [16, 40, 16, 40]


def test_gemma2_int8_cache_decode_matches_reference():
    _decode_both("gemma2-9b", 12, 24, cache_dtype="int8")


def test_gemma2_cache_has_the_window_rings():
    cfg = get_smoke_config("gemma2-9b")
    cache = init_cache(cfg, 2, 64, device="cpu")
    assert [c["k"].shape for c in cache] == [
        (2, 16 if i % 2 == 0 else 64, cfg.kv_heads, cfg.head_dim)
        for i in range(cfg.n_layers)]


# -- the engine ---------------------------------------------------------------------


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


#: prompts of at most 16 tokens, gemma2's smoke window: past it the
#: reference keeps bucket padding in its rings (R4, ROADMAP §3); 14 new
#: tokens carry the longer ones past the window in decode
ENGINE_PROMPTS = [[5, 9, 2, 7], list(range(30, 46)), [1, 2, 3],
                  [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50]]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """Greedy tokens, events and the Δ trace against the JAX engine, in
    float32.  gemma2 is untied on both sides: with tied, scaled
    embeddings the random model repeats its last token, and its tokens
    would compare nothing."""
    over = {"tie_embeddings": False} if arch == "gemma2-9b" else {}
    cfg, jcfg, jparams, tparams = _models(arch, **over)
    want = _serve(jcfg, jparams, JServingEngine, JRequest, JAutoScaler,
                  ENGINE_PROMPTS, 14, 2)
    got = _serve(cfg, tparams, ServingEngine, Request, AutoScaler,
                 ENGINE_PROMPTS, 14, 2, device="cpu")
    assert got[0] == want[0]                      # greedy tokens
    assert got[1] == want[1]                      # events, ids, costs
    assert got[2] == want[2]                      # AutoScaler Δ trace
    assert any(len(set(o)) > 1 for o in got[0])   # not a repeated token


@pytest.mark.parametrize("prompt_len", [20, 40])
def test_gemma2_engine_past_the_window_matches_forward(prompt_len):
    """Prompts longer than the window (buckets 32 and 64), where the
    reference is not the yardstick (R4): the port's engine decodes what
    its own forward predicts, teacher-forced."""
    cfg, _, _, params = _models("gemma2-9b", tie_embeddings=False)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, size=prompt_len).tolist()
    engine = ServingEngine(cfg, params, max_batch=2, max_len=64,
                           device="cpu")
    req = engine.submit(Request(prompt=prompt, max_new_tokens=10))
    engine.run_until_drained()
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(10):
            logits, _ = forward(params, torch.tensor([toks]), cfg)
            toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
    assert req.output == toks[prompt_len:]


# -- weights and checkpoints ----------------------------------------------------------


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_the_port(arch):
    """bf16 weights with nonzero norms and biases come back bit for bit,
    in the reference's tree: untied ``lm_head``, ``bq``/``bk``/``bv``,
    ``ln1_post``/``ln2_post`` and gemma2's two stacked pattern
    positions."""
    cfg, jcfg = _cfgs(arch)
    tree = _nonzero(jax.tree.map(np.asarray,
                                 j_init(jax.random.PRNGKey(2), jcfg)), 3)
    model = params_from_jax(tree, cfg, device="cpu")
    back = params_to_jax(model, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, _bits(b))
    assert ("lm_head" in tree) == (not cfg.tie_embeddings)
    assert len(tree["blocks"]) == len(cfg.pattern)
    names = set(tree["blocks"][0])
    assert {"bq", "bk", "bv"} <= names if cfg.qkv_bias else \
        not names & {"bq", "bk", "bv"}
    assert {"ln1_post", "ln2_post"} <= names if cfg.post_norms else \
        not names & {"ln1_post", "ln2_post"}
    # one group of port parameters for each reference leaf
    groups = reference_leaves([n for n, _ in model.named_parameters()], cfg)
    assert len(groups) == len(jax.tree.leaves(tree))
    if arch == "gemma2-9b":
        assert ["layers.0.ln1_post", "layers.2.ln1_post"] in groups
        assert ["layers.1.ln1_post", "layers.3.ln1_post"] in groups


def test_gemma2_layers_take_their_pattern_positions():
    """Layer i of the port holds blocks[i % 2][..][i // 2]: the local
    layers (even) the first pattern position's weights."""
    cfg, jcfg, jparams, tparams = _models("gemma2-9b")
    for i, layer in enumerate(tparams.layers):
        want = np.array(jparams["blocks"][i % 2]["ln1_post"][i // 2])
        assert torch.equal(layer.ln1_post, torch.from_numpy(want))
        assert tparams.local(i) == (i % 2 == 0)


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


def test_init_params_gives_the_new_leaves():
    """The port's own init: qwen's biases and gemma2's post-norms start
    at zero, untied heads at N(0, 1/d), as the reference's."""
    for arch in ("qwen1.5-110b", "gemma2-9b", "deepseek-coder-33b"):
        cfg = get_smoke_config(arch)
        m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        names = {n for n, _ in m.named_parameters()}
        assert ("lm_head" in names) == (not cfg.tie_embeddings)
        assert ("layers.0.bq" in names) == cfg.qkv_bias
        assert ("layers.0.ln1_post" in names) == cfg.post_norms
        for n, p in m.named_parameters():
            if n.rpartition(".")[2] in ZERO_INIT:
                assert not p.any(), n
        if not cfg.tie_embeddings:
            assert m.lm_head.float().std().item() == pytest.approx(
                cfg.d_model ** -0.5, rel=0.1)
