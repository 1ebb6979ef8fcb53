"""The frontend prefix (internvl2-1b's patch embeddings, musicgen-medium's
frame embeddings) through the port's ``forward``, ``prefill`` +
``decode_step``, ``lm_loss``, the train step and the ``Trainer``,
against the reference, at smoke size on the CPU (``frontend_len`` 8).

Weights come from the reference's ``init_params`` through
:func:`repro_torch.convert.params_from_jax`, with nonzero norm weights
(the reference initialises them to zero); prefixes and tokens are made
with numpy from a seed.  float32 unless a test says otherwise.
Tolerances, as tests/test_torch_model.py and tests/test_torch_train.py
state them: logits 1e-4 in float32 and 2e-2 of their scale in bfloat16
or through the bfloat16 cache; the loss rtol 1e-6 and gradients 1e-5 of
each leaf's largest |g|; a train step's loss rtol 1e-6, grad norm 1e-5,
parameters 1e-6 at all but 0.1 % of the elements and nowhere more than
one AdamW step; the Trainer's losses rtol 1e-5 and grad norms 1e-4.
"""

import os
import subprocess
import sys
import threading
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import lm_loss as j_lm_loss
from repro.models import prefill as j_prefill
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.steps import StepConfig as JStepConfig
from repro.train.steps import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import named_from_tree, params_from_jax
from repro_torch.models import decode_step, forward, lm_loss, prefill
from repro_torch.models.layers import ZERO_INIT
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import StepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["internvl2-1b", "musicgen-medium"]
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _cfgs(arch, param_dtype="float32", **overrides):
    cfg = get_smoke_config(arch).replace(param_dtype=param_dtype,
                                         **overrides)
    jcfg = jax_smoke_config(arch).replace(param_dtype=param_dtype,
                                          **overrides)
    assert asdict(cfg) == asdict(jcfg)
    assert cfg.frontend_len == 8
    return cfg, jcfg


_TREES: dict = {}


def _tree(arch, param_dtype="float32"):
    """The reference's smoke weights as numpy, norms drawn nonzero."""
    if (arch, param_dtype) not in _TREES:
        _, jcfg = _cfgs(arch, param_dtype)
        tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
        rng = np.random.default_rng(1)
        _TREES[arch, param_dtype] = jax.tree_util.tree_map_with_path(
            lambda path, x: (rng.standard_normal(x.shape) * 0.1).astype(
                x.dtype) if path[-1].key in ZERO_INIT else x, tree)
    return _TREES[arch, param_dtype]


def _models(arch, param_dtype="float32", **overrides):
    cfg, jcfg = _cfgs(arch, param_dtype, **overrides)
    tree = _tree(arch, param_dtype)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, device="cpu"))


def _inputs(cfg, B, S_tok, seed=7, lead=()):
    """Tokens (lead + (B, S_tok)) and a prefix (lead + (B, F, d)) of
    N(0, 1) entries, large enough to move the logits visibly."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, lead + (B, S_tok)).astype(np.int32)
    prefix = rng.standard_normal(
        lead + (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return toks, prefix


def _labels(toks, F):
    """As SyntheticLM makes them: −1 over the prefix, the next token over
    the tokens, −1 at the end."""
    lab = np.concatenate([np.full(toks.shape[:-1] + (F,), -1, np.int32),
                          np.roll(toks, -1, axis=-1)], axis=-1)
    lab[..., -1] = -1
    return lab


def _close(t, j, tol: float):
    want = np.asarray(j, np.float32)
    scale = 1.0 if tol < 1e-3 else float(np.abs(want).max())
    np.testing.assert_allclose(t.detach().float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_prefix_matches_reference(arch, param_dtype):
    cfg, jcfg, jparams, tparams = _models(arch, param_dtype)
    toks, prefix = _inputs(cfg, 2, 12)
    lj, _ = j_forward(jparams, jnp.asarray(toks), jcfg,
                      prefix=jnp.asarray(prefix))
    lt, aux = forward(tparams, _t(toks, torch.long), cfg, prefix=_t(prefix))
    assert lt.shape == (2, cfg.frontend_len + 12, cfg.padded_vocab())
    assert float(aux) == 0.0
    _close(lt, lj, LOGIT_TOL[param_dtype])
    # the prefix reaches the logits: without it the tokens' logits differ
    bare, _ = forward(tparams, _t(toks, torch.long), cfg)
    assert (bare - lt[:, cfg.frontend_len:]).abs().max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_prefix_then_decode_matches_reference(arch):
    """Prefill the prefix and 6 tokens, decode 6 more from position
    F + 6: the logits against the reference's, and against the port's
    forward over the whole sequence (teacher-forced)."""
    cfg, jcfg, jparams, tparams = _models(arch)
    F, T, S = cfg.frontend_len, 6, 12
    toks, prefix = _inputs(cfg, 2, S)
    tt, tp = _t(toks, torch.long), _t(prefix)
    max_len = F + S
    full, _ = forward(tparams, tt, cfg, prefix=tp)
    lt, cache = prefill(tparams, tt[:, :T], cfg, max_len=max_len, prefix=tp)
    lj, jcache = j_prefill(jparams, jnp.asarray(toks[:, :T]), jcfg,
                           max_len=max_len, prefix=jnp.asarray(prefix))
    _close(lt, lj, LOGIT_TOL["float32"])
    torch.testing.assert_close(lt, full[:, F + T - 1], rtol=1e-4, atol=1e-4)
    all_t, _ = prefill(tparams, tt[:, :T], cfg, max_len=max_len, prefix=tp,
                       return_all_logits=True)
    assert all_t.shape[1] == F + T
    for t in range(T, S):
        pos = F + t
        step, cache = decode_step(tparams, tt[:, t], torch.tensor(pos),
                                  cache, cfg)
        jstep, jcache = j_decode(jparams, jnp.asarray(toks[:, t]),
                                 jnp.asarray(pos, jnp.int32), jcache, jcfg)
        _close(step, jstep, LOGIT_TOL["bfloat16"])      # bf16 cache
        _close(step, full[:, F + t].numpy(), LOGIT_TOL["bfloat16"])


def test_bucketed_prefill_with_prefix_counts_the_prefix():
    """``length`` counts tokens: a right-padded prompt after the prefix
    fills the cache as the exact-length one does (F + length positions),
    so decode goes on from position F + length alike."""
    cfg, _, _, tparams = _models("internvl2-1b")
    F, L = cfg.frontend_len, 5
    toks, prefix = _inputs(cfg, 1, 16)
    tt, tp = _t(toks, torch.long), _t(prefix)
    _, exact = prefill(tparams, tt[:, :L], cfg, max_len=32, prefix=tp)
    logits, padded = prefill(tparams, tt, cfg, max_len=32, prefix=tp,
                             length=L, return_all_logits=True)
    assert logits.shape[1] == F + 16
    for a, b in zip(exact, padded):
        torch.testing.assert_close(a["k"], b["k"], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(a["v"], b["v"], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="length"):
        prefill(tparams, tt, cfg, prefix=tp, length=0)
    with pytest.raises(ValueError, match="length"):
        prefill(tparams, tt, cfg, prefix=tp, length=17)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_prefix_and_grads_match_reference(arch):
    """The loss and the gradients of every parameter and of the prefix,
    against ``jax.value_and_grad`` of the reference's, remat "full"."""
    cfg, jcfg, jparams, tparams = _models(arch, remat="full")
    toks, prefix = _inputs(cfg, 2, 16)
    labels = _labels(toks, cfg.frontend_len)
    lj, (gj, gpj) = jax.value_and_grad(
        lambda p, x: j_lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                               jcfg, prefix=x), argnums=(0, 1))(
        jparams, jnp.asarray(prefix))
    tparams.requires_grad_(True)
    tp = _t(prefix).requires_grad_(True)
    lt = lm_loss(tparams, _t(toks, torch.long), _t(labels, torch.long), cfg,
                 prefix=tp)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    lt.backward()
    want = named_from_tree(jax.tree.map(np.asarray, gj), cfg)
    for name, p in tparams.named_parameters():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
    w = np.asarray(gpj)
    np.testing.assert_allclose(tp.grad.numpy(), w, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w).max()))


def _params_close(model, jparams, cfg) -> None:
    want = named_from_tree(jax.tree.map(np.asarray, jparams), cfg)
    for name, p in model.named_parameters():
        got = p.detach().float().numpy()
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(got, w, rtol=0, atol=3e-4, err_msg=name)
        assert np.mean(np.abs(got - w) > 1e-6) <= 1e-3, name


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_with_prefix_matches_reference(accum):
    """One internvl2-1b step (warmup 0) with a bfloat16 prefix, as the
    Trainer feeds it: microbatch a takes prefix[a]."""
    cfg, jcfg, jparams, model = _models("internvl2-1b")
    toks, prefix = _inputs(cfg, 2, 16, seed=4, lead=(accum,))
    prefix *= 0.02                  # as SyntheticLM draws it
    labels = _labels(toks, cfg.frontend_len)
    jstep = jax.jit(j_make_train_step(jcfg, None, JAdamWConfig(),
                                      JStepConfig(accum=accum, warmup=0)))
    tstep = make_train_step(cfg, AdamWConfig(),
                            StepConfig(accum=accum, warmup=0))
    jp, _, jm = jstep(jparams, j_adamw_init(jparams, JAdamWConfig()),
                      jnp.asarray(0, jnp.int32),
                      {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels),
                       "prefix": jnp.asarray(prefix, jnp.bfloat16)})
    model, _, tm = tstep(model, adamw_init(dict(model.named_parameters()),
                                           AdamWConfig()), 0,
                         {"tokens": _t(toks, torch.long),
                          "labels": _t(labels, torch.long),
                          "prefix": _t(prefix, torch.bfloat16)})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-5)
    _params_close(model, jp, cfg)


def _trainer_cfg(cls_t, cls_s, steps, seq_len=24):
    return cls_t(steps=steps, global_batch=4, seq_len=seq_len,
                 log_every=1000, step=cls_s(accum=2, warmup=2))


def test_trainer_with_prefix_matches_reference():
    """The port's Trainer from the reference Trainer's initial weights,
    on internvl2-1b with its SyntheticLM prefix (8 of 24 positions): 4
    steps give the same losses and grad norms."""
    cfg, jcfg = _cfgs("internvl2-1b")
    jtr = JTrainer(jcfg, _trainer_cfg(JTrainerConfig, JStepConfig, 4))
    init = jax.tree.map(np.asarray, jtr.params)
    jhist = jtr.run()
    jtr.close()
    tr = Trainer(cfg, _trainer_cfg(TrainerConfig, StepConfig, 4),
                 device="cpu")
    tr.params = params_from_jax(init, cfg, device="cpu")
    hist = tr.run()
    tr.close()
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               [h["grad_norm"] for h in jhist], rtol=1e-4)


@pytest.mark.parametrize("arch,seq_len", [
    ("internvl2-1b", 8), ("internvl2-1b", 4), ("musicgen-medium", 8)])
def test_trainer_refuses_a_seq_len_within_the_prefix(arch, seq_len):
    """R7: the data thread would die on a negative token count (and the
    first batch never come) or make every label −1; the Trainer refuses
    at construction, before it starts the thread."""
    threads = threading.active_count()
    with pytest.raises(ValueError, match="frontend prefix"):
        Trainer(get_smoke_config(arch),
                _trainer_cfg(TrainerConfig, StepConfig, 1, seq_len),
                device="cpu")
    assert threading.active_count() == threads


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_refuses_the_launchers_default_on_a_full_config(arch):
    """At the launcher's default seq_len 128, internvl2-1b (F = 256) and
    musicgen-medium (F = 128) are refused before any weight is made."""
    with pytest.raises(ValueError, match="seq_len 128"):
        Trainer(get_config(arch), TrainerConfig(), device="cpu")


def test_launcher_trains_with_a_prefix_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "internvl2-1b", "--smoke", "--steps", "2", "--device", "cpu"]
    out = subprocess.run(cmd + ["--seq-len", "24"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "over 2 steps" in out.stdout
    out = subprocess.run(cmd + ["--seq-len", "8"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and "frontend prefix" in out.stderr
