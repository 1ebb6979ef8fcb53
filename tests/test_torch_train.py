"""The port's train path against the reference's, at smoke size on the
CPU: ``lm_loss`` and its gradients, one train step, the ``Trainer`` and
the launcher.  (The kernels' gradients are in tests/test_torch_kernels.py,
which the machine with the card, having no JAX, can import.)

Weights come from the reference's ``init_params`` through
:func:`repro_torch.convert.params_from_jax`; inputs are made with numpy
from a seed.  float32 unless a test says otherwise.  Tolerances:

* the loss: rtol 1e-6 — the same float32 math, sums in another order;
* gradients: 1e-5 of each leaf's largest |g|, rtol 1e-5 — the backward
  sums over B·S tokens in another order;
* parameters after an AdamW step: 1e-6 at all but 0.1 % of the
  elements, and nowhere more than one step (the lr, 3e-4).  AdamW moves
  each element by lr·m̂/(√v̂ + ε), which is ±lr at the first step unless
  |g| is near ε = 1e-8; there the frameworks' ~1e-10 summation noise in
  g is a visible share of ε, and a handful of elements land up to a
  tenth of a step apart.
* with int8 compression, an element whose scaled gradient lies within
  rounding noise of a half-integer quantizes to the neighbouring int8:
  the error feedback (and mu) then differ by one quantum there, at well
  under 0.1 % of the elements.
"""

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

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as j_init
from repro.models import lm_loss as j_lm_loss
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.compression import init_error_feedback as j_init_ef
from repro.train.steps import StepConfig as JStepConfig
from repro.train.steps import make_serve_step as j_make_serve_step
from repro.train.steps import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (named_from_tree, params_from_jax,
                                 params_to_jax)
from repro_torch.models import init_cache, lm_loss, prefill
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.compression import init_error_feedback
from repro_torch.train.steps import (StepConfig, make_serve_step,
                                     make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3.2-1b"


def _cfgs(param_dtype="float32", **overrides):
    cfg = get_smoke_config(ARCH).replace(param_dtype=param_dtype,
                                         **overrides)
    jcfg = jax_smoke_config(ARCH).replace(param_dtype=param_dtype,
                                          **overrides)
    assert asdict(cfg) == asdict(jcfg)
    return cfg, jcfg


@pytest.fixture(scope="module")
def weights():
    """The reference's float32 smoke weights, as JAX arrays and numpy."""
    _, jcfg = _cfgs()
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _batch(cfg, A, B, S, seed):
    """Tokens and next-token labels (A, B, S); the last label and a few
    more are masked (< 0)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (A, B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., -1] = -1
    labels[..., :3] = -1
    return toks, labels


def _leaf_close(got: torch.Tensor, want: np.ndarray, rel: float) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _params_close(model, jparams, cfg) -> None:
    want = named_from_tree(jax.tree.map(np.asarray, jparams), cfg)
    for name, p in model.named_parameters():
        got = p.detach().float().numpy()
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(got, w, rtol=0, atol=3e-4,
                                   err_msg=name)
        assert np.mean(np.abs(got - w) > 1e-6) <= 1e-3, name


# -- lm_loss ---------------------------------------------------------------------


@pytest.mark.parametrize("remat,ce_seq_chunk", [
    ("none", 0), ("full", 0), ("none", 8), ("full", 8)])
def test_lm_loss_and_grads_match_reference(weights, remat, ce_seq_chunk):
    """``lm_loss`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's, with masked labels, the
    CE whole or in sequence chunks, without and with per-layer remat."""
    cfg, jcfg = _cfgs(remat=remat, ce_seq_chunk=ce_seq_chunk)
    jparams, tree = weights
    toks, labels = _batch(cfg, 1, 2, 32, seed=0)
    lj, gj = jax.value_and_grad(j_lm_loss)(
        jparams, jnp.asarray(toks[0]), jnp.asarray(labels[0]), jcfg)
    model = params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    lt = lm_loss(model, torch.from_numpy(toks[0]).long(),
                 torch.from_numpy(labels[0]).long(), cfg)
    assert lt.dtype == torch.float32 and lt.shape == ()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    lt.backward()
    want = named_from_tree(jax.tree.map(np.asarray, gj), cfg)
    for name, p in model.named_parameters():
        _leaf_close(p.grad, want[name], 1e-5)


def test_every_parameter_gets_a_gradient(weights):
    cfg, _ = _cfgs(remat="full")
    model = params_from_jax(weights[1], cfg, device="cpu")
    model.requires_grad_(True)
    toks, labels = _batch(cfg, 1, 2, 16, seed=1)
    lm_loss(model, torch.from_numpy(toks[0]).long(),
            torch.from_numpy(labels[0]).long(), cfg).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


def test_fully_masked_labels_give_zero_loss(weights):
    """The count is floored at 1, as in the reference."""
    cfg, _ = _cfgs()
    model = params_from_jax(weights[1], cfg, device="cpu")
    toks, _ = _batch(cfg, 1, 2, 8, seed=2)
    loss = lm_loss(model, torch.from_numpy(toks[0]).long(),
                   torch.full((2, 8), -1), cfg)
    assert loss.item() == 0.0


# -- the train step ----------------------------------------------------------------


@pytest.mark.parametrize("accum,compress", [(1, False), (2, False),
                                            (1, True), (2, True)])
def test_train_step_matches_reference(weights, accum, compress):
    """One step (warmup 0, so the learning rate is not 0): loss,
    grad_norm, lr_scale, params, mu, nu, count and the error feedback."""
    cfg, jcfg = _cfgs()
    jparams = jax.tree.map(jnp.asarray, weights[1])
    model = params_from_jax(weights[1], cfg, device="cpu")
    js = j_adamw_init(jparams, JAdamWConfig())
    named = dict(model.named_parameters())
    ts = adamw_init(named, AdamWConfig())
    if compress:
        js["ef"] = j_init_ef(jparams)
        ts["ef"] = init_error_feedback(named)
    jstep = jax.jit(j_make_train_step(
        jcfg, None, JAdamWConfig(),
        JStepConfig(accum=accum, warmup=0, compress=compress)))
    tstep = make_train_step(cfg, AdamWConfig(),
                            StepConfig(accum=accum, warmup=0,
                                       compress=compress))
    toks, labels = _batch(cfg, accum, 2, 16, seed=4)
    jp, js, jm = jstep(jparams, js, jnp.asarray(0, jnp.int32),
                       {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    model, ts, tm = tstep(model, ts, 0,
                          {"tokens": torch.from_numpy(toks).long(),
                           "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert tm["lr_scale"].item() == float(jm["lr_scale"]) == 1.0
    assert int(ts["count"]) == int(js["count"]) == 1
    assert set(ts) == set(js)
    _params_close(model, jp, cfg)
    for key in ("mu", "nu") + (("ef",) if compress else ()):
        want = named_from_tree(jax.tree.map(np.asarray, js[key]), cfg)
        for name, got in ts[key].items():
            w = np.asarray(want[name], np.float32)
            # the residual g − deq keeps g's absolute noise (1e-5 of
            # max |g|, about 1e-3 of a quantum, which is 2·max |ef|)
            atol = 2e-3 * float(np.abs(w).max()) if key == "ef" \
                else 1e-5 * float(np.abs(w).max())
            close = np.isclose(got.numpy(), w, rtol=1e-5, atol=atol)
            if compress:
                assert close.mean() >= 1 - 1e-3, (key, name, close.mean())
            else:
                assert close.all(), (key, name)


def test_train_step_leaves_no_grad_on_the_parameters(weights):
    """Gradients are taken with ``autograd.grad`` and accumulated in
    float32, never into the parameters' ``.grad``."""
    cfg, _ = _cfgs("bfloat16")
    model = params_from_jax(
        jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                     weights[1]), cfg, device="cpu")
    state = adamw_init(dict(model.named_parameters()), AdamWConfig())
    step = make_train_step(cfg, AdamWConfig(), StepConfig(accum=2,
                                                          warmup=0))
    toks, labels = _batch(cfg, 2, 2, 16, seed=5)
    model, state, m = step(model, state, 0,
                           {"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels).long()})
    assert all(p.grad is None for p in model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in state["mu"].values())
    assert np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0


def test_serve_step_matches_reference(weights):
    """Greedy decode tokens with a padded vocabulary (200 → 256): the
    padded logits are masked before the argmax."""
    cfg, jcfg = _cfgs(vocab=200)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    assert cfg.padded_vocab() == 256
    toks, _ = _batch(cfg, 1, 2, 8, seed=6)
    from repro.models import prefill as j_prefill
    _, jcache = j_prefill(jparams, jnp.asarray(toks[0]), jcfg, max_len=16)
    _, cache = prefill(model, torch.from_numpy(toks[0]).long(), cfg,
                       max_len=16)
    jstep, tstep = j_make_serve_step(jcfg, None), make_serve_step(cfg)
    jt = jnp.asarray(toks[0, :, -1])
    tt = torch.from_numpy(toks[0, :, -1]).long()
    for pos in range(8, 12):
        jt, jcache = jstep(jparams, jt, jnp.asarray(pos, jnp.int32), jcache)
        tt, cache = tstep(model, tt, torch.tensor(pos), cache)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert all(0 <= x < cfg.vocab for x in tt.tolist())
    assert len(init_cache(cfg, 2, 16, device="cpu")) == cfg.n_layers


# -- the Trainer and the launcher ----------------------------------------------------


def _trainer_cfg(cls_t, cls_s, steps, **kw):
    return cls_t(steps=steps, global_batch=4, seq_len=32,
                 checkpoint_every=5, log_every=1000,
                 step=cls_s(accum=2, warmup=2), **kw)


@pytest.fixture(scope="module")
def jax_history():
    """The reference Trainer, 6 float32 smoke steps; and its initial
    weights (taken before the jitted step donates them)."""
    _, jcfg = _cfgs()
    tr = JTrainer(jcfg, _trainer_cfg(JTrainerConfig, JStepConfig, 6))
    init = jax.tree.map(np.asarray, tr.params)
    hist = tr.run()
    tr.close()
    return init, hist, jax.tree.map(np.asarray, tr.params)


def test_trainer_history_matches_reference(jax_history):
    """The port's Trainer from the reference Trainer's initial weights:
    6 steps (accum 2, warmup 2) give the same losses and grad norms, and
    the same weights (read back through ``params_to_jax``)."""
    init, jhist, jfinal = jax_history
    cfg, _ = _cfgs()
    tr = Trainer(cfg, _trainer_cfg(TrainerConfig, StepConfig, 6),
                 device="cpu")
    tr.params = params_from_jax(init, cfg, device="cpu")
    hist = tr.run()
    tr.close()
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    assert set(hist[0]) == set(jhist[0])
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               [h["grad_norm"] for h in jhist], rtol=1e-4)
    got = params_to_jax(tr.params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(jfinal)
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got),
                                   jax.tree.leaves(jfinal))):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-4, err_msg=str(i))
        assert np.mean(np.abs(g - w) > 1e-6) <= 1e-3, i


def test_params_to_jax_inverts_params_from_jax():
    """bf16 weights come back bit for bit, in the reference's tree."""
    cfg, jcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(1), jcfg))
    back = params_to_jax(params_from_jax(tree, cfg, device="cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.uint16 and str(b.dtype) == "bfloat16"
        np.testing.assert_array_equal(a, b.view(np.uint16))


def test_loss_decreases():
    """As tests/test_train.py: the bf16 smoke model, 15 steps."""
    cfg = get_smoke_config(ARCH)
    tr = Trainer(cfg, _trainer_cfg(TrainerConfig, StepConfig, 15),
                 device="cpu")
    hist = tr.run()
    tr.close()
    assert np.mean([h["loss"] for h in hist[-3:]]) \
        < np.mean([h["loss"] for h in hist[:3]])


def test_compression_trainer_runs():
    cfg = get_smoke_config(ARCH)
    tr = Trainer(cfg, _trainer_cfg(TrainerConfig, StepConfig, 6,
                                   compress=True), device="cpu")
    hist = tr.run()
    tr.close()
    assert "ef" in tr.opt_state
    assert hist[-1]["loss"] < hist[0]["loss"] * 1.2


def test_trainer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_smoke_config(ARCH), TrainerConfig(steps=1))


def test_launcher_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "3", "--device", "cpu", "--checkpoint-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "over 3 steps" in out.stdout
    assert not list(tmp_path.glob("step_*"))   # checkpoint_every is 50
