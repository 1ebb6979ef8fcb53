"""``remat="dots"`` in the port's ``lm_loss``, at smoke size on the CPU.

The reference's ``_remat`` checkpoints each pattern unit with
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` under
``"dots"``, and treats every value other than ``"none"`` and ``"dots"``
as ``"full"``.  The port checkpoints the unit with a selective policy
that saves the results of ``aten.mm`` and ``aten.addmm`` and recomputes
the rest.  Held here: the loss and every gradient against
``jax.value_and_grad`` of the reference's, on a dense and on the two MoE
configs, at ``tests/test_torch_train.py``'s tolerances (loss rtol 1e-6;
gradients 1e-5 of each leaf's largest |g|, rtol 1e-5); remat changes no
value in float32; ``"dots"`` keeps more for the backward pass than
``"full"`` and less than ``"none"``; and any other value trains as
``"full"``.  Weights come from the reference's init through
:func:`repro_torch.convert.params_from_jax`; inputs from numpy with a
seed.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as j_init
from repro.models import lm_loss as j_lm_loss
from repro_torch.configs import get_smoke_config
from repro_torch.convert import named_from_tree, params_from_jax
from repro_torch.launch.roofline import StepMeter
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import StepConfig, make_train_step

ARCHS = ["llama3.2-1b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
         "recurrentgemma-2b", "rwkv6-7b"]
MODES = ["none", "full", "dots"]


def _cfgs(arch, **overrides):
    cfg = get_smoke_config(arch).replace(param_dtype="float32", **overrides)
    jcfg = jax_smoke_config(arch).replace(param_dtype="float32",
                                          **overrides)
    assert asdict(cfg) == asdict(jcfg)
    return cfg, jcfg


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., -1] = -1
    labels[..., :3] = -1
    return toks, labels


@pytest.mark.parametrize("arch,chunks", [
    ("llama3.2-1b", {"ce_seq_chunk": 0}),
    ("llama3.2-1b", {"ce_seq_chunk": 8}),
    ("mixtral-8x22b", {"moe_seq_chunk": 0}),
    ("mixtral-8x22b", {"moe_seq_chunk": 16}),
    ("llama4-maverick-400b-a17b", {"moe_seq_chunk": 16}),
])
def test_dots_loss_and_grads_match_reference(arch, chunks):
    """``lm_loss`` under ``"dots"`` and every parameter's gradient
    against the reference's under ``"dots"``: a dense config with the CE
    whole and in chunks, and the MoE configs with the experts whole and
    in checkpointed chunks inside the unit's checkpoint."""
    cfg, jcfg = _cfgs(arch, remat="dots", **chunks)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    toks, labels = _batch(cfg, 2, 32, seed=0)
    lj, gj = jax.value_and_grad(j_lm_loss)(
        jparams, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu").requires_grad_(True)
    lt = lm_loss(model, torch.from_numpy(toks).long(),
                 torch.from_numpy(labels).long(), cfg)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    lt.backward()
    want = named_from_tree(jax.tree.map(np.asarray, gj), cfg)
    for name, p in model.named_parameters():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def _loss_and_grads(arch, remat, seed=0):
    """The port's loss and gradients under ``remat``, from the port's
    float32 init and a seeded batch, and what the forward pass left
    alive for the backward (storages, bytes)."""
    cfg = get_smoke_config(arch).replace(param_dtype="float32",
                                         remat=remat)
    model = init_params(cfg, device="cpu", seed=seed).requires_grad_(True)
    toks, labels = (torch.from_numpy(x).long()
                    for x in _batch(cfg, 2, 16, seed))
    meter = StepMeter(list(model.parameters()) + [toks, labels])
    with meter:
        loss = lm_loss(model, toks, labels, cfg)
    kept = (meter.storages, meter.live - meter.argument_bytes)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, grads, kept


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    """In float32 ``"dots"`` gives the loss and gradients of ``"none"``
    and ``"full"`` exactly: the same operations on the same values,
    saved or recomputed."""
    base, base_g, _ = _loss_and_grads(arch, "none")
    for remat in ("full", "dots"):
        loss, grads, _ = _loss_and_grads(arch, remat)
        assert torch.equal(loss, base), remat
        for g, w in zip(grads, base_g):
            assert torch.equal(g, w), remat


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_less_than_none_and_more_than_full(arch):
    """After the forward pass, ``"dots"`` holds more tensors (and bytes)
    for the backward pass than ``"full"`` — the products it saved — and
    fewer than ``"none"``, which keeps every activation."""
    kept = {remat: _loss_and_grads(arch, remat)[2] for remat in MODES}
    for i in range(2):
        assert kept["full"][i] < kept["dots"][i] < kept["none"][i], kept


@pytest.mark.parametrize("remat", ["weird", "FULL", ""])
def test_any_other_value_trains_as_full(remat):
    """As the reference's ``_remat``: a value other than ``"none"`` and
    ``"dots"`` is ``"full"`` — the same loss, gradients and kept
    tensors, and one train step gives the same parameters bit for
    bit."""
    arch = "llama3.2-1b"
    loss, grads, kept = _loss_and_grads(arch, remat)
    want, want_g, want_kept = _loss_and_grads(arch, "full")
    assert torch.equal(loss, want) and kept == want_kept
    assert all(torch.equal(g, w) for g, w in zip(grads, want_g))

    cfg = get_smoke_config(arch).replace(param_dtype="float32")
    toks, labels = (torch.from_numpy(x).long()[None]
                    for x in _batch(cfg, 2, 16, seed=1))
    stepped = []
    for value in (remat, "full"):
        c = cfg.replace(remat=value)
        model = init_params(c, device="cpu", seed=0)
        state = adamw_init(dict(model.named_parameters()), AdamWConfig())
        step = make_train_step(c, AdamWConfig(), StepConfig(warmup=0))
        model, _, m = step(model, state, 0,
                           {"tokens": toks, "labels": labels})
        stepped.append((float(m["loss"]), list(model.parameters())))
    (l_a, p_a), (l_b, p_b) = stepped
    assert l_a == l_b
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
