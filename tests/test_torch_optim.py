"""The port's optimizer, schedule, clipping and gradient compression
against the reference's (``repro.optim``, ``repro.train.compression``),
on the same numpy inputs on the CPU.

Tolerances.  Elementwise float32 math in the same order in both
frameworks: rtol 1e-6 (``pow``, ``sqrt``, ``cos`` may land an ulp apart;
sums over a leaf are taken in another order).  A bfloat16 store: one
bf16 ulp of the value (rtol 2⁻⁸), since an ulp-apart float32 value can
round to the neighbouring bf16.  Inputs keep clear of subnormals, which
XLA on the CPU flushes and PyTorch keeps (ROADMAP R1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_warmup as j_cosine
from repro.optim import global_norm as j_global_norm
from repro.train import compression as jcomp
from repro_torch.convert import tensor_from_numpy
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, clip_by_global_norm_,
                               cosine_warmup, global_norm)
from repro_torch.optim import adamw as tadamw
from repro_torch.train import compression as tcomp

F32 = dict(rtol=1e-6, atol=0)
BF16 = dict(rtol=2 ** -8, atol=0)


def _tree(seed: int, dtype: str = "float32", scale: float = 1.0) -> dict:
    """Three leaves of different shapes, normal × ``scale``, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 16), "b": (16,), "c": (3, 4, 5)}
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32)
           for k, s in shapes.items()}
    return {k: np.asarray(jnp.asarray(v).astype(dtype))
            for k, v in out.items()}


def _torch(tree: dict) -> dict:
    return {k: tensor_from_numpy(v) for k, v in tree.items()}


def _close(t: torch.Tensor, j, tol: dict) -> None:
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_cosine_warmup_matches_reference(step):
    got = cosine_warmup(step, warmup=10, total=100)
    want = j_cosine(step, warmup=10, total=100)
    assert got.dtype == torch.float32
    _close(got, want, F32)


def test_cosine_warmup_step_zero_is_zero():
    """With warmup > 0 the first step does not move the parameters."""
    assert float(cosine_warmup(0, warmup=2)) == 0.0
    assert float(cosine_warmup(0, warmup=0)) == 1.0


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0),
                                            (3.0, 0.5), (1.0, 100.0)])
def test_clip_matches_reference(scale, max_norm):
    tree = _tree(1, scale=scale)
    got, norm = clip_by_global_norm(_torch(tree), max_norm)
    want, jnorm = j_clip({k: jnp.asarray(v) for k, v in tree.items()},
                         max_norm)
    _close(norm, jnorm, F32)
    _close(global_norm(_torch(tree)), j_global_norm(tree), F32)
    for k in tree:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k], F32)


def test_clip_keeps_each_leafs_dtype():
    """The norm and the scaling are float32; each leaf goes back to its
    own dtype (bf16 held to one bf16 ulp)."""
    tree = {**_tree(2, "bfloat16", 3.0), "f": _tree(3)["a"]}
    got, norm = clip_by_global_norm(_torch(tree), 1.0)
    want, jnorm = j_clip({k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    _close(norm, jnorm, F32)
    assert got["a"].dtype == torch.bfloat16
    assert got["f"].dtype == torch.float32
    for k in tree:
        _close(got[k], want[k], BF16 if k != "f" else F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_in_place_is_the_clip(dtype):
    """The train step's in-place clip: the functional clip's values and
    norm exactly, written into the leaves it was given."""
    tree = {**_tree(4, dtype, 3.0), "f": _tree(5)["a"]}
    want, want_norm = clip_by_global_norm(_torch(tree), 1.0)
    got = _torch(tree)
    leaves = dict(got)
    norm = clip_by_global_norm_(got, 1.0)
    assert torch.equal(norm, want_norm)
    for k in tree:
        assert got[k] is leaves[k]
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16")])
def test_adamw_in_slices_is_the_whole_leaf_update(param_dtype, state_dtype,
                                                  monkeypatch):
    """Leaves updated in slices of 7 elements along their first
    dimension (a transposed, non-contiguous gradient and a 0-d leaf
    among them) equal the same update of whole leaves bit for bit."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, state_dtype=state_dtype)
    params = {**_tree(6, param_dtype), "d": np.float32(0.5)}
    params["d"] = np.asarray(jnp.asarray(params["d"]).astype(param_dtype))
    grads = {**_tree(7), "d": np.float32(-0.25)}

    def update():
        tp = _torch(params)
        ts = adamw_init(tp, cfg)
        tg = {k: torch.tensor(v) for k, v in grads.items()}
        tg["a"] = tg["a"].T.contiguous().T
        assert not tg["a"].is_contiguous()
        for lr_scale in (1.0, 0.5):
            tp, ts = adamw_update(tg, ts, tp, cfg, torch.tensor(lr_scale))
        return tp, ts
    whole = update()
    monkeypatch.setattr(tadamw, "_SLICE", 7)
    sliced = update()
    for k in params:
        assert torch.equal(sliced[0][k], whole[0][k])
        assert torch.equal(sliced[1]["mu"][k], whole[1]["mu"][k])
        assert torch.equal(sliced[1]["nu"][k], whole[1]["nu"][k])


@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_adamw_matches_reference(param_dtype, state_dtype):
    """Three updates (counts 1–3) with weight decay and a learning-rate
    scale: params, mu, nu and count against the reference's."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, state_dtype=state_dtype)
    jcfg = JAdamWConfig(lr=1e-2, weight_decay=0.1, state_dtype=state_dtype)
    params = _tree(0, param_dtype)
    tp = _torch(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = adamw_init(tp, cfg), j_adamw_init(jp, jcfg)
    tol = F32 if (param_dtype, state_dtype) == ("float32", "float32") \
        else BF16
    for count, lr_scale in ((1, 1.0), (2, 0.5), (3, 0.25)):
        grads = _tree(10 + count)
        tp, ts = adamw_update(_torch(grads), ts, tp, cfg,
                              torch.tensor(lr_scale))
        jp, js = j_adamw_update({k: jnp.asarray(v)
                                 for k, v in grads.items()}, js, jp, jcfg,
                                lr_scale)
        assert int(ts["count"]) == int(js["count"]) == count
        assert ts["count"].dtype == torch.int32
        for k in params:
            assert tp[k].dtype == tensor_from_numpy(params[k]).dtype
            assert ts["mu"][k].dtype == tensor_from_numpy(
                np.asarray(js["mu"][k])).dtype
            # an update moves a parameter by ~lr; compare at that scale
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=tol["rtol"], atol=1e-6)
            _close(ts["mu"][k], js["mu"][k], tol)
            _close(ts["nu"][k], js["nu"][k], tol)


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state = adamw_update({"x": 2 * params["x"]}, state,
                                     params, cfg)
    assert float((params["x"] ** 2).sum()) < 1e-4


def test_quantize_matches_reference():
    """int8 values and the scale; round half to even like ``jnp.round``
    (the 0.5 and 2.5 quanta are exact ties here)."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0, -127.0],
                 np.float32) * 0.25
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js, F32)
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 3, -127]


def test_quantize_roundtrip_error_bound():
    x = tensor_from_numpy(_tree(4, scale=3.0)["a"])
    q, s = tcomp.quantize_int8(x)
    err = (tcomp.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_quantize_floors_the_scale():
    q, s = tcomp.quantize_int8(torch.zeros(5))
    assert float(s) == pytest.approx(1e-12) and not q.any()


def test_compress_grads_matches_reference():
    """Two steps of compression with error feedback: the dequantized
    grads and the residuals carried to the next step."""
    grads = _tree(5, scale=0.01)
    tef = tcomp.init_error_feedback(_torch(grads))
    jef = jcomp.init_error_feedback({k: jnp.asarray(v)
                                     for k, v in grads.items()})
    for step in range(2):
        g = _tree(5 + step, scale=0.01)
        tg, tef = tcomp.compress_grads(_torch(g), tef)
        jg, jef = jcomp.compress_grads({k: jnp.asarray(v)
                                        for k, v in g.items()}, jef)
        for k in g:
            _close(tg[k], jg[k], F32)
            np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]),
                                       rtol=1e-6, atol=1e-9)


def test_compress_groups_share_one_scale():
    """A group is quantized as the reference quantizes the stacked leaf
    that holds its tensors (one scale over all of them)."""
    g = _tree(6, scale=0.01)
    stacked = np.stack([g["a"], g["a"][::-1] * 3])
    tg = {"x": torch.from_numpy(stacked[0].copy()),
          "y": torch.from_numpy(stacked[1].copy())}
    ef = tcomp.init_error_feedback(tg)
    got, new_ef = tcomp.compress_grads(tg, ef, [["x", "y"]])
    want, jef = jcomp.compress_grads(
        {"s": jnp.asarray(stacked)}, {"s": jnp.zeros(stacked.shape)})
    for i, k in enumerate(("x", "y")):
        _close(got[k], np.asarray(want["s"])[i], F32)
        np.testing.assert_allclose(new_ef[k].numpy(),
                                   np.asarray(jef["s"])[i], rtol=1e-6,
                                   atol=1e-9)


def test_error_feedback_accumulates_residual():
    g = {"w": torch.full((16,), 0.001)}
    ef = tcomp.init_error_feedback(g)
    total = torch.zeros(16)
    for _ in range(50):
        deq, ef = tcomp.compress_grads(g, ef)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy() / 50, 0.001, rtol=0.05)
