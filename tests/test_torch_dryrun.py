"""The port's one-card dry-run against the reference's tooling, on the
CPU: the shape table and its helpers, ``param_count`` and
``model_flops`` for every cell, the partition specs, the bytes of the
meta builds against ``jax.eval_shape``, the FLOPs counted on meta
against the same step run on the CPU, and the kernel backwards' stand-in
on meta against the backwards themselves.  The full-width ``--all``
belongs to ``chip_smoke.py`` (phase 22); one full-width cell runs here.
"""

from dataclasses import asdict
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.cells as ref_cells
import repro.launch.mesh as ref_mesh
import repro.launch.roofline as ref_roofline
import repro.models as ref_models
import repro.optim as ref_optim
import repro_torch.configs as port_configs
import repro_torch.launch.cells as port_cells
import repro_torch.launch.mesh as port_mesh
import repro_torch.launch.roofline as port_roofline
import repro_torch.models as port_models
import repro_torch.optim as port_optim
from repro_torch.configs import SHAPES, ShapeSpec, all_cells
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.cells import SkipCell, TrainKnobs, build_cell
from repro_torch.launch.roofline import StepMeter, count_step, model_flops
from repro_torch.models import Rules, cache_specs, init_cache, param_specs
from repro_torch.models.transformer import Transformer

ARCHS = list(port_configs.ARCH_IDS)
KINDS = ["train", "prefill", "decode"]
#: the reference's public names with no counterpart in the port, by design
NO_COUNTERPART = {
    "launch.mesh": {"make_production_mesh"},
    "launch.roofline": {"HloAnalysis", "analyze_hlo"},
}


# -- the tables ---------------------------------------------------------------


def test_shapes_and_cells_are_the_references():
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: asdict(v) for k, v in port_configs.SHAPES.items()} == \
        {k: asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert port_configs.all_cells() == ref_configs.all_cells()
    assert len(all_cells()) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_runnable_is_the_references(arch):
    for name, shape in SHAPES.items():
        got = port_configs.cell_runnable(port_configs.get_config(arch),
                                         shape)
        want = ref_configs.cell_runnable(ref_configs.get_config(arch),
                                         ref_configs.SHAPES[name])
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch,shape", all_cells())
def test_param_count_and_model_flops_are_the_references(arch, shape):
    cfg, jcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    kind = SHAPES[shape].kind
    assert model_flops(cfg, SHAPES[shape], kind) == \
        ref_roofline.model_flops(jcfg, ref_configs.SHAPES[shape], kind)


@pytest.mark.parametrize("pkg", ["models", "optim", "configs",
                                 "launch.mesh", "launch.cells",
                                 "launch.roofline"])
def test_public_names_match_the_references(pkg):
    """Every public name of the reference's package has its counterpart,
    save those that have none by design (ROADMAP §1)."""
    refs = {"models": ref_models, "optim": ref_optim,
            "configs": ref_configs, "launch.mesh": ref_mesh,
            "launch.cells": ref_cells, "launch.roofline": ref_roofline}
    ports = {"models": port_models, "optim": port_optim,
             "configs": port_configs, "launch.mesh": port_mesh,
             "launch.cells": port_cells, "launch.roofline": port_roofline}
    missing = set(refs[pkg].__all__) - set(ports[pkg].__all__)
    assert missing == NO_COUNTERPART.get(pkg, set())
    for name in ports[pkg].__all__:
        assert hasattr(ports[pkg], name), name
    if pkg == "configs":
        assert ports[pkg].__all__ == refs[pkg].__all__


def test_dryrun_has_the_references_entry_points():
    import repro.launch.dryrun as ref_dryrun

    for name in ("run_cell", "main"):
        assert callable(getattr(ref_dryrun, name))
        assert callable(getattr(dryrun, name))


# -- the partition specs ------------------------------------------------------


def _axes(spec) -> tuple:
    """A spec as a tuple of axis entries; a one-name tuple is that name
    (``PartitionSpec`` keeps it so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_leaf(tree, name: str, cfg):
    """The reference tree's leaf for the port's name ``layers.<i>.<path>``
    (or a top-level one), and whether it is stacked over units."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[name], False
    i, path = int(parts[1]), parts[2:]
    P, base = len(cfg.pattern), cfg.n_units * len(cfg.pattern)
    node, stacked = (tree["blocks"][i % P], True) if i < base \
        else (tree["rest"][i - base], False)
    for key in path:
        node = node[key]
    return node, stacked


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_are_the_references(arch, tp):
    cfg, jcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    want = ref_models.param_specs(jcfg, ref_models.Rules(), tp)
    got = param_specs(cfg, Rules(), tp)
    names = [n for n, _ in Transformer(cfg, device="meta").named_parameters()]
    assert list(got) == names
    for name, spec in got.items():
        w, stacked = _ref_leaf(want, name, cfg)
        w = _axes(w)
        assert _axes(spec) == (w[1:] if stacked else w), name
    opt = port_optim.opt_state_specs(got)
    ref_opt = ref_optim.opt_state_specs(want)
    assert _axes(opt["count"]) == _axes(ref_opt["count"]) == ()
    assert opt["mu"] is got and opt["nu"] is got


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch):
    """Each cache leaf's spec is the reference's rule applied to the leaf
    of one layer (the reference stacks a pattern position's layers on a
    leading axis, and its rule, blind to that, puts the batch there)."""
    cfg, jcfg = port_configs.get_config(arch), ref_configs.get_config(arch)
    B, S = 4, 64
    shapes = jax.eval_shape(partial(ref_models.init_cache, jcfg, B, S))

    def unstack(tree):
        return jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), tree)
    per_layer = {"blocks": tuple(unstack(b) for b in shapes["blocks"]),
                 "rest": shapes["rest"]}
    want = ref_models.cache_specs(per_layer, ref_models.Rules())
    cache = init_cache(cfg, B, S, device="meta")
    got = cache_specs(cache, Rules())
    for i, layer in enumerate(got):
        for key, spec in layer.items():
            w, _ = _ref_leaf(want, f"layers.{i}.{key}", cfg)
            assert _axes(spec) == _axes(w), (i, key)
            assert len(spec) == cache[i][key].dim()


def test_rules_and_mesh_are_the_references():
    for axes in (("data", "model"), ("pod", "data", "model")):
        got = port_mesh.rules_for_mesh(axes)
        want = ref_mesh.rules_for_mesh(SimpleNamespace(axis_names=axes))
        assert (got.batch, got.fsdp, got.tp) == \
            (want.batch, want.fsdp, want.tp)
        for role in ("hidden", "hidden_tp", "heads", "kv", "logits",
                     "expert_tokens", "rnn", "wkv_heads", "wkv_state",
                     "cache"):
            assert _axes(got.spec(role)) == _axes(want.spec(role)), role
    x = torch.ones(2, 3)
    assert Rules().constrain(x, "hidden") is x
    with pytest.raises(KeyError):
        Rules().constrain(x, "no such role")
    assert port_mesh.HW.PEAK_FLOPS == 989e12
    assert port_mesh.HW.HBM_BW == 3.35e12


def test_steps_take_rules_as_a_keyword():
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import (StepConfig, make_serve_step,
                                         make_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = port_configs.get_smoke_config("llama3.2-1b")
    make_train_step(cfg, AdamWConfig(), StepConfig(), rules=Rules())
    make_serve_step(cfg, rules=Rules())
    trainer = Trainer(cfg, TrainerConfig(steps=1, global_batch=2,
                                         seq_len=16), "cpu", rules=Rules())
    trainer.close()


# -- bytes on meta against jax.eval_shape ------------------------------------------


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _small_shape(arch: str, kind: str) -> ShapeSpec:
    return ShapeSpec(f"small_{kind}", 32, 4, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_bytes_are_the_references(arch, kind):
    """The parameter bytes (and the optimizer state's, and the cache's)
    of a smoke cell built on meta equal the reference's ``jax.eval_shape``
    bytes for the same config; nothing is allocated."""
    shape = _small_shape(arch, kind)
    knobs = TrainKnobs(accum=2, ce_seq_chunk=16)
    cell = build_cell(arch, shape, knobs=knobs, smoke=True)
    groups = cell.argument_tensors()
    assert all(t.device.type == "meta" for ts in groups.values() for t in ts)
    jcfg = ref_configs.get_smoke_config(arch)
    if kind == "train":
        jcfg = jcfg.replace(ce_seq_chunk=16)
    p = jax.eval_shape(partial(ref_models.init_params, cfg=jcfg),
                       jax.random.PRNGKey(0))
    nbytes = {k: sum(t.numel() * t.element_size() for t in ts)
              for k, ts in groups.items()}
    assert nbytes["params"] == _jax_bytes(p)
    if kind == "train":
        o = jax.eval_shape(partial(ref_optim.adamw_init,
                                   cfg=ref_optim.AdamWConfig()), p)
        assert nbytes["opt"] == _jax_bytes(o)
    if kind == "decode":
        c = jax.eval_shape(partial(ref_models.init_cache, jcfg,
                                   shape.global_batch, shape.seq_len))
        assert nbytes["cache"] == _jax_bytes(c)


# -- FLOPs and peaks on meta against the CPU ------------------------------------------


@pytest.fixture
def ref_spy(monkeypatch):
    """Records every call of a plain version in ``kernels/ref.py``, and
    still makes it."""
    called = []
    for name in ref.__all__:
        fn = getattr(ref, name)

        def spy(*a, _fn=fn, _name=name, **k):
            called.append((_name, a[0].device.type))
            return _fn(*a, **k)
        monkeypatch.setattr(ref, name, spy)
    return called


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_counts_match_the_cpu(arch, kind, ref_spy):
    """A smoke cell's step counted on meta and run on the CPU: the same
    FLOPs exactly (FlopCounterMode's formulas, the kernels' analytic
    FLOPs, the backwards' products), the peak within 5 % (the CPU
    holds the backwards' real temporaries; meta the stand-in's
    model of them, here the CPU's) and the HBM bytes within 25 %.  No meta tensor
    reaches a plain version."""
    shape = _small_shape(arch, kind)
    knobs = TrainKnobs(accum=2, ce_seq_chunk=16)
    counts = {}
    for device in ("meta", "cpu"):
        cell = build_cell(arch, shape, knobs=knobs, smoke=True,
                          device=device)
        groups = cell.argument_tensors()
        counts[device] = count_step(
            cell.fn, cell.args, [t for ts in groups.values() for t in ts],
            device="cpu")
        if device == "meta":
            assert ref_spy == []
    meta, cpu = counts["meta"], counts["cpu"]
    assert meta.flops == cpu.flops > 0
    assert meta.argument_bytes == cpu.argument_bytes
    assert abs(meta.peak_bytes - cpu.peak_bytes) <= 0.05 * cpu.peak_bytes
    assert abs(meta.hbm_bytes - cpu.hbm_bytes) <= 0.25 * cpu.hbm_bytes
    assert all(dev == "cpu" for _, dev in ref_spy)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_meta_counts_match_the_cpu_under_each_remat(remat):
    """llama3.2-1b's smoke train cell at S=128 under each remat mode:
    equal FLOPs, and peaks within 5 %."""
    shape = ShapeSpec("small_train", 128, 2, "train")
    out = {}
    for device in ("meta", "cpu"):
        cell = build_cell("llama3.2-1b", shape, {"remat": remat},
                          knobs=TrainKnobs(ce_seq_chunk=32), smoke=True,
                          device=device)
        out[device] = count_step(cell.fn, cell.args,
                                 [t for ts in cell.argument_tensors()
                                  .values() for t in ts], device="cpu")
    assert out["meta"].flops == out["cpu"].flops
    assert abs(out["meta"].peak_bytes - out["cpu"].peak_bytes) \
        <= 0.05 * out["cpu"].peak_bytes


def test_meta_memo_changes_no_count(monkeypatch):
    """The memo of meta outputs only saves time: every count is the same
    without it."""
    shape = ShapeSpec("small_train", 64, 4, "train")
    counts = []
    for memo in (True, False):
        if not memo:
            monkeypatch.setattr(
                port_roofline._MetaMemo, "__torch_dispatch__",
                lambda self, func, types, args=(), kwargs=None:
                func(*args, **(kwargs or {})))
        cell = build_cell("mixtral-8x22b", shape,
                          {"moe_seq_chunk": 16, "remat": "dots"},
                          knobs=TrainKnobs(accum=2, ce_seq_chunk=16),
                          smoke=True)
        c = count_step(cell.fn, cell.args,
                       [t for ts in cell.argument_tensors().values()
                        for t in ts])
        counts.append((c.flops, c.hbm_bytes, c.peak_bytes))
    assert counts[0] == counts[1]


def test_full_width_decode_cell(ref_spy):
    """llama3.2-1b × decode_32k at full width on meta: the record's
    argument bytes are the exact sums (bf16 weights, the (128, 32768)
    bf16 cache of 16 layers), the peak is above them, and nothing
    reached a plain version."""
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", save=False,
                          verbose=False)
    cfg = port_configs.get_config("llama3.2-1b")
    n_params, _ = cfg.param_count()
    mem = rec["memory"]
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.kv_heads * cfg.head_dim * 2
    assert mem["cache_bytes"] == cache
    assert mem["params_bytes"] == sum(
        p.numel() * 2 for p in Transformer(cfg, device="meta").parameters())
    assert mem["argument_bytes"] == mem["params_bytes"] + mem["cache_bytes"] \
        + mem["batch_bytes"]
    assert mem["peak_bytes"] > mem["argument_bytes"]
    assert rec["fits_80GB"] is False and rec["flops"] > 0
    assert rec["model_flops"] == 2.0 * cfg.param_count()[1] * 128
    assert ref_spy == []


def test_long_500k_skips_with_the_references_reason():
    with pytest.raises(SkipCell) as got:
        build_cell("llama3.2-1b", "long_500k")
    _, want = ref_configs.cell_runnable(
        ref_configs.get_config("llama3.2-1b"), ref_configs.SHAPES["long_500k"])
    assert str(got.value) == want


# -- the backward's stand-in against the backward ---------------------------


def _backward(name, inputs, grads, options=()):
    """Run an operator's backward (``ops.backward``) on the CPU under a
    StepMeter: its working set beyond inputs, output gradients and input
    gradients, its traffic and its FLOPs; with the models' predictions
    for the CPU (``chip_smoke.py`` holds the card's working set, which
    the dry-run uses)."""
    from torch.utils.flop_counter import FlopCounterMode
    meter = StepMeter([x for x in list(inputs) + list(grads)
                       if x is not None])
    base = meter.live
    with meter:
        got = ops.backward(name, inputs, grads, options)
    with FlopCounterMode(display=False) as counter:
        ops.backward(name, inputs, grads, options)
    out = sum(g.numel() * g.element_size() for g in got if g is not None)
    shapes = [None if x is None else x.shape for x in inputs]
    dtype = inputs[0].dtype
    assert counter.get_total_flops() == ops.grad_flops(name, shapes, options)
    return ((meter.peak - base - out, meter.hbm_bytes),
            (ops.grad_workspace(name, shapes, dtype, options, device="cpu"),
             ops.grad_traffic(name, shapes, dtype, options)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,window,softcap", [
    (1, 1536, 8, 2, 32, None, None), (1, 1100, 4, 1, 16, 64, None),
    (2, 1024, 4, 2, 16, None, 30.0)])
def test_attention_stand_in_models_the_plain_backward(B, S, H, KV, D, window,
                                                      softcap, dtype):
    """The operator's backward (the name is older than it): several
    query chunks, a ragged last one, a window and a softcap."""
    g = torch.Generator().manual_seed(0)
    q, k, v, go = (torch.randn((B, S, n, D), generator=g).to(dtype)
                   for n in (H, KV, KV, H))
    (ws, traffic), (ws_m, traffic_m) = _backward(
        "flash_attention", (q, k, v), (go,), (window, softcap))
    assert abs(ws_m - ws) <= 0.10 * ws
    assert abs(traffic_m - traffic) <= 0.10 * traffic


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,R", [(2, 1000, 128), (1, 2048, 64)])
def test_scan_stand_in_models_the_plain_backward(B, S, R, with_h0):
    g = torch.Generator().manual_seed(0)
    a = torch.rand((B, S, R), generator=g)
    b = torch.randn((B, S, R), generator=g)
    h0 = torch.randn((B, R), generator=g) if with_h0 else None
    (ws, traffic), (ws_m, traffic_m) = _backward(
        "rglru_scan", (a, b, h0),
        (torch.randn((B, S, R), generator=g), torch.randn((B, R),
                                                          generator=g)))
    assert abs(ws_m - ws) <= 0.10 * ws
    assert abs(traffic_m - traffic) <= 0.10 * traffic


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("B,H,S", [(1, 2, 512), (2, 1, 100)])
def test_wkv_stand_in_models_the_plain_backward(B, H, S, chunk):
    g = torch.Generator().manual_seed(0)
    r, k, v, go = (torch.randn((B, H, S, 64), generator=g) for _ in range(4))
    w = torch.rand((B, H, S, 64), generator=g)
    u = torch.randn((H, 64), generator=g)
    (ws, traffic), (ws_m, traffic_m) = _backward(
        "wkv6", (r, k, v, w, u, None),
        (go, torch.randn((B, H, 64, 64), generator=g)), (chunk,))
    assert abs(ws_m - ws) <= 0.10 * ws
    assert abs(traffic_m - traffic) <= 0.10 * traffic


#: the shapes the three tests above fit the CPU's working-set and traffic
#: models to are theirs; these they were not fit to (another D, G, window
#: and softcap, S off a multiple of the chunk, an odd S for the scan, N =
#: 32 and another chunk for the WKV), held to the bound ``chip_smoke.py``
#: holds the dry-run's peak to against the card's
HELD_OUT_RTOL = 0.15
HELD_OUT = [
    ("flash_attention", (2, 700, 6, 3, 24), torch.float32, (200, None)),
    ("flash_attention", (2, 700, 6, 3, 24), torch.bfloat16, (200, None)),
    ("flash_attention", (1, 2600, 4, 4, 8), torch.float32, (None, 50.0)),
    ("flash_attention", (1, 1300, 8, 2, 16), torch.bfloat16, (None, None)),
    ("rglru_scan", (1, 777, 40), False, ()),
    ("rglru_scan", (1, 777, 40), True, ()),
    ("rglru_scan", (3, 1536, 16), False, ()),
    ("wkv6", (1, 3, 333, 32), torch.float32, (16,)),
    ("wkv6", (1, 3, 333, 32), torch.bfloat16, (16,)),
    ("wkv6", (1, 1, 1000, 64), torch.float32, (16,)),
]


@pytest.mark.parametrize("name,dims,kind,options", HELD_OUT)
def test_backward_models_hold_at_shapes_they_were_not_fit_to(name, dims,
                                                             kind, options):
    """``kind``: the dtype of q, k, v (attention) or of r, k, v (the WKV);
    for the scan, whether h0 is given."""
    g = torch.Generator().manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    if name == "flash_attention":
        B, S, H, KV, D = dims
        inputs = tuple(randn(B, S, n, D, dtype=kind) for n in (H, KV, KV))
        grads = (randn(B, S, H, D, dtype=kind),)
    elif name == "rglru_scan":
        B, S, R = dims
        inputs = (torch.rand((B, S, R), generator=g), randn(B, S, R),
                  randn(B, R) if kind else None)
        grads = (randn(B, S, R), randn(B, R))
    else:
        B, H, S, N = dims
        inputs = tuple(randn(B, H, S, N, dtype=kind) for _ in range(3)) \
            + (torch.rand((B, H, S, N), generator=g), randn(H, N), None)
        grads = (randn(B, H, S, N), randn(B, H, N, N))
    (ws, traffic), (ws_m, traffic_m) = _backward(name, inputs, grads,
                                                 options)
    assert abs(ws_m - ws) <= HELD_OUT_RTOL * ws
    assert abs(traffic_m - traffic) <= HELD_OUT_RTOL * traffic


def test_kernel_flops_are_the_bounds_formulas():
    """The operators' FLOPs are the formulas ``chip_smoke.py``'s bounds
    use: 4·D a query-key pair, closed form and summed alike."""
    for S, window in ((1, None), (100, None), (100, 7), (2048, 4096)):
        w = S if window is None else min(window, S)
        assert ops.attention_pairs(S, window) == \
            sum(min(i + 1, w) for i in range(S))
    assert ops.attention_flops(2, 16, 4, 64) == 4 * 2 * 4 * 136 * 64
    assert ops.scan_flops(2, 3, 5) == 60
    assert ops.wkv_flops(1, 2, 3, 64) == 6 * (5 * 64 * 64 + 5 * 64)
