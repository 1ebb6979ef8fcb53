"""Wire an (arch × shape) cell into a step function and its arguments —
the port of :mod:`repro.launch.cells`.

The reference builds each cell's arguments as ``ShapeDtypeStruct``s
through ``jax.eval_shape``, sharded over a production mesh.  The port
builds them on PyTorch's meta device the same way: the model is
constructed on meta without being initialised, and the optimizer state,
the batch and the cache are meta tensors, so nothing is allocated and
running the step computes nothing — every operator only infers its
outputs' shapes (the kernels through their fakes,
:mod:`repro_torch.kernels.ops`).  :func:`build_cell` takes another
``device`` too, where it initialises the weights from ``seed`` and draws
the batch, so that the same cell runs for real (``chip_smoke.py`` holds
the dry-run against the card that way).  One card: no mesh, every
tensor whole.

Per-arch training knobs (gradient-accumulation depth, gradient /
optimizer state dtypes) are the reference's ``TRAIN_KNOBS``, chosen
there for a 16 GB v5e chip of a 256-chip mesh; on one card most train
cells do not fit, and the dry-run says so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from ..configs import (SHAPES, ShapeSpec, cell_runnable, get_config,
                       get_smoke_config)
from ..models import ModelConfig, init_cache, init_params, prefill
from ..models.transformer import Transformer
from ..optim import AdamWConfig, adamw_init
from ..train.steps import StepConfig, make_serve_step, make_train_step
from .mesh import rules_for_mesh

__all__ = ["SkipCell", "CellSpec", "build_cell", "TRAIN_KNOBS",
           "TrainKnobs"]


class SkipCell(Exception):
    """Raised when an (arch × shape) cell is N/A (reason in args[0])."""


@dataclass(frozen=True)
class TrainKnobs:
    accum: int = 1
    grad_dtype: str = "float32"
    opt_dtype: str = "float32"
    ce_seq_chunk: int = 512


TRAIN_KNOBS: dict[str, TrainKnobs] = {
    "internvl2-1b": TrainKnobs(accum=1),
    "gemma2-9b": TrainKnobs(accum=2),
    "deepseek-coder-33b": TrainKnobs(accum=8),
    "llama3.2-1b": TrainKnobs(accum=1),
    "qwen1.5-110b": TrainKnobs(accum=16),
    "mixtral-8x22b": TrainKnobs(accum=8),
    "llama4-maverick-400b-a17b": TrainKnobs(
        accum=8, grad_dtype="bfloat16", opt_dtype="bfloat16"),
    "musicgen-medium": TrainKnobs(accum=4),
    "recurrentgemma-2b": TrainKnobs(accum=2),
    "rwkv6-7b": TrainKnobs(accum=4),
}


@dataclass
class CellSpec:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Any                 # the step: fn(*args)
    args: tuple             # its arguments, on the cell's device
    donate: tuple[int, ...]  # arguments the step updates in place
    kind: str               # train | prefill | decode
    static_notes: dict

    def argument_tensors(self) -> dict[str, list[torch.Tensor]]:
        """The arguments' tensors by role: ``params``, and ``opt`` and
        ``batch`` (train), ``batch`` (prefill), or ``batch`` and ``cache``
        (decode)."""
        def leaves(x) -> list[torch.Tensor]:
            if isinstance(x, nn.Module):
                return list(x.parameters()) + list(x.buffers())
            return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]

        params, *rest = self.args
        if self.kind == "train":
            opt, _, batch = rest
            return {"params": leaves(params), "opt": leaves(opt),
                    "batch": leaves(batch)}
        if self.kind == "prefill":
            return {"params": leaves(params), "batch": leaves(rest)}
        tok, pos, cache = rest
        return {"params": leaves(params), "batch": leaves([tok, pos]),
                "cache": leaves(cache)}


def _params(cfg: ModelConfig, device: torch.device, seed: int
            ) -> Transformer:
    if device.type == "meta":
        # meta has no generator: shapes and dtypes only, never filled
        return Transformer(cfg, device=device)
    return init_params(cfg, device=device, seed=seed)


def build_cell(arch: str, shape: str | ShapeSpec,
               cfg_overrides: dict | None = None,
               rules_overrides: dict | None = None,
               knobs: TrainKnobs | None = None, *, smoke: bool = False,
               device: str | torch.device = "meta",
               seed: int = 0) -> CellSpec:
    """The cell of ``arch`` (its published config, or its smoke config
    with ``smoke``) at ``shape`` (a name in ``SHAPES`` or a
    :class:`~repro_torch.configs.ShapeSpec`), on ``device`` (meta by
    default: nothing allocated).  Raises :class:`SkipCell` where
    :func:`~repro_torch.configs.cell_runnable` says no."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    rules = rules_for_mesh(("data", "model"), rules_overrides)
    knobs = knobs or TRAIN_KNOBS[arch]
    if shape.kind == "train":
        cfg = cfg.replace(ce_seq_chunk=knobs.ce_seq_chunk)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        raise SkipCell(why)

    device = torch.device(device)
    gen = None if device.type == "meta" \
        else torch.Generator(device=device).manual_seed(seed + 1)

    def tokens(*shape_):
        return torch.randint(0, cfg.vocab, shape_, generator=gen,
                             device=device)

    def prefix(*shape_):
        if gen is None:
            return torch.empty(shape_, dtype=torch.bfloat16, device=device)
        return torch.randn(shape_, generator=gen, device=device
                           ).to(torch.bfloat16)

    params = _params(cfg, device, seed)
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend_len
    S_tok = S - F
    notes = {"tp": 1, "batch_devices": 1}

    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=knobs.opt_dtype)
        A = min(knobs.accum, max(1, B // notes["batch_devices"]))
        step_cfg = StepConfig(accum=A, grad_dtype=knobs.grad_dtype)
        assert B % A == 0, (B, A)
        mB = B // A
        opt = adamw_init(dict(params.named_parameters()), opt_cfg)
        batch = {"tokens": tokens(A, mB, S_tok), "labels": tokens(A, mB, S)}
        if F:
            batch["labels"][..., :F] = -1
            batch["prefix"] = prefix(A, mB, F, cfg.d_model)
        fn = make_train_step(cfg, opt_cfg, step_cfg, rules=rules)
        notes["accum"] = A
        notes["micro_batch"] = mB
        return CellSpec(arch, shape, cfg, fn, (params, opt, 0, batch),
                        (0, 1), "train", notes)

    if shape.kind == "prefill":
        args = [params, tokens(B, S_tok)]
        if F:
            args.append(prefix(B, F, cfg.d_model))

        @torch.no_grad()
        def fn(params, tokens, prefix=None):
            return prefill(params, tokens, cfg, max_len=S, prefix=prefix)
        return CellSpec(arch, shape, cfg, fn, tuple(args), (), "prefill",
                        notes)

    # decode: one new token against a seq_len-deep cache
    cache = init_cache(cfg, B, S, device=device)
    # a (B,) position vector, as the engine passes it: a 0-dim position
    # indexes the cache through a host read, which meta cannot give
    pos = torch.full((B,), S - 1, dtype=torch.long, device=device)
    fn = make_serve_step(cfg, rules=rules)
    return CellSpec(arch, shape, cfg, fn, (params, tokens(B), pos, cache),
                    (3,), "decode", notes)
