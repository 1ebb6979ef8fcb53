"""Weights from the reference's parameter tree into the port's model.

The caller turns the JAX pytree into numpy arrays (``jax.tree.map(
np.asarray, params)``); this module never imports JAX.  The reference
stacks each pattern position's weights over depth (``blocks[pos][name]``
has a leading ``n_units`` axis) and keeps a non-divisible remainder in
``rest``; the port holds one module per layer, so ``blocks[pos][name][i]``
becomes layer ``i * len(pattern) + pos``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.config import ModelConfig
from .models.transformer import Transformer, resolve_device

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a CPU tensor.  ``bfloat16`` (an ``ml_dtypes``
    type that torch cannot read) is recognized by its dtype name and
    carried over bit for bit through a ``uint16`` view, as the reference
    checkpoint stores it."""
    a = np.array(a)     # a writable, contiguous copy
    if str(a.dtype) == "bfloat16":
        bits = a.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(a)


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    t = tensor_from_numpy(np.asarray(src))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(t)


def _load_layer(layer: torch.nn.Module, leaves: Mapping[str, Any],
                index: int | None, prefix: str) -> None:
    want = dict(layer.named_parameters())
    got: dict[str, np.ndarray] = {}

    def walk(tree: Mapping[str, Any], path: str) -> None:
        for key, val in tree.items():
            name = f"{path}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                got[name] = val if index is None else np.asarray(val)[index]

    walk(leaves, "")
    if set(got) != set(want):
        raise ValueError(f"{prefix}: reference leaves {sorted(got)} != "
                         f"port parameters {sorted(want)}")
    for name, p in want.items():
        _copy(p, got[name], f"{prefix}.{name}")


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Transformer:
    """Build the port's model on ``device`` from the reference tree of
    numpy arrays (same keys and ``(in, out)`` layouts)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_ln, tree["final_ln"], "final_ln")
    if not cfg.tie_embeddings:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    P = len(cfg.pattern)
    for pos, stacked in enumerate(tree["blocks"]):
        for unit in range(cfg.n_units):
            i = unit * P + pos
            _load_layer(model.layers[i], stacked, unit, f"layers.{i}")
    base = cfg.n_units * P
    for j, leaves in enumerate(tree["rest"]):
        _load_layer(model.layers[base + j], leaves, None,
                    f"layers.{base + j}")
    return model
