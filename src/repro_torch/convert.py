"""Weights between the reference's parameter tree and the port's model.

The caller turns the JAX pytree into numpy arrays (``jax.tree.map(
np.asarray, params)``); this module never imports JAX.  The reference
stacks each pattern position's weights over depth (``blocks[pos][name]``
has a leading ``n_units`` axis) and keeps a non-divisible remainder in
``rest``; the port holds one module per layer, so ``blocks[pos][name][i]``
becomes layer ``i * len(pattern) + pos`` and ``rest[j]`` layer
``n_units * len(pattern) + j``.  Nested leaves (``mlp``, RWKV's ``tm``
and ``cm`` dicts, and a MoE layer's ``moe`` with its ``shared`` expert:
``moe.shared.w1``) map to submodules' parameters by their dotted names;
a MoE layer's expert stacks (E, d, ff) are (n_units, E, d, ff) in
``blocks``.  :func:`tree_from_named` and :func:`named_from_tree` are that
mapping, for any leaves keyed by the port's parameter names (weights,
AdamW moments, error feedback); the checkpoint uses them.

:func:`params_from_jax` requires each leaf to match its port parameter
in shape and dtype (RG-LRU's gate leaves, RWKV's ``u``, ``w0``,
``gn_w``, ``gn_b`` and the MoE ``router`` are float32 in a bfloat16
model); a mismatch raises
rather than casting.  :func:`params_to_jax` is its inverse.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.config import ModelConfig
from .models.transformer import Transformer, resolve_device

__all__ = ["params_from_jax", "params_to_jax", "tensor_from_numpy",
           "numpy_from_tensor", "tree_from_named", "named_from_tree",
           "reference_leaves"]


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


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy copy on the host; ``bfloat16`` comes back as
    its bits, a ``uint16`` array (numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _nest(flat: Mapping[str, Any]) -> dict:
    """``{"mlp.w1": x}`` → ``{"mlp": {"w1": x}}``."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[last] = leaf
    return out


def _flat(tree: Mapping[str, Any], prefix: str = "") -> dict:
    """The inverse of :func:`_nest`."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def tree_from_named(named: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> dict:
    """The reference's tree from tensors keyed by the port's parameter
    names: ``layers.<i>.<name>`` stacked over units into
    ``blocks[pos]`` (a new tensor, on the leaves' device), the remainder
    into ``rest``, everything else at the top."""
    P, base = len(cfg.pattern), cfg.n_units * len(cfg.pattern)
    layers: list[dict] = [{} for _ in range(cfg.n_layers)]
    top = {}
    for name, t in named.items():
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, leaf = rest.partition(".")
            layers[int(i)][leaf] = t
        else:
            top[name] = t
    blocks = tuple(
        _nest({k: torch.stack([layers[u * P + pos][k]
                               for u in range(cfg.n_units)])
               for k in layers[pos]})
        for pos in range(P))
    rest = tuple(_nest(layers[base + j]) for j in range(cfg.n_remainder))
    return {**top, "blocks": blocks, "rest": rest}


def named_from_tree(tree: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """The inverse of :func:`tree_from_named`, for tensor or numpy leaves:
    ``blocks[pos][name][u]`` becomes ``layers.<u·P + pos>.<name>``."""
    P, base = len(cfg.pattern), cfg.n_units * len(cfg.pattern)
    out = {k: v for k, v in tree.items() if k not in ("blocks", "rest")}
    for pos, stacked in enumerate(tree["blocks"]):
        for name, leaf in _flat(stacked).items():
            for u in range(cfg.n_units):
                out[f"layers.{u * P + pos}.{name}"] = leaf[u]
    for j, leaves in enumerate(tree["rest"]):
        for name, leaf in _flat(leaves).items():
            out[f"layers.{base + j}.{name}"] = leaf
    return out


def reference_leaves(names, cfg: ModelConfig) -> list[list[str]]:
    """The port's parameter names grouped by the reference leaf that
    holds them: ``blocks[pos][name]`` holds ``layers.<u·P + pos>.<name>``
    of every unit u; every other name is a leaf of its own."""
    P, base = len(cfg.pattern), cfg.n_units * len(cfg.pattern)
    groups: dict[str, list[str]] = {}
    for name in names:
        head, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        key = f"blocks.{int(i) % P}.{leaf}" \
            if head == "layers" and int(i) < base else name
        groups.setdefault(key, []).append(name)
    return list(groups.values())


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    t = tensor_from_numpy(np.asarray(src))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port "
                         f"shape {tuple(dst.shape)}")
    if t.dtype != dst.dtype:
        raise ValueError(f"{name}: reference dtype {t.dtype}, port dtype "
                         f"{dst.dtype}")
    dst.copy_(t)


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Transformer:
    """Build the port's model on ``device`` from the reference tree of
    numpy arrays (same keys and ``(in, out)`` layouts)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    got = named_from_tree(tree, cfg)
    want = dict(model.named_parameters())
    if set(got) != set(want):
        raise ValueError(f"reference leaves {sorted(set(got) - set(want))} "
                         "are not port parameters, and port parameters "
                         f"{sorted(set(want) - set(got))} are missing")
    for name, p in want.items():
        _copy(p, got[name], name)
    return model


def params_to_jax(model: Transformer, cfg: ModelConfig) -> dict:
    """The reference's tree of numpy arrays from the port's model, bf16
    leaves as their bits (``uint16``; view them as ``ml_dtypes``'
    bfloat16 on the JAX side)."""
    named = {n: p.detach().cpu() for n, p in model.named_parameters()}
    tree = tree_from_named(named, cfg)

    def to_numpy(x):
        if isinstance(x, Mapping):
            return {k: to_numpy(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(to_numpy(v) for v in x)
        return numpy_from_tensor(x)
    return to_numpy(tree)
