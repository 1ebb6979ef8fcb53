"""The benchmark's weights, made on the device from ``--seed``.

A reference family (``bench/reference/<family>.py``) lists its weights
as groups of :class:`Leaf`: the embedding, one group a layer, the head.
Each group has a generator of its own, seeded from the run's seed and
the group's index, and its leaves are drawn in place, in order, in the
dtype they are served in.  So any group can be drawn again alone, with
the same values: the program's model is filled once, and the reference
draws each layer again when it needs it, after the program's state is
gone.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Leaf", "DTYPES", "group_seed", "draw", "fill_model"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Leaf:
    """One weight: its name (the program's parameter name), shape, dtype
    and how it is drawn: ``("normal", mean, std)`` or ``("linspace",
    first, last)``."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    init: tuple


def group_seed(seed: int, group: int) -> int:
    """The generator seed of one group: any run seed (up to 64 bits)
    and group index give a seed below 2**63."""
    return (int(seed) * 1_000_003 + 7_919 * (group + 1)) % (2**63 - 1)


@torch.no_grad()
def draw(leaves: list[Leaf], seed: int, group: int,
         device: torch.device | str,
         into: dict[str, torch.Tensor] | None = None
         ) -> dict[str, torch.Tensor]:
    """Draw one group's leaves; into ``into[name]`` where given (it must
    have the leaf's shape and dtype), else into new tensors."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    out = {}
    for leaf in leaves:
        dtype = DTYPES[leaf.dtype]
        if into is not None:
            t = into[leaf.name]
            if tuple(t.shape) != leaf.shape or t.dtype != dtype \
                    or not t.is_contiguous():
                raise ValueError(
                    f"{leaf.name}: the program holds {tuple(t.shape)} "
                    f"{t.dtype}, the benchmark draws {leaf.shape} {dtype}")
        else:
            t = torch.empty(leaf.shape, dtype=dtype, device=device)
        kind, a, b = leaf.init
        if kind == "normal":
            t.normal_(a, b, generator=gen)
        elif kind == "linspace":
            t.copy_(torch.linspace(a, b, t.numel(), dtype=torch.float32,
                                   device=device).view(t.shape))
        else:
            raise ValueError(f"{leaf.name}: unknown init {kind!r}")
        out[leaf.name] = t
    return out


def fill_model(groups: list[list[Leaf]], seed: int,
               params: dict[str, torch.Tensor]) -> None:
    """Fill a program's parameters (``named_parameters()``) with every
    group's leaves; the names must match exactly."""
    want = {leaf.name for g in groups for leaf in g}
    if want != set(params):
        raise ValueError(
            "the program's parameters and the benchmark's weights differ: "
            f"only the program's {sorted(set(params) - want)[:8]}, only "
            f"the benchmark's {sorted(want - set(params))[:8]}")
    device = next(iter(params.values())).device
    for g, leaves in enumerate(groups):
        draw(leaves, seed, g, device, into=params)
