"""Sharding rules: logical tensor roles → partition specs — the port of
:mod:`repro.models.sharding`.

The reference shards over a production mesh (``(data, model)`` single
pod, ``(pod, data, model)`` multi-pod):

* ``batch``  — batch dims shard over (pod, data)
* ``fsdp``   — parameter/optimizer dims shard over (pod, data) (ZeRO-3)
* ``tp``     — head / ff / vocab / expert dims shard over model

The port runs on one card, where there is nothing to shard: the specs
are kept (:func:`repro_torch.models.param_specs`,
:func:`~repro_torch.models.cache_specs`,
:func:`repro_torch.optim.opt_state_specs` give the reference's), and
:meth:`Rules.constrain` returns its tensor as it is.  :class:`P` stands
in for ``jax.sharding.PartitionSpec``: a tuple with one entry per axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

__all__ = ["Rules", "P"]


class P(tuple):
    """A partition spec: one entry per tensor axis — a mesh axis name, a
    tuple of them, or ``None`` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class Rules:
    batch: tuple[str, ...] = ("data",)       # ("pod","data") multi-pod
    fsdp: tuple[str, ...] = ("data",)
    tp: str = "model"
    #: named activation constraint points (hillclimb levers)
    overrides: dict = field(default_factory=dict)

    # -- activation constraint points ------------------------------------

    def spec(self, name: str) -> P:
        """Partition spec for a named activation role."""
        if name in self.overrides:
            return self.overrides[name]
        b = self.batch
        table = {
            "hidden": P(b, None, None),          # (B, S, d)
            "hidden_tp": P(b, None, self.tp),    # (B, S, d) TP-sharded d
            "heads": P(b, None, self.tp, None),  # (B, S, H, D)
            "kv": P(b, None, None, None),        # (B, S, K, D) replicated K
            "logits": P(b, None, self.tp),       # (B, S, V)
            "expert_tokens": P(self.tp, b, None, None),  # (E, B, C, d)
            "rnn": P(b, None, self.tp),          # (B, S, R)
            "wkv_heads": P(b, self.tp, None, None),      # (B, H, S, N)
            "wkv_state": P(b, self.tp, None, None),      # (B, H, N, N)
            "cache": P(b, None, None, None),     # (B, Sc, K, D)
        }
        return table[name]

    def constrain(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x`` as it is: one card holds every tensor whole.  The role
        is still looked up, so an unknown name raises as there."""
        self.spec(name)
        return x


def constrain(rules: "Rules | None", x: torch.Tensor,
              name: str) -> torch.Tensor:
    if rules is None:
        return x
    return rules.constrain(x, name)
