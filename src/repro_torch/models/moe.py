"""Mixture-of-Experts FFN — the port of :mod:`repro.models.moe`: GShard-
style capacity-bounded one-hot dispatch, with the reference's semantics.

* The router runs in float32 (``router`` is a float32 leaf even in a
  bfloat16 model): softmax, top-k, the top-k gates renormalised (their
  sum clamped at 1e-9).
* The load-balancing aux loss is ``E · Σ_e f_e · P_e``, f_e the share of
  tokens whose top-1 choice is expert e and P_e its mean probability.
* Capacity ``C = max(k, ⌈c·k/E·cf⌉)`` for a chunk of c positions.  Each
  batch row fills its experts slot-major: every token's first choice,
  then every token's second, ``fill`` counting all the tokens of the
  chunk (pads included).  A (token, slot) pair at a position ≥ C is
  dropped and its gate is not redistributed.
* Dispatch is in the activation dtype; the combine weights are float32,
  cast to the activation dtype before the combine product.
* The experts, ``silu(x·w1) ⊙ (x·w3) · w2`` batched over E, are
  ``torch.bmm`` on the stacks as stored — (E, d, ff) and (E, ff, d), no
  copy — as the reference computes them with ``jnp.einsum`` outside any
  kernel.  Every expert runs over its C slots, filled or not, so a
  decode step (c = 1, C = k) reads every expert's weights.
* The sequence goes in chunks of ``moe_seq_chunk`` (each checkpointed
  when gradients are taken, as the reference's ``jax.checkpoint`` scan
  body); the aux is the mean over the chunks.
* ``n_shared_experts`` adds an MLP of width ``d_ff · n_shared_experts``
  on the un-dispatched input.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import MLP, _fill_mlp, _normal_, _param, mlp_apply

__all__ = ["moe_apply", "MoE", "fill_moe"]


def _dispatch_chunk(xc: torch.Tensor, p: Mapping, cfg
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sequence chunk through the routed experts.
    xc: (B, c, d) → (out (B, c, d), aux scalar)."""
    B, c, d = xc.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(k, int(math.ceil(c * k / E * cfg.capacity_factor)))

    logits = xc.float() @ p["router"].float()                # (B, c, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)       # (B, c, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # aux load-balance loss: fraction of tokens per expert × mean prob
    f_e = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))

    # position of each (token, slot) within its expert's capacity buffer
    dispatch = xc.new_zeros((B, c, E, C))
    combine = torch.zeros((B, c, E, C), dtype=torch.float32,
                          device=xc.device)
    fill = torch.zeros((B, E), dtype=torch.long, device=xc.device)
    for slot in range(k):
        e_hot = F.one_hot(gate_idx[..., slot], E)            # (B, c, E)
        pos = fill[:, None, :] + torch.cumsum(e_hot, dim=1) - e_hot
        keep = (e_hot > 0) & (pos < C)
        # a kept pair has e_hot = 1, so this is the reference's
        # pos_hot · e_hot
        sel = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C] \
            .to(xc.dtype)                                    # (B, c, E, C)
        dispatch = dispatch + sel
        combine = combine + sel.float() * gate_vals[..., slot, None, None]
        fill = fill + e_hot.sum(dim=1)

    xd = torch.einsum("bcek,bcd->ebkd", dispatch, xc)        # (E, B, C, d)
    xd = xd.reshape(E, B * C, d)
    h = F.silu(torch.bmm(xd, p["w1"]))
    if "w3" in p:
        h = h * torch.bmm(xd, p["w3"])
    ye = torch.bmm(h, p["w2"]).reshape(E, B, C, d)
    out = torch.einsum("bcek,ebkd->bcd", combine.to(ye.dtype), ye)
    return out, aux


def moe_apply(x: torch.Tensor, p: Mapping, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out (B, S, d), aux loss scalar, float32).  ``p``
    holds ``router``, ``w1``, ``w2`` (and ``w3``) and, with shared
    experts, ``shared`` (an MLP's leaves)."""
    B, S, d = x.shape
    chunk = cfg.moe_seq_chunk
    if chunk <= 0 or S <= chunk:
        out, aux = _dispatch_chunk(x, p, cfg)
    else:
        assert S % chunk == 0, (S, chunk)
        outs, auxs = [], []
        for c0 in range(0, S, chunk):
            xc = x[:, c0:c0 + chunk]
            if torch.is_grad_enabled():
                # otherwise the backward keeps every chunk's dispatch
                # tensors and expert activations
                o, a = checkpoint(_dispatch_chunk, xc, p, cfg,
                                  use_reentrant=False)
            else:
                o, a = _dispatch_chunk(xc, p, cfg)
            outs.append(o)
            auxs.append(a)
        out = torch.cat(outs, dim=1)
        aux = torch.stack(auxs).mean()
    if cfg.n_shared_experts:
        out = out + mlp_apply(x, p["shared"], cfg.mlp)
    return out, aux


class MoE(nn.Module):
    """The routed experts (and the shared one), with the reference's leaf
    names: ``router`` (d, E) float32, ``w1``/``w3`` (E, d, ff), ``w2``
    (E, ff, d), ``shared`` an :class:`~.layers.MLP`."""

    def __init__(self, cfg, *, dtype, device) -> None:
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.cfg = cfg
        self.router = _param((d, E), torch.float32, device)
        self.w1 = _param((E, d, ff), dtype, device)
        self.w2 = _param((E, ff, d), dtype, device)
        if cfg.mlp in ("swiglu", "geglu"):
            self.w3 = _param((E, d, ff), dtype, device)
        if cfg.n_shared_experts:
            self.shared = MLP(d, ff * cfg.n_shared_experts, cfg.mlp,
                              dtype=dtype, device=device)

    def leaves(self) -> dict:
        p = dict(self.named_parameters(recurse=False))
        if self.cfg.n_shared_experts:
            p["shared"] = dict(self.shared.named_parameters())
        return p

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(x, self.leaves(), self.cfg)


@torch.no_grad()
def fill_moe(m: MoE, generator: torch.Generator) -> None:
    """The reference's init scales: N(0, 1/d) for the router, w1 and w3,
    N(0, 1/ff) for w2, the shared expert as an MLP.  Each stack is drawn
    one expert at a time, so that no float32 copy of a whole stack exists
    (one of llama4-maverick's is 5.4 G elements)."""
    d, ff = m.cfg.d_model, m.cfg.d_ff
    _normal_(m.router, 1.0 / math.sqrt(d), generator)
    stacks = [(m.w1, d), (m.w2, ff)]
    if hasattr(m, "w3"):
        stacks.append((m.w3, d))
    for w, fan_in in stacks:
        for e in range(w.shape[0]):
            _normal_(w[e], 1.0 / math.sqrt(fan_in), generator)
    if m.cfg.n_shared_experts:
        _fill_mlp(m.shared, generator)
