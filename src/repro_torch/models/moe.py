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
* ``n_shared_experts`` adds an MLP of width ``expert_width ·
  n_shared_experts`` on the un-dispatched input.

DeepSeek-V3's experts (an ``MLAConfig``'s, :func:`route_sigmoid`) route
differently and drop nothing.  The router scores all ``n_experts``
with a sigmoid in float32, chooses by the scores plus a bias
(``e_score_correction_bias``) within the ``topk_group`` best of
``n_group`` groups, and weighs the chosen by their scores without the
bias, renormalised and × ``routed_scaling_factor``.  This card holds
``experts_held`` of them (from ``expert_first``), as one chip of an
expert-parallel deployment does: every token is routed over all
experts, and the layer adds only what its own experts give; a pair
routed to an expert held elsewhere adds nothing here.  Each held expert
runs over every token of the chunk, its gate 0 where the token did not
choose it, so that no count leaves the device (:func:`_held_chunk`).
The counters ``moe.pairs_routed`` and ``moe.pairs_held`` (spans on) count
the (token, choice) pairs and those routed to a held expert.  There is
no aux loss (0).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..trace import spans
from .config import MLAConfig
from .layers import MLP, _fill_mlp, _normal_, _param, mlp_apply

__all__ = ["moe_apply", "route_sigmoid", "MoE", "fill_moe"]


def _dispatch_chunk(xc: torch.Tensor, p: Mapping, cfg
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sequence chunk through the routed experts.
    xc: (B, c, d) → (out (B, c, d), aux scalar)."""
    B, c, d = xc.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(k, int(math.ceil(c * k / E * cfg.capacity_factor)))

    with spans.span("moe.dispatch"):
        logits = xc.float() @ p["router"].float()            # (B, c, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)   # (B, c, k)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

        # aux load-balance loss: fraction of tokens per expert × mean prob
        f_e = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
        aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))

        # position of each (token, slot) within its expert's capacity buffer
        dispatch = xc.new_zeros((B, c, E, C))
        combine = torch.zeros((B, c, E, C), dtype=torch.float32,
                              device=xc.device)
        fill = torch.zeros((B, E), dtype=torch.long, device=xc.device)
        for slot in range(k):
            e_hot = F.one_hot(gate_idx[..., slot], E)        # (B, c, E)
            pos = fill[:, None, :] + torch.cumsum(e_hot, dim=1) - e_hot
            keep = (e_hot > 0) & (pos < C)
            # a kept pair has e_hot = 1, so this is the reference's
            # pos_hot · e_hot
            sel = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C] \
                .to(xc.dtype)                                # (B, c, E, C)
            dispatch = dispatch + sel
            combine = combine + sel.float() * gate_vals[..., slot, None, None]
            fill = fill + e_hot.sum(dim=1)

        xd = torch.einsum("bcek,bcd->ebkd", dispatch, xc)    # (E, B, C, d)
        xd = xd.reshape(E, B * C, d)
    with spans.span("moe.experts"):
        h = F.silu(torch.bmm(xd, p["w1"]))
        if "w3" in p:
            h = h * torch.bmm(xd, p["w3"])
        ye = torch.bmm(h, p["w2"]).reshape(E, B, C, d)
        out = torch.einsum("bcek,ebkd->bcd", combine.to(ye.dtype), ye)
    return out, aux


def route_sigmoid(x: torch.Tensor, p: Mapping, cfg
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router over x (..., d): (the chosen experts (...,
    top_k) of all ``n_experts``, their gates (..., top_k) float32).  As
    the published ``MoEGate``: experts outside the kept groups are
    masked to 0 before the top-k, and the gates are the scores
    renormalised (+1e-20) and scaled."""
    scores = torch.sigmoid(x.float() @ p["router"].float())
    choice = scores + p["bias"].float()
    groups = choice.unflatten(-1, (cfg.n_group, -1))
    best = groups.topk(2, dim=-1).values.sum(-1)          # (..., G)
    kept = torch.zeros_like(best, dtype=torch.bool).scatter_(
        -1, best.topk(cfg.topk_group, dim=-1).indices, True)
    choice = groups.masked_fill(~kept[..., None], 0.0).flatten(-2)
    idx = choice.topk(cfg.top_k, dim=-1).indices
    gates = scores.gather(-1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return idx, gates * cfg.routed_scaling_factor


def _held_chunk(xc: torch.Tensor, p: Mapping, cfg
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sequence chunk through the held experts, dropless.
    xc: (B, c, d) → (out (B, c, d), aux 0)."""
    B, c, d = xc.shape
    n, E = B * c, cfg.n_held
    with spans.span("moe.dispatch"):
        idx, gates = route_sigmoid(xc, p, cfg)
        local = idx.view(n, -1) - cfg.expert_first
        held = (local >= 0) & (local < E)
        spans.add("moe.pairs_routed", idx.numel())
        spans.add("moe.pairs_held", held)
        # each token's gate for each held expert (it chooses one at most
        # once); the pairs held elsewhere go to column E, dropped
        combine = torch.zeros((n, E + 1), dtype=torch.float32,
                              device=xc.device).scatter_(
            1, torch.where(held, local, E), gates.view(n, -1))[:, :E]
    with spans.span("moe.experts"):
        xe = xc.reshape(1, n, d).expand(E, n, d)
        h = F.silu(torch.bmm(xe, p["w1"]))
        if "w3" in p:
            h = h * torch.bmm(xe, p["w3"])
        ye = torch.bmm(h, p["w2"])                           # (E, n, d)
        out = (ye * combine.T[..., None].to(ye.dtype)).sum(0)
    return out.view(B, c, d), torch.zeros((), dtype=torch.float32,
                                          device=xc.device)


def moe_apply(x: torch.Tensor, p: Mapping, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out (B, S, d), aux loss scalar, float32).  ``p``
    holds ``router``, ``w1``, ``w2`` (and ``w3``), ``bias`` with sigmoid
    routing and, with shared experts, ``shared`` (an MLP's leaves)."""
    B, S, d = x.shape
    chunk = cfg.moe_seq_chunk
    dispatch = _held_chunk if isinstance(cfg, MLAConfig) else _dispatch_chunk
    if chunk <= 0 or S <= chunk:
        out, aux = dispatch(x, p, cfg)
    else:
        assert S % chunk == 0, (S, chunk)
        outs, auxs = [], []
        for c0 in range(0, S, chunk):
            xc = x[:, c0:c0 + chunk]
            if torch.is_grad_enabled():
                # otherwise the backward keeps every chunk's dispatch
                # tensors and expert activations
                o, a = checkpoint(dispatch, xc, p, cfg,
                                  use_reentrant=False)
            else:
                o, a = dispatch(xc, p, cfg)
            outs.append(o)
            auxs.append(a)
        out = torch.cat(outs, dim=1)
        aux = torch.stack(auxs).mean()
    if cfg.n_shared_experts:
        out = out + mlp_apply(x, p["shared"], cfg.mlp)
    return out, aux


class MoE(nn.Module):
    """The routed experts (and the shared one), with the reference's leaf
    names: ``router`` (d, E) float32, ``w1``/``w3`` (E_held, d, ff),
    ``w2`` (E_held, ff, d), ``shared`` an :class:`~.layers.MLP`; with
    sigmoid routing also ``bias`` (E,) float32."""

    def __init__(self, cfg, *, dtype, device) -> None:
        super().__init__()
        d, ff, E = cfg.d_model, cfg.expert_width, cfg.n_held
        self.cfg = cfg
        self.router = _param((d, cfg.n_experts), torch.float32, device)
        if isinstance(cfg, MLAConfig):
            self.bias = _param((cfg.n_experts,), torch.float32, device)
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
    N(0, 1/ff) for w2, the shared expert as an MLP; the router's bias 0,
    as the published model initialises it.  Each stack is drawn one
    expert at a time, so that no float32 copy of a whole stack exists
    (one of llama4-maverick's is 5.4 G elements)."""
    d, ff = m.cfg.d_model, m.cfg.expert_width
    _normal_(m.router, 1.0 / math.sqrt(d), generator)
    if hasattr(m, "bias"):
        m.bias.zero_()
    stacks = [(m.w1, d), (m.w2, ff)]
    if hasattr(m, "w3"):
        stacks.append((m.w3, d))
    for w, fan_in in stacks:
        for e in range(w.shape[0]):
            _normal_(w[e], 1.0 / math.sqrt(fan_in), generator)
    if m.cfg.n_shared_experts:
        _fill_mlp(m.shared, generator)
