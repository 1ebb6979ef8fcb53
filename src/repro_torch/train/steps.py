"""Step functions: train (loss → grad → clip → AdamW) and serve (one
greedy decode token) — the port of :mod:`repro.train.steps`.

The train step consumes a *microbatched* batch ``(accum, micro_B, S)``.
The reference scans over the accumulation axis under ``jit``; the port
loops, takes each microbatch's gradients with ``torch.autograd.grad``,
casts them to ``grad_dtype`` (float32 by default) and adds them there —
never into the bfloat16 ``.grad`` of the parameters.  PyTorch runs
eagerly, so there is nothing to compile; one card has no mesh, so the
reference's ``rules`` (sharding constraints) have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..convert import reference_leaves
from ..models import ModelConfig, decode_step, lm_loss
from ..models.transformer import Transformer
from ..optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                     cosine_warmup)
from .compression import compress_grads

__all__ = ["StepConfig", "grads_of", "apply_update", "make_train_step",
           "make_serve_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class StepConfig:
    accum: int = 1                 # gradient-accumulation steps
    grad_dtype: str = "float32"    # accumulation dtype
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    #: int8-quantize gradients (with error feedback) before the
    #: optimizer — opt_state must carry an "ef" tree
    compress: bool = False


def grads_of(params: Transformer, cfg: ModelConfig, batch: dict,
             step_cfg: StepConfig) -> tuple[torch.Tensor, dict]:
    """The loss and the gradients of one step's batch, averaged over its
    ``accum`` microbatches: ``(loss, {name: grad in grad_dtype})``.

    Makes ``params`` trainable.  Each microbatch's gradients come from
    ``torch.autograd.grad``, are cast to ``grad_dtype`` and added there.
    Microbatch ``a`` takes ``batch["prefix"][a]`` where the batch has a
    prefix, as the reference's scan does.
    """
    gdt = _DTYPES[step_cfg.grad_dtype]
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    tokens, labels = batch["tokens"], batch["labels"]
    prefix = batch.get("prefix")
    loss, grads = 0.0, {}
    # as the reference: accum 1 takes the first microbatch only
    for a in range(tokens.shape[0] if step_cfg.accum > 1 else 1):
        l_a = lm_loss(params, tokens[a], labels[a], cfg,
                      prefix=None if prefix is None else prefix[a])
        g_a = torch.autograd.grad(l_a, list(named.values()))
        loss = loss + l_a.detach()
        for k, g in zip(named, g_a):
            if k in grads:
                grads[k] += g.to(gdt)
            else:
                grads[k] = g.to(gdt)
    if step_cfg.accum > 1:
        inv = 1.0 / step_cfg.accum
        for g in grads.values():
            g.mul_(inv)
        loss = loss * inv
    return loss, grads


def apply_update(params: Transformer, opt_state: dict, step: int,
                 grads: dict, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 step_cfg: StepConfig
                 ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """Optional compression, the clip, the schedule and AdamW: updates
    ``params`` in place and returns ``(opt_state, grad_norm, lr_scale)``.

    The leaves of ``grads`` are replaced by the compressed, then the
    clipped ones, so that one copy of the gradients is alive during AdamW.
    """
    named = dict(params.named_parameters())
    ef_new = None
    if step_cfg.compress:
        new, ef_new = compress_grads(grads, opt_state["ef"],
                                     reference_leaves(named, cfg))
        grads.update(new)
        del new
    new, gnorm = clip_by_global_norm(grads, step_cfg.clip_norm)
    grads.update(new)
    del new
    lr_scale = cosine_warmup(step, warmup=step_cfg.warmup,
                             total=step_cfg.total_steps)
    adam_state = {k: v for k, v in opt_state.items() if k != "ef"}
    _, adam_state = adamw_update(grads, adam_state, named, opt_cfg,
                                 lr_scale)
    if ef_new is not None:
        adam_state["ef"] = ef_new
    return adam_state, gnorm, lr_scale


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig):
    """Returns ``train_step(params, opt_state, step, batch) ->
    (params, opt_state, metrics)``: :func:`grads_of`, then
    :func:`apply_update`.

    ``params``: the :class:`Transformer`, updated in place (its
    parameters are made trainable here); ``opt_state``: from
    :func:`repro_torch.optim.adamw_init`, keyed by parameter name, plus
    ``"ef"`` with ``compress``; ``batch``: ``{"tokens": (A, B, S) int,
    "labels": (A, B, S) int[, "prefix": (A, B, F, d)]}`` on the model's
    device — A = accumulation steps, S = F + S_tok.  ``metrics``: ``loss``, ``grad_norm`` and ``lr_scale``,
    float32 scalars.
    """

    def train_step(params: Transformer, opt_state: dict, step: int,
                   batch: dict):
        loss, grads = grads_of(params, cfg, batch, step_cfg)
        opt_state, gnorm, lr_scale = apply_update(
            params, opt_state, step, grads, cfg, opt_cfg, step_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """Returns ``serve_step(params, token, pos, cache) ->
    (next_token, cache)`` — one greedy decode step."""

    @torch.no_grad()
    def serve_step(params: Transformer, token: torch.Tensor, pos,
                   cache: list[dict]):
        logits, cache = decode_step(params, token, pos, cache, cfg)
        # Mask the padded vocab tail before argmax.
        if logits.shape[-1] != cfg.vocab:
            logits = logits.clone()
            logits[..., cfg.vocab:] = -torch.inf
        return torch.argmax(logits, dim=-1).to(token.dtype), cache

    return serve_step
