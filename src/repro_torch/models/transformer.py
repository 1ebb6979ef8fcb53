"""The decoder, ATTN pattern — the port of :mod:`repro.models.transformer`.

The reference stacks the weights of each pattern position over depth and
scans over them; the port holds one :class:`AttnLayer` per layer in an
``nn.ModuleList`` and loops.  Only dense attention archs (llama3.2-1b)
are ported so far; MoE, RG-LRU and RWKV layers raise.

Public entry points, with the reference's names and semantics:

* :func:`init_params` — weights from an explicit ``torch.Generator``
* :func:`forward` — full-sequence logits
* :func:`init_cache` — decode state, one ``{"k", "v"}`` dict per layer
* :func:`prefill` — forward that also fills the decode cache
* :func:`decode_step` — one-token serving step

Caches are updated in place (the reference returns new arrays); each
function still returns the cache it was given, so callers read alike.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .config import LayerKind, ModelConfig
from .layers import (AttnLayer, decode_gqa_attention, fill_attn_layer,
                     rmsnorm)

__all__ = ["Transformer", "init_params", "forward", "init_cache",
           "prefill", "decode_step", "resolve_device"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks
    for the CPU; asking for CUDA without a GPU raises rather than
    carrying on on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU — pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if device.index is None:        # "cuda" names the current card
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_kinds(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds())
    if kinds != {LayerKind.ATTN}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(k.value for k in kinds)}; "
            "the port serves dense attention layers only so far")


class Transformer(nn.Module):
    """Embedding, ``n_layers`` :class:`AttnLayer` blocks and the (tied)
    unembedding.  Parameter names follow the reference's tree, with the
    stacked ``blocks`` unstacked into ``layers[i]``."""

    def __init__(self, cfg: ModelConfig, *, device) -> None:
        super().__init__()
        _check_kinds(cfg)
        dtype = _dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.padded_vocab(), cfg.d_model, dtype=dtype,
                        device=device), requires_grad=False)
        self.final_ln = nn.Parameter(
            torch.empty(cfg.d_model, dtype=dtype, device=device),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.padded_vocab(), dtype=dtype,
                            device=device), requires_grad=False)
        self.layers = nn.ModuleList(
            AttnLayer(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))

    def local(self, i: int) -> bool:
        return self.cfg.layer_is_local(i % len(self.cfg.pattern))

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.embed[tokens]
        if self.cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(self.cfg.d_model), dtype=h.dtype)
        return h

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(h, self.final_ln, cfg.norm_eps)
        logits = h @ (self.embed.T if cfg.tie_embeddings else self.lm_head)
        if cfg.logit_softcap is not None:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        return logits


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda",
                seed: int = 0) -> Transformer:
    """Random weights with the reference's shapes and init scales.

    ``generator`` defaults to a new one on ``device`` seeded with
    ``seed``.  The numbers differ from ``jax.random``'s; tests carry
    weights across with :func:`repro_torch.convert.params_from_jax`.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device)
    d = cfg.d_model
    model.embed.copy_(torch.randn(model.embed.shape, generator=generator,
                                  device=generator.device)
                      / math.sqrt(d))
    model.final_ln.zero_()
    if not cfg.tie_embeddings:
        model.lm_head.copy_(torch.randn(model.lm_head.shape,
                                        generator=generator,
                                        device=generator.device)
                            / math.sqrt(d))
    for layer in model.layers:
        fill_attn_layer(layer, generator)
    return model


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits (B, S, V), aux scalar) —
    aux is the MoE loss term, 0 for dense layers."""
    h = params.embed_tokens(tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    for i, layer in enumerate(params.layers):
        h, _, _ = layer(h, positions, local=params.local(i))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return params.unembed(h), aux


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


_CACHE_SCALE = 42.0     # int8 fixed scale: ±3σ of O(1) activations


def _cache_store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * _CACHE_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def _cache_load(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int8:
        return (x.float() / _CACHE_SCALE).to(torch.bfloat16)
    return x


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device: str | torch.device = "cuda") -> list[dict]:
    """One ``{"k", "v"}`` pair of (B, Sc, KV, D) zeros per layer; Sc is
    the window for local layers and ``max_len`` otherwise."""
    _check_kinds(cfg)
    device = resolve_device(device)
    cdtype = _dt(cfg.cache_dtype)
    cache = []
    for i in range(cfg.n_layers):
        local = cfg.layer_is_local(i % len(cfg.pattern))
        Sc = min(cfg.window, max_len) if (local and cfg.window) else max_len
        shape = (B, Sc, cfg.kv_heads, cfg.head_dim)
        cache.append({"k": torch.zeros(shape, dtype=cdtype, device=device),
                      "v": torch.zeros(shape, dtype=cdtype, device=device)})
    return cache


# ---------------------------------------------------------------------------
# Decode / prefill
# ---------------------------------------------------------------------------


def decode_step(params: Transformer, token: torch.Tensor, pos: torch.Tensor,
                cache: list[dict], cfg: ModelConfig
                ) -> tuple[torch.Tensor, list[dict]]:
    """One serving step.  token: (B,) int; pos: int scalar or (B,) vector
    (continuous batching).  Writes this step's keys and values into
    ``cache`` in place; returns (logits (B, V), cache)."""
    h = params.embed_tokens(token[:, None])
    B = h.shape[0]
    pos = torch.as_tensor(pos, device=h.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    rows = torch.arange(B, device=h.device)
    for layer, c in zip(params.layers, cache):
        q, k, v = layer.qkv(h, positions)
        # Ring semantics are universal: slot = pos % Sc (see reference).
        slot = torch.remainder(pos, c["k"].shape[1])
        if pos.dim():
            c["k"][rows, slot] = _cache_store(k[:, 0], c["k"].dtype)
            c["v"][rows, slot] = _cache_store(v[:, 0], c["v"].dtype)
        else:
            c["k"][:, slot] = _cache_store(k[:, 0], c["k"].dtype)
            c["v"][:, slot] = _cache_store(v[:, 0], c["v"].dtype)
        o = decode_gqa_attention(q, _cache_load(c["k"]),
                                 _cache_load(c["v"]), pos, ring=True,
                                 softcap=cfg.attn_softcap)
        h = layer.finish(h, o)
    return params.unembed(h)[:, 0], cache


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None,
            return_all_logits: bool = False
            ) -> tuple[torch.Tensor, list[dict]]:
    """Forward over a prompt, returning (last-token logits, filled cache)
    — or all logits with ``return_all_logits``.

    The reference recomputes k/v to fill the cache; the port stores the
    k/v the attention already computed, which are the same tensors.
    """
    B, S = tokens.shape
    max_len = max_len or S
    h = params.embed_tokens(tokens)
    positions = torch.arange(S, device=h.device)
    cache = init_cache(cfg, B, max_len, device=h.device)
    for i, (layer, c) in enumerate(zip(params.layers, cache)):
        h, k, v = layer(h, positions, local=params.local(i))
        Sc = c["k"].shape[1]
        if Sc < S:
            # Ring buffer smaller than the prompt: keep the last Sc keys.
            assert S % Sc == 0, (S, Sc)
            k, v = k[:, -Sc:], v[:, -Sc:]
        n = k.shape[1]
        c["k"][:, :n] = _cache_store(k, c["k"].dtype)
        c["v"][:, :n] = _cache_store(v, c["v"].dtype)
    if return_all_logits:
        return params.unembed(h), cache
    return params.unembed(h[:, -1:])[:, 0], cache
