"""The decoder, every layer kind of the reference (ATTN, MOE, RG-LRU,
RWKV) — the port of :mod:`repro.models.transformer`.

The reference stacks the weights of each pattern position over depth and
scans over them; the port holds one :class:`AttnLayer`,
:class:`MoELayer`, :class:`RGLRULayer` or :class:`RWKVLayer` per layer in
an ``nn.ModuleList`` and loops.  Dense attention (llama3.2-1b, gemma2-9b's
alternating local/global layers, qwen1.5-110b, deepseek-coder-33b,
internvl2-1b, musicgen-medium), mixture-of-experts layers (mixtral-8x22b,
llama4-maverick-400b-a17b, whose dense and MoE layers alternate), the
RG-LRU hybrid (recurrentgemma-2b), RWKV-6 (rwkv6-7b), and latent
attention with dense and expert layers (:class:`MLALayer`,
:class:`MLAMoELayer`: deepseek-v3).  :func:`forward`
and :func:`lm_loss` sum the MoE layers' aux loss terms, as the reference
does; :func:`prefill` and :func:`decode_step` drop them.

A frontend ``prefix`` (internvl2-1b's patch embeddings, musicgen-medium's
frame embeddings: (B, F, d_model)) is taken by :func:`forward`,
:func:`lm_loss` and :func:`prefill` as in the reference: it is cast to
the model's dtype and put before the (scaled) token embeddings, and the
positions run from 0 over prefix and tokens alike.

Public entry points, with the reference's names and semantics:

* :func:`init_params` — weights from an explicit ``torch.Generator``
* :func:`forward` — full-sequence logits
* :func:`lm_loss` — the training loss: masked token cross-entropy
* :func:`init_cache` — decode state, one dict per layer: ``{"k", "v"}``
  for attention, ``{"latent"}`` for latent attention, ``{"h",
  "conv"}`` for RG-LRU, ``{"shift_t", "shift_c", "wkv"}`` for RWKV
* :func:`prefill` — forward that also fills the decode cache
* :func:`decode_step` — one-token serving step
* :func:`param_specs`, :func:`cache_specs` — the reference's partition
  specs, keyed by the port's names (one card shards nothing)

Caches are updated in place (the reference returns new arrays); each
function still returns the cache it was given, so callers read alike.
An RWKV layer's entries are replaced by the tensors its block returns,
as the reference's new cache holds them: its shift states come back in
the model's dtype (float32 in a float32 model) though ``init_cache``
makes them bfloat16, and the engine's scatter then casts a prefill's
shifts to whatever dtype its cache holds at that moment (ROADMAP §3).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..trace import spans
from .config import LayerKind, MLAConfig, ModelConfig
from .layers import (AttnLayer, MoELayer, decode_gqa_attention,
                     fill_attn_layer, fill_moe_layer, rmsnorm)
from .mla import MLALayer, MLAMoELayer, fill_mla_layer
from .rglru import RGLRULayer, fill_rglru_layer
from .rwkv import HEAD_SIZE, RWKVLayer, fill_rwkv_layer
from .sharding import P, Rules

__all__ = ["Transformer", "init_params", "forward", "lm_loss", "init_cache",
           "prefill", "decode_step", "resolve_device", "param_specs",
           "cache_specs"]

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


_LAYERS = {LayerKind.ATTN: AttnLayer, LayerKind.MOE: MoELayer,
           LayerKind.RGLRU: RGLRULayer, LayerKind.RWKV: RWKVLayer}
_MLA_LAYERS = {LayerKind.ATTN: MLALayer, LayerKind.MOE: MLAMoELayer}
#: the layers whose ``finish`` also returns an aux loss term
_MOE = (MoELayer, MLAMoELayer)


class Transformer(nn.Module):
    """Embedding, ``n_layers`` blocks (:class:`AttnLayer`,
    :class:`MoELayer`, :class:`RGLRULayer` or :class:`RWKVLayer`, by
    ``cfg.layer_kinds()``) and the (tied) unembedding.  Parameter names
    follow the reference's tree, with the stacked ``blocks`` unstacked
    into ``layers[i]``."""

    def __init__(self, cfg: ModelConfig, *, device) -> None:
        super().__init__()
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
        kinds = {**_LAYERS, **_MLA_LAYERS} if isinstance(cfg, MLAConfig) \
            else _LAYERS
        self.layers = nn.ModuleList(
            kinds[kind](cfg, dtype=dtype, device=device)
            for kind in cfg.layer_kinds())

    def local(self, i: int) -> bool:
        return self.cfg.layer_is_local(i % len(self.cfg.pattern))

    def embed_tokens(self, tokens: torch.Tensor,
                     prefix: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings (scaled by √d where the config says so),
        after ``prefix`` (B, F, d) where one is given."""
        h = self.embed[tokens]
        if self.cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(self.cfg.d_model), dtype=h.dtype)
        if prefix is not None:
            h = torch.cat([prefix.to(h.dtype), h], dim=1)
        return h

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with spans.span("model.head"):
            h = rmsnorm(h, self.final_ln, cfg.norm_eps)
            logits = h @ (self.embed.T if cfg.tie_embeddings
                          else self.lm_head)
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
        if isinstance(layer, RGLRULayer):
            fill_rglru_layer(layer, generator)
        elif isinstance(layer, RWKVLayer):
            fill_rwkv_layer(layer, generator)
        elif isinstance(layer, MLALayer):
            fill_mla_layer(layer, generator)
        elif isinstance(layer, MoELayer):
            fill_moe_layer(layer, generator)
        else:
            fill_attn_layer(layer, generator)
    return model


def _run(params: Transformer, h: torch.Tensor, positions: torch.Tensor,
         first: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Layers ``first`` … ``first + n − 1`` over the full sequence, their
    cache entries dropped.  Returns h and the sum of the MoE layers' aux
    terms (float32; 0 without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(first, first + n):
        layer = params.layers[i]
        if isinstance(layer, RWKVLayer):
            with spans.span("model.rwkv"):
                h = layer(h)[0]
        elif isinstance(layer, RGLRULayer):
            h = layer(h)[0]
        elif isinstance(layer, _MOE):
            out = layer(h, positions, local=params.local(i))
            h, aux = out[0], aux + out[-1]
        else:
            h = layer(h, positions, local=params.local(i))[0]
    return h, aux


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            prefix: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits.  Returns (logits (B, S, V), aux scalar) —
    aux is the sum of the MoE layers' load-balancing terms, 0 without
    one.  With a ``prefix`` (B, F, d), S = F + the tokens' length."""
    h = params.embed_tokens(tokens, prefix)
    positions = torch.arange(h.shape[1], device=h.device)
    h, aux = _run(params, h, positions, 0, cfg.n_layers)
    return params.unembed(h), aux


# ---------------------------------------------------------------------------
# Partition specs (the reference's rules over the port's parameter names)
# ---------------------------------------------------------------------------

_TP_IN = {"wq", "w1", "w3", "w_gate", "w_y", "wr", "wg",
          "a_w2"}          # (d, X): shard X over tp, d over fsdp
_TP_OUT = {"wo", "w2", "w_out", "b_w2"}  # (X, d): shard X over tp


def _leaf_spec(path: list[str], ndim: int, cfg: ModelConfig, rules: Rules,
               tp_size: int) -> P:
    """The reference's ``_leaf_spec`` for one leaf at ``path`` (its dict
    keys); the port holds no stacked leading axis."""
    name = path[-1]
    f, t = rules.fsdp, rules.tp
    if name == "embed":
        return P(t, f)
    if name == "lm_head":
        return P(f, t)
    if name == "final_ln":
        return P(None)
    if name == "router":
        return P(f, None)
    if ndim == 3 and name in ("w1", "w2", "w3"):
        # MoE expert weights (E, d, ff) / (E, ff, d)
        if cfg.n_experts % tp_size == 0 and cfg.n_experts >= tp_size:
            return P(t, f, None) if name != "w2" else P(t, None, f)
        return P(None, f, t) if name != "w2" else P(None, t, f)
    if ndim == 2 and name in _TP_IN:
        return P(f, t)
    if ndim == 2 and name in _TP_OUT:
        return P(t, f)
    if ndim == 2 and name in ("conv_w",):
        return P(None, t)
    if ndim == 2 and name in ("wk", "wv"):
        if set(path) & {"tm", "cm"}:
            return P(f, t)      # RWKV projections: heads shard over tp
        # attention K/V projections: KV heads replicated over the model
        # axis, as the reference's
        return P(f, None)
    # gate blocks (H, k, k), biases, norms, mus, loras: replicate
    return P(*([None] * ndim))


def param_specs(cfg: ModelConfig, rules: Rules, tp_size: int) -> dict:
    """The reference's partition spec of every parameter, keyed by the
    port's parameter names (``layers.<i>.<path>``), from a model built
    on the meta device (nothing is allocated)."""
    model = Transformer(cfg, device="meta")
    out = {}
    for name, p in model.named_parameters():
        path = name.split(".")
        if path[0] == "layers":
            path = path[2:]
        out[name] = _leaf_spec(path, p.dim(), cfg, rules, tp_size)
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

#: what ``remat="dots"`` saves: the products without batch dimensions
#: (a (B, S, d) @ (d, n) reaches the dispatcher as ``mm`` after a view)
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
    save every 2-D product's result, recompute everything else — the
    batched products (``bmm``: the MoE experts) and the kernels
    (``repro_torch::flash_attention`` and the others) included."""
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _ce(logits: torch.Tensor, labels: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token cross-entropy in float32, the max taken out before the exp;
    labels < 0 are masked.  Returns (sum, count).  The gold logit is a
    gather (the reference's iota-mask reduction keeps a sharded vocab
    sharded; one card has nothing to shard): the same value, since the
    mask picks one logit and adds zeros."""
    l32 = logits.float()
    m = torch.amax(l32, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(l32 - m), dim=-1)) + m[..., 0]
    mask = labels >= 0
    gold = torch.gather(l32, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.sum((lse - gold) * mask), mask.sum()


def lm_loss(params: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, prefix: torch.Tensor | None = None,
            aux_coef: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels ≥ 0, plus
    ``aux_coef`` × the MoE layers' summed aux term (0 without one).
    With a ``prefix`` (B, F, d) the labels are (B, F + S_tok), −1 over
    the prefix, as :class:`repro_torch.data.SyntheticLM` makes them.

    ``cfg.remat`` says what each pattern unit keeps for the backward
    pass, as the reference's ``_remat`` does for its scan body:
    ``"none"`` keeps everything; ``"dots"`` checkpoints the unit
    (``torch.utils.checkpoint``) with a selective policy that saves the
    result of every product without batch dimensions (``aten.mm`` and
    ``aten.addmm``: the projections and the MLP) and recomputes
    everything else, the batched products (the MoE experts' ``bmm``) and
    the kernel calls included; any other value (``"full"``) recomputes
    the whole unit.  The trailing ``rest`` layers are not checkpointed,
    as there.  A MoE layer checkpoints each of its ``moe_seq_chunk``
    chunks, as the reference's.  With ``cfg.ce_seq_chunk`` dividing S
    the unembedding and CE run chunk by chunk, each chunk checkpointed,
    so the (B, S, V) logits are never all alive.
    """
    h = params.embed_tokens(tokens, prefix)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    P = len(cfg.pattern)
    if cfg.remat == "none":
        unit = _run
    else:
        context = {"context_fn": partial(create_selective_checkpoint_contexts,
                                         _dots_policy)} \
            if cfg.remat == "dots" else {}
        unit = partial(checkpoint, _run, use_reentrant=False, **context)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for u in range(cfg.n_units):
        h, a = unit(params, h, positions, u * P, P)
        aux = aux + a
    h, a = _run(params, h, positions, cfg.n_units * P, cfg.n_remainder)
    aux = aux + a

    chunk = cfg.ce_seq_chunk
    if chunk and S > chunk and S % chunk == 0:
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int64, device=h.device)
        for c in range(0, S, chunk):
            s, n = checkpoint(lambda hc, lc: _ce(params.unembed(hc), lc),
                              h[:, c:c + chunk], labels[:, c:c + chunk],
                              use_reentrant=False)
            tot, cnt = tot + s, cnt + n
    else:
        tot, cnt = _ce(params.unembed(h), labels)
    return tot / torch.clamp(cnt, min=1) + aux_coef * aux


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
    """Zeros, one dict per layer: for attention and MoE layers a
    ``{"k", "v"}`` pair of (B, Sc, KV, D), Sc the window for local layers
    and ``max_len`` otherwise, or with latent attention ``{"latent": (B,
    max_len, kv_lora_rank + qk_rope_head_dim)}`` (c_kv, then the rope
    key); for RG-LRU ``{"h": (B, R) float32,
    "conv": (B, W−1, R) bfloat16}``; for RWKV ``{"shift_t", "shift_c":
    (B, d) bfloat16, "wkv": (B, d/64, 64, 64) float32}``."""
    device = resolve_device(device)
    cdtype = _dt(cfg.cache_dtype)
    cache = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind is LayerKind.RWKV:
            d = cfg.d_model
            cache.append({
                "shift_t": torch.zeros((B, d), dtype=torch.bfloat16,
                                       device=device),
                "shift_c": torch.zeros((B, d), dtype=torch.bfloat16,
                                       device=device),
                "wkv": torch.zeros((B, d // HEAD_SIZE, HEAD_SIZE,
                                    HEAD_SIZE), dtype=torch.float32,
                                   device=device)})
            continue
        if kind is LayerKind.RGLRU:
            R = cfg.rnn_width or cfg.d_model
            cache.append({
                "h": torch.zeros((B, R), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((B, cfg.conv_width - 1, R),
                                    dtype=torch.bfloat16, device=device)})
            continue
        if isinstance(cfg, MLAConfig):
            width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            cache.append({"latent": torch.zeros((B, max_len, width),
                                                dtype=cdtype, device=device)})
            continue
        local = cfg.layer_is_local(i % len(cfg.pattern))
        Sc = min(cfg.window, max_len) if (local and cfg.window) else max_len
        shape = (B, Sc, cfg.kv_heads, cfg.head_dim)
        cache.append({"k": torch.zeros(shape, dtype=cdtype, device=device),
                      "v": torch.zeros(shape, dtype=cdtype, device=device)})
    return cache


def cache_specs(cache_shapes: list[dict], rules: Rules) -> list[dict]:
    """Batch-shard every cache leaf (the model axis is unused by caches),
    as the reference's; ``cache_shapes`` is a cache of
    :func:`init_cache`'s form, of tensors or anything with ``ndim``."""
    def spec(leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return P()
        return P(rules.batch, *([None] * (leaf.ndim - 1)))
    return [{k: spec(v) for k, v in layer.items()} for layer in cache_shapes]


# ---------------------------------------------------------------------------
# Decode / prefill
# ---------------------------------------------------------------------------


def decode_step(params: Transformer, token: torch.Tensor, pos: torch.Tensor,
                cache: list[dict], cfg: ModelConfig
                ) -> tuple[torch.Tensor, list[dict]]:
    """One serving step.  token: (B,) int; pos: int scalar or (B,) vector
    (continuous batching).  Writes this step's keys and values, and the
    recurrent states, into ``cache`` in place (an RWKV layer's dict gets
    the new state tensors); returns (logits (B, V), cache).

    On the card, with the spans off, a step whose every layer declares
    its decode capturable (:func:`_capturable`) is replayed from a CUDA
    graph (:func:`_graphed_decode`): DeepSeek-V3's plain-PyTorch
    launches, ~2,500 a step at 31 layers, would otherwise take the host
    twice the device's time."""
    if token.is_cuda and not spans.enabled() and _capturable(params):
        pos = torch.as_tensor(pos, device=token.device)
        return _graphed_decode(params, token, pos, cache, cfg), cache
    return _decode_step(params, token, pos, cache, cfg)


def _capturable(params: Transformer) -> bool:
    """True if every layer's ``graph_decode`` says that its decode step
    writes its cache in place and reads nothing back to the host, so
    that a CUDA graph captured once replays it for any token and
    position.  Only the latent-attention layers say so: an RWKV layer
    hands back new state tensors, and the other layers' capture has not
    been measured."""
    return all(getattr(layer, "graph_decode", False)
               for layer in params.layers)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    token: torch.Tensor
    pos: torch.Tensor
    logits: torch.Tensor
    cache: list[torch.Tensor]


@torch.no_grad()
def _graphed_decode(params: Transformer, token: torch.Tensor,
                    pos: torch.Tensor, cache: list[dict],
                    cfg: ModelConfig) -> torch.Tensor:
    """:func:`_decode_step` captured once in a CUDA graph for this cache
    (held by ``params``, with its inputs and logits) and replayed.  The
    capture runs the step eagerly first, on a side stream, with this
    call's inputs: it writes this step's latents, which the replay then
    writes again, the same values."""
    held = getattr(params, "_decode_graph", None)
    tensors = [t for c in cache for t in c.values()]
    if held is None or held.token.shape != token.shape \
            or held.pos.shape != pos.shape \
            or any(a is not b for a, b in zip(held.cache, tensors)):
        params._decode_graph = None         # free the last graph first
        tok, at = token.clone(), pos.clone()
        side = torch.cuda.Stream(device=token.device)
        side.wait_stream(torch.cuda.current_stream(token.device))
        with torch.cuda.stream(side):
            _decode_step(params, tok, at, cache, cfg)
        torch.cuda.current_stream(token.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits = _decode_step(params, tok, at, cache, cfg)[0]
        held = params._decode_graph = _Graph(graph, tok, at, logits, tensors)
    held.token.copy_(token)
    held.pos.copy_(pos)
    held.graph.replay()
    return held.logits.clone()


def _decode_step(params: Transformer, token: torch.Tensor, pos: torch.Tensor,
                 cache: list[dict], cfg: ModelConfig
                 ) -> tuple[torch.Tensor, list[dict]]:
    h = params.embed_tokens(token[:, None])
    B = h.shape[0]
    pos = torch.as_tensor(pos, device=h.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    rows = torch.arange(B, device=h.device)
    for layer, c in zip(params.layers, cache):
        if isinstance(layer, RWKVLayer):
            with spans.span("model.rwkv"):
                h, state = layer(h, c)
                c.update(state)
            continue
        if isinstance(layer, RGLRULayer):
            h, state = layer.step(h, c)
            c["h"].copy_(state["h"])
            c["conv"].copy_(state["conv"])
            continue
        if isinstance(layer, MLALayer):
            with spans.span("model.attn"):
                o = layer.decode(h, positions, pos, c, rows)
            with spans.span("model.ffn"):
                h = layer.finish(h, o)
            if isinstance(layer, MLAMoELayer):
                h = h[0]
            continue
        with spans.span("model.attn"):
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
        with spans.span("model.ffn"):
            h = layer.finish(h, o)
        if isinstance(layer, MoELayer):
            h = h[0]                # its aux is dropped, as the reference's
    return params.unembed(h)[:, 0], cache


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None,
            return_all_logits: bool = False, *, length: int | None = None,
            prefix: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, list[dict]]:
    """Forward over a prompt, returning (last-token logits, filled cache)
    — or all logits with ``return_all_logits``.

    A ``prefix`` (B, F, d) goes before the tokens, as in :func:`forward`:
    S counts it, and decode continues at position F + the prompt's
    length.  ``length`` is the number of real tokens when ``tokens`` is
    right-padded to a bucket (default: all of them), so the true length
    is L = F + ``length``.  Each attention ring is filled from real
    positions only: [max(0, L − Sc), L), each at slot position % Sc, so
    pad keys never enter a ring.

    The reference recomputes k/v to fill the cache; the port stores the
    k/v the attention already computed, which are the same tensors.
    """
    B, S_tok = tokens.shape
    F = 0 if prefix is None else prefix.shape[1]
    S = F + S_tok
    n_tok = S_tok if length is None else length
    if not 1 <= n_tok <= S_tok:
        raise ValueError(f"prefill: length {length} for {S_tok} tokens")
    L = F + n_tok
    max_len = max_len or S
    h = params.embed_tokens(tokens, prefix)
    positions = torch.arange(S, device=h.device)
    cache = init_cache(cfg, B, max_len, device=h.device)
    for i, (layer, c) in enumerate(zip(params.layers, cache)):
        if isinstance(layer, RWKVLayer):
            # from the zero state, as the reference synthesizes one
            with spans.span("model.rwkv"):
                h, state = layer(h, c)
                c.update(state)
            continue
        if isinstance(layer, RGLRULayer):
            h, state = layer(h)
            c["h"].copy_(state["h"])
            c["conv"].copy_(state["conv"])
            continue
        if isinstance(layer, MLALayer):
            with spans.span("model.attn"):
                o = layer.attention(h, positions, c, L)[0]
            with spans.span("model.ffn"):
                h = layer.finish(h, o)
            if isinstance(layer, MLAMoELayer):
                h = h[0]
            continue
        with spans.span("model.attn"):
            q, k, v = layer.qkv(h, positions)
            o = layer.attend(q, k, v, params.local(i))
            Sc = c["k"].shape[1]
            n = min(L, Sc)
            k, v = (x[:, L - n:L] for x in (k, v))
            if n == Sc:
                # Ring buffer no longer than the prompt: its last Sc keys,
                # each at slot position % Sc as decode reads them.  (The
                # reference asserts S % Sc == 0, where the roll is 0.)
                k, v = (torch.roll(x, L % Sc, dims=1) for x in (k, v))
            c["k"][:, :n] = _cache_store(k, c["k"].dtype)
            c["v"][:, :n] = _cache_store(v, c["v"].dtype)
        with spans.span("model.ffn"):
            h = layer.finish(h, o)
        if isinstance(layer, MoELayer):
            h = h[0]            # its aux is dropped, as the reference's
    if return_all_logits:
        return params.unembed(h), cache
    return params.unembed(h[:, -1:])[:, 0], cache
