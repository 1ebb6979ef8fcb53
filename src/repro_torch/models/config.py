"""Model configuration — one dataclass describes every assigned arch.

A model is a *pattern* of layer kinds repeated over depth.  Homogeneous
repeats are stacked and scanned (bounded HLO size / compile time at 1000+
layers); a non-divisible remainder is unrolled.

Layer kinds:
  ``attn``    dense GQA attention block (optional window / softcap / bias)
  ``moe``     GQA attention + mixture-of-experts FFN
  ``rglru``   RG-LRU recurrent block (RecurrentGemma)
  ``rwkv``    RWKV-6 time-mix + channel-mix block (attention-free)

:class:`MLAConfig` (the port's own; :class:`ModelConfig` stays the JAX
package's field for field) adds what DeepSeek-V3 needs: latent attention
(MLA) in the ``attn`` and ``moe`` layers, leading dense layers, experts
narrower than the dense MLP, DeepSeek-V3's sigmoid routing, and the
share of the routed experts this card holds (expert parallelism).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

__all__ = ["LayerKind", "ModelConfig", "MLAConfig"]


class LayerKind(str, enum.Enum):
    ATTN = "attn"
    MOE = "moe"
    RGLRU = "rglru"
    RWKV = "rwkv"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free archs)
    kv_heads: int           # KV heads (GQA); == n_heads ⇒ MHA
    d_ff: int
    vocab: int
    head_dim: int = 128
    # -- layer pattern -------------------------------------------------------
    #: repeating unit of layer kinds; cycled over n_layers.
    pattern: tuple[LayerKind, ...] = (LayerKind.ATTN,)
    # -- attention flavor ------------------------------------------------------
    #: sliding-window size for *local* attention layers (None ⇒ global).
    window: int | None = None
    #: which pattern positions use the window (True ⇒ local); len == pattern.
    local_mask: tuple[bool, ...] | None = None
    attn_softcap: float | None = None     # gemma2: 50.0
    logit_softcap: float | None = None    # gemma2: 30.0
    qkv_bias: bool = False                # qwen1.5
    rope_theta: float = 10_000.0
    # -- MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0             # llama4: 1 shared expert
    #: sequence-chunk size for dispatch einsums (bounds the (B,S,E,C) temp)
    moe_seq_chunk: int = 512
    # -- recurrent (RG-LRU / RWKV) -------------------------------------------------
    rnn_width: int | None = None          # RG-LRU recurrent width (d_rnn)
    conv_width: int = 4                   # temporal conv in RG-LRU block
    #: WKV chunk length (pairwise-decay tile);  traffic ≈ S·L·N + S/L·N²
    #: is minimized near L = √N = 8 (see EXPERIMENTS.md §Perf)
    rwkv_chunk: int = 16
    #: KV-cache storage dtype; "int8" halves decode cache traffic using
    #: fixed-scale symmetric quantization (post-RoPE keys are O(1))
    cache_dtype: str = "bfloat16"
    # -- activation / norm flavor ---------------------------------------------------
    mlp: str = "swiglu"                   # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    post_norms: bool = False              # gemma2: post-attn/post-ffn norms
    embed_scale: bool = False             # gemma-family: scale embed by sqrt(d)
    tie_embeddings: bool = True
    # -- frontend stub (vlm / audio) -------------------------------------------------
    #: if > 0, input_specs provide (B, frontend_len, d_model) embeddings that
    #: are prepended to the token embeddings (modality frontends are stubs).
    frontend_len: int = 0
    # -- training-time knobs -----------------------------------------------------------
    remat: str = "full"                   # none | full | dots
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    #: cross-entropy computed over sequence chunks of this size (0 ⇒ whole
    #: sequence at once); bounds the (B,S,V) logits temporary.
    ce_seq_chunk: int = 0

    # -- derived -------------------------------------------------------------------------

    def layer_kinds(self) -> list[LayerKind]:
        p = list(self.pattern)
        return [p[i % len(p)] for i in range(self.n_layers)]

    def layer_is_local(self, pattern_pos: int) -> bool:
        if self.window is None:
            return False
        if self.local_mask is None:
            return True
        return self.local_mask[pattern_pos % len(self.pattern)]

    @property
    def n_units(self) -> int:
        """Number of full pattern repeats (scanned)."""
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        """Trailing layers not forming a full pattern (unrolled)."""
        return self.n_layers % len(self.pattern)

    # -- what MLAConfig changes (the reference's layers here) -----------------------

    @property
    def n_held(self) -> int:
        """Routed experts whose weights this card holds."""
        return self.n_experts

    @property
    def expert_width(self) -> int:
        """Width of each routed and shared expert."""
        return self.d_ff

    @property
    def attention_free(self) -> bool:
        return all(k in (LayerKind.RWKV,) for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1)/bounded ⇒ long-context capable."""
        kinds = set(self.layer_kinds())
        if kinds <= {LayerKind.RWKV, LayerKind.RGLRU}:
            return True
        # attention layers are fine iff every one is windowed
        if self.window is None:
            return False
        for i, k in enumerate(self.layer_kinds()):
            if k in (LayerKind.ATTN, LayerKind.MOE) \
                    and not self.layer_is_local(i):
                return False
        return True

    def padded_vocab(self, multiple: int = 128) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for 6·N·D roofline checks) ------------------------------

    def param_count(self) -> tuple[int, int]:
        """Returns (total_params, active_params_per_token)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        total = active = self.padded_vocab() * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab() * d
            active += self.padded_vocab() * d
        for i, kind in enumerate(self.layer_kinds()):
            if kind in (LayerKind.ATTN, LayerKind.MOE):
                attn = self._attn_params()
                total += attn
                active += attn
            if kind is LayerKind.ATTN:
                m = d * ff * (3 if self.mlp in ("swiglu", "geglu") else 2)
                total += m
                active += m
            elif kind is LayerKind.MOE:
                t, a = self._moe_params()
                total += t
                active += a
            elif kind is LayerKind.RGLRU:
                rnn = self.rnn_width or d
                blk = d * rnn * 2 + rnn * d + rnn * self.conv_width \
                    + 2 * rnn * rnn // 8 + rnn  # gates are block-diagonal
                m = d * ff * (3 if self.mlp in ("swiglu", "geglu") else 2)
                total += blk + m
                active += blk + m
            elif kind is LayerKind.RWKV:
                tm = d * d * 4 + d * 64 * 2 + d * 32 * 2  # r,k,v,o + w/g lora
                cm = d * ff * 2
                total += tm + cm
                active += tm + cm
        return total, active

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * self.n_heads * hd + 2 * d * self.kv_heads * hd \
            + self.n_heads * hd * d

    def _moe_params(self) -> tuple[int, int]:
        """(total, active per token) of one MoE layer's experts and
        router."""
        m1 = self.d_model * self.expert_width \
            * (3 if self.mlp in ("swiglu", "geglu") else 2)
        router = self.d_model * self.n_experts
        return ((self.n_experts + self.n_shared_experts) * m1 + router,
                (self.top_k + self.n_shared_experts) * m1 + router)


@dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A :class:`ModelConfig` with DeepSeek-V3's layers (the port's own).

    * Latent attention (:mod:`repro_torch.models.mla`) in every ``attn``
      and ``moe`` layer; the first ``first_k_dense_replace`` layers are
      ``attn`` (a dense MLP of width ``d_ff``) whatever the pattern.
    * Experts of width ``moe_intermediate_size`` (the shared ones too).
    * DeepSeek-V3's router (sigmoid scores, a bias for the choice,
      ``topk_group`` of ``n_group`` groups, gates renormalised ×
      ``routed_scaling_factor``), dropless over the ``experts_held``
      experts from ``expert_first`` that this card holds of the router's
      ``n_experts`` (0 ⇒ all).
    * YaRN scaling of the rope dims' frequencies and of the scores.
    """

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 0
    moe_intermediate_size: int = 0        # 0 ⇒ d_ff
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    experts_held: int = 0
    expert_first: int = 0
    #: YaRN (factor 1 ⇒ plain RoPE), as the published ``rope_scaling``
    yarn_factor: float = 1.0
    yarn_original_max_position_embeddings: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    def layer_kinds(self) -> list[LayerKind]:
        return [LayerKind.ATTN if i < self.first_k_dense_replace else k
                for i, k in enumerate(super().layer_kinds())]

    @property
    def n_held(self) -> int:
        return self.experts_held or self.n_experts

    @property
    def expert_width(self) -> int:
        return self.moe_intermediate_size or self.d_ff

    def _attn_params(self) -> int:
        """The query's down and up projections, the latent's (with the
        shared rope key), the latent's up to keys and values, the output
        (norms left out, as for GQA)."""
        d, H, r = self.d_model, self.n_heads, self.kv_lora_rank
        q_head = self.qk_nope_head_dim + self.qk_rope_head_dim
        return (d * self.q_lora_rank + self.q_lora_rank * H * q_head
                + d * (r + self.qk_rope_head_dim)
                + r * H * (self.qk_nope_head_dim + self.v_head_dim)
                + H * self.v_head_dim * d)

    def _moe_params(self) -> tuple[int, int]:
        """The experts held, the shared ones, the router and its bias; a
        token meets ``top_k`` of the ``n_experts``, held/n_experts of
        them here."""
        m1 = self.d_model * self.expert_width \
            * (3 if self.mlp in ("swiglu", "geglu") else 2)
        router = (self.d_model + 1) * self.n_experts       # and its bias
        shared = self.n_shared_experts * m1
        return (self.n_held * m1 + shared + router,
                self.top_k * self.n_held * m1 // self.n_experts + shared
                + router)
