"""Multi-head latent attention (MLA), as DeepSeek-V3 computes it
(arXiv:2412.19437; its published ``modeling_deepseek.py``), and the
block around it: :class:`MLALayer` (MLA and a dense MLP) and
:class:`MLAMoELayer` (MLA and the experts of :mod:`.moe`).

* Queries: ``c_q = RMSNorm(x·W_qa)``, ``q = c_q·W_qb``: H heads of
  ``qk_nope_head_dim`` + ``qk_rope_head_dim``.
* Latent: ``[c, k_pe] = x·W_kva``; ``c_kv = RMSNorm(c)`` (width
  ``kv_lora_rank``) and ``k_pe`` one rope head that every query head
  shares.  Keys and values: ``[k_nope, v]_h = c_kv·W_kvb``.
* Scores ``(q_nope·k_nope + RoPE(q_pe)·RoPE(k_pe)) × scale``, scale
  ``(nope + rope)^−½ · m²`` with YaRN's ``m = 0.1·ln(factor)·
  mscale_all_dim + 1``.  RoPE turns the pairs (2i, 2i+1) with YaRN's
  frequencies (:func:`yarn_inv_freq`), as the published code does (it
  lays the pairs out as halves before its ``rotate_half``; here they
  keep their places, which changes no product of two such vectors).
* The heads' outputs, concatenated, times ``W_o``.

Two paths, one result.  Over a whole sequence (a prefill, the forward)
the keys and values of every head are materialised and the causal
attention is K1 (:func:`repro_torch.kernels.ops.attention`): q and k
padded with zeros from nope + rope = 192 to its head dim of 256, v from
128, q scaled so that K1's 1/16 gives ``scale``; the pads add nothing to
a score and are cut from the output.  A decode step is *absorbed*: the
cache holds only ``[c_kv | RoPE(k_pe)]`` (``kv_lora_rank`` +
``qk_rope_head_dim`` values a position, one tensor, so that one product
gives the scores), ``q_nope`` is carried into the latent space through
``W_kvb``'s key half, the scores and the weighted sum are taken against
the latent cache itself, and the latent output goes back through the
value half.  Its products are in the activation dtype with float32 sums,
the scores float32 from the product on (:func:`_bmm_f32`), with no
float32 copy of the cache; the slots ≤ each row's position count.

Weights are ``(in, out)`` as ``x @ W`` uses them, except ``wkv_b``,
which is ``(H·(nope + v), kv_lora_rank)``, the published ``kv_b_proj``
layout: each head's key and value halves are then contiguous
``(nope, kv_lora_rank)`` and ``(v, kv_lora_rank)`` blocks, which the
absorbed decode multiplies by as they lie.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..trace import spans
from .layers import MLP, _fill_mlp, _normal_, _param, rmsnorm

__all__ = ["MLALayer", "MLAMoELayer", "fill_mla_layer", "yarn_inv_freq",
           "yarn_mscale", "softmax_scale", "rope_pairs"]

#: K1's head dim that holds MLA's nope + rope (192) and v (128)
_K1_DIM = 256


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor, ``yarn_get_mscale`` of the published
    code."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_inv_freq(cfg) -> torch.Tensor:
    """The rope dims' frequencies (``qk_rope_head_dim / 2``, float32 on
    the CPU), as ``DeepseekV3YarnRotaryEmbedding`` computes them: the
    original frequencies above the ``beta_fast`` correction dim, those
    divided by the factor below ``beta_slow``'s, a linear ramp between."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    expo = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** expo)
    if cfg.yarn_factor <= 1:
        return extra
    inter = 1.0 / (cfg.yarn_factor * base ** expo)
    max_pos = cfg.yarn_original_max_position_embeddings
    low = max(math.floor(_correction_dim(cfg.yarn_beta_fast, dim, base,
                                         max_pos)), 0)
    high = min(math.ceil(_correction_dim(cfg.yarn_beta_slow, dim, base,
                                         max_pos)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def softmax_scale(cfg) -> float:
    """``(nope + rope)^−½``, times YaRN's factor squared where
    ``yarn_mscale_all_dim`` is set (0.13523 for DeepSeek-V3)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_mscale_all_dim:
        m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        scale = scale * m * m
    return scale


def rope_pairs(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """The pairs (2i, 2i+1) of x (..., S, H, D) turned as the complex
    numbers x_2i + i·x_2i+1 times ``rot`` (..., S, 1, D/2), complex64:
    mscale·exp(i·pos·f_i), from :meth:`MLALayer.rotation`.  Computed in
    float32, returned in x's dtype, each pair in its place."""
    z = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)).contiguous())
    return torch.view_as_real(z * rot).flatten(-2).to(x.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with float32 results: on the card from bf16
    operands with float32 sums and output, so that no float32 copy of
    ``b`` is made; on the CPU, which has no such product, in float32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class MLALayer(nn.Module):
    """One DeepSeek-V3 block: pre-norm MLA and a pre-norm MLP of width
    ``d_ff``, each with a residual.  :meth:`forward` returns ``(h,
    latent)``, as :class:`~.layers.AttnLayer` returns its keys and
    values."""

    #: :meth:`decode` writes the latent cache in place and reads nothing
    #: back to the host: a CUDA graph can replay it
    #: (:func:`~.transformer.decode_step`)
    graph_decode = True

    def __init__(self, cfg, *, dtype, device) -> None:
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim, cfg.v_head_dim)
        self.cfg = cfg
        self.ln1 = _param((d,), dtype, device)
        self.wq_a = _param((d, cfg.q_lora_rank), dtype, device)
        self.q_norm = _param((cfg.q_lora_rank,), dtype, device)
        self.wq_b = _param((cfg.q_lora_rank, H * (dn + dr)), dtype, device)
        self.wkv_a = _param((d, r + dr), dtype, device)
        self.kv_norm = _param((r,), dtype, device)
        self.wkv_b = _param((H * (dn + dv), r), dtype, device)
        self.wo = _param((H * dv, d), dtype, device)
        self.ln2 = _param((d,), dtype, device)
        self._make_ffn(cfg, dtype=dtype, device=device)
        self._inv_freq = yarn_inv_freq(cfg)
        self._rope_mscale = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) \
            / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        self.scale = softmax_scale(cfg)

    def _make_ffn(self, cfg, *, dtype, device) -> None:
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, dtype=dtype,
                       device=device)

    def rotation(self, positions: torch.Tensor) -> torch.Tensor:
        """mscale·exp(i·pos·f) (..., S, 1, rope/2), complex64, for
        positions broadcastable to (..., S): :func:`rope_pairs`' turn."""
        if self._inv_freq.device != positions.device:
            self._inv_freq = self._inv_freq.to(positions.device)
        ang = positions.float()[..., None] * self._inv_freq
        mag = torch.full_like(ang, self._rope_mscale)
        return torch.polar(mag, ang)[..., None, :]

    # -- projections ------------------------------------------------------------

    def queries(self, x: torch.Tensor, rot: torch.Tensor):
        """q_nope (B, S, H, nope) and RoPE(q_pe) (B, S, H, rope) of the
        normed input x."""
        cfg = self.cfg
        B, S, _ = x.shape
        c = rmsnorm(x @ self.wq_a, self.q_norm, cfg.norm_eps)
        q = (c @ self.wq_b).view(B, S, cfg.n_heads, -1)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                               dim=-1)
        return q_nope, rope_pairs(q_pe, rot)

    def latent(self, x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
        """[c_kv (normed) | RoPE(k_pe)] (B, S, kv_lora_rank + rope): what
        the cache holds of each position."""
        cfg = self.cfg
        ckv, kpe = (x @ self.wkv_a).split(
            [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
        ckv = rmsnorm(ckv, self.kv_norm, cfg.norm_eps)
        return torch.cat([ckv, rope_pairs(kpe[:, :, None], rot)[:, :, 0]],
                         dim=-1)

    # -- attention ----------------------------------------------------------------

    def attend(self, q_nope, q_pe, lat) -> torch.Tensor:
        """Causal attention over a whole sequence, keys and values of
        every head materialised and padded to K1's head dim: (B, S, H,
        v)."""
        cfg = self.cfg
        B, S, H, dn = q_nope.shape
        r, dr, dv = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.v_head_dim
        kv = (lat[..., :r] @ self.wkv_b.T).view(B, S, H, dn + dv)
        pad = _K1_DIM - dn - dr
        # K1 scales by 1/sqrt(256); q carries the rest of ``scale``
        q = F.pad(torch.cat([q_nope, q_pe], dim=-1)
                  * (self.scale * math.sqrt(_K1_DIM)), (0, pad))
        k = F.pad(torch.cat([kv[..., :dn],
                             lat[:, :, None, r:].expand(B, S, H, dr)],
                            dim=-1), (0, pad))
        v = F.pad(kv[..., dn:], (0, _K1_DIM - dv))
        return ops.attention(q, k, v)[..., :dv]

    def attend_latent(self, q_nope, q_pe, lat,
                      pos: torch.Tensor) -> torch.Tensor:
        """One token a row against the latent cache, absorbed: q_nope
        (B, 1, H, nope), q_pe (B, 1, H, rope); lat (B, Sc, r + rope);
        the slots ≤ pos (scalar or (B,)) count.  Returns (B, 1, H, v)."""
        cfg = self.cfg
        B, _, H, dn = q_nope.shape
        r = cfg.kv_lora_rank
        w = self.wkv_b.view(H, -1, r)
        w_uk, w_uv = w[:, :dn], w[:, dn:]                 # (H, nope|v, r)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk)  # (H, B, r)
        q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1) \
            .mul_(self.scale)                             # (B, H, r + rope)
        s = _bmm_f32(q, lat.transpose(1, 2))              # (B, H, Sc)
        slots = torch.arange(lat.shape[1], device=lat.device)
        dead = slots[None, :] > pos.reshape(-1, 1)        # (B or 1, Sc)
        s.masked_fill_(dead[:, None, :], -math.inf)
        p = torch.softmax(s, dim=-1).to(lat.dtype)
        o_lat = torch.bmm(p, lat[..., :r])                 # (B, H, r)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))
        return o.transpose(0, 1)[:, None]

    # -- the block ------------------------------------------------------------------

    def attention(self, h: torch.Tensor, positions: torch.Tensor,
                  cache: dict | None = None, L: int = 0):
        """(o (B, S, H, v), the latent (B, S, r + rope)) of the whole
        sequence h.  With a ``cache`` (a prefill whose first L positions
        are real), their latents go into it, a ring of Sc slots: the
        last min(L, Sc), each at slot position % Sc."""
        x = rmsnorm(h, self.ln1, self.cfg.norm_eps)
        rot = self.rotation(positions)
        with spans.span("model.mla.q"):
            q_nope, q_pe = self.queries(x, rot)
        with spans.span("model.mla.kv"):
            lat = self.latent(x, rot)
            if cache is not None:
                ring = cache["latent"]
                n = min(L, ring.shape[1])
                t = lat[:, L - n:L]
                if n == ring.shape[1]:
                    t = torch.roll(t, L % n, dims=1)
                ring[:, :n] = t.to(ring.dtype)
        with spans.span("model.mla.attend"):
            o = self.attend(q_nope, q_pe, lat)
        return o, lat

    def decode(self, h: torch.Tensor, positions: torch.Tensor,
               pos: torch.Tensor, cache: dict,
               rows: torch.Tensor) -> torch.Tensor:
        """One token a row: its latent written at slot pos % Sc of
        ``cache``, then :meth:`attend_latent`.  Returns (B, 1, H, v)."""
        x = rmsnorm(h, self.ln1, self.cfg.norm_eps)
        rot = self.rotation(positions)
        with spans.span("model.mla.q"):
            q_nope, q_pe = self.queries(x, rot)
        with spans.span("model.mla.kv"):
            lat = cache["latent"]
            slot = torch.remainder(pos, lat.shape[1])
            at = (rows, slot) if pos.dim() else (slice(None), slot)
            lat[at] = self.latent(x, rot)[:, 0].to(lat.dtype)
        with spans.span("model.mla.attend"):
            return self.attend_latent(q_nope, q_pe, lat, pos)

    def _attn_residual(self, h: torch.Tensor, o: torch.Tensor):
        B, S, _ = h.shape
        h = h + o.reshape(B, S, -1).to(h.dtype) @ self.wo
        return h, rmsnorm(h, self.ln2, self.cfg.norm_eps)

    def finish(self, h: torch.Tensor, o: torch.Tensor):
        """Output projection, residual, and the MLP half of the block."""
        h, x = self._attn_residual(h, o)
        return h + self.mlp(x)

    def forward(self, h: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False):
        with spans.span("model.attn"):
            o, lat = self.attention(h, positions)
        with spans.span("model.ffn"):
            return self.finish(h, o), lat


class MLAMoELayer(MLALayer):
    """MLA and the mixture of experts (``moe``, a :class:`~.moe.MoE`):
    :meth:`finish` returns ``(h, aux)``, :meth:`forward` ``(h, latent,
    aux)``."""

    def _make_ffn(self, cfg, *, dtype, device) -> None:
        from .moe import MoE        # moe.py builds on layers.py
        self.moe = MoE(cfg, dtype=dtype, device=device)

    def finish(self, h: torch.Tensor, o: torch.Tensor):
        h, x = self._attn_residual(h, o)
        m, aux = self.moe(x)
        return h + m, aux

    def forward(self, h: torch.Tensor, positions: torch.Tensor, *,
                local: bool = False):
        with spans.span("model.attn"):
            o, lat = self.attention(h, positions)
        with spans.span("model.ffn"):
            h, aux = self.finish(h, o)
        return h, lat, aux


@torch.no_grad()
def fill_mla_layer(layer: MLALayer, generator: torch.Generator) -> None:
    """Initialize ``layer`` in place: N(0, 1/fan-in) for each projection,
    zeros for the norms (each scales by 1 + w), the MLP or the experts
    as :func:`~.layers.init_mlp` / :func:`~.moe.fill_moe`."""
    cfg = layer.cfg
    for p in layer.parameters(recurse=False):
        p.zero_()
    for w, fan_in in ((layer.wq_a, cfg.d_model),
                      (layer.wq_b, cfg.q_lora_rank),
                      (layer.wkv_a, cfg.d_model),
                      (layer.wkv_b, cfg.kv_lora_rank),
                      (layer.wo, cfg.n_heads * cfg.v_head_dim)):
        _normal_(w, 1.0 / math.sqrt(fan_in), generator)
    if isinstance(layer, MLAMoELayer):
        from .moe import fill_moe
        fill_moe(layer.moe, generator)
    else:
        _fill_mlp(layer.mlp, generator)
