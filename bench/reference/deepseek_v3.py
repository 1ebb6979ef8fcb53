"""Plain float32 reference of DeepSeek-V3 as the program serves it, with
no cache: RMSNorm with (1 + w); multi-head latent attention with every
head's keys and values materialised, its rope dims rotated in pairs
(2i, 2i+1) at YaRN's frequencies, its scores scaled by YaRN's factor
squared; the first ``first_k_dense_replace`` layers a dense SiLU-gated
MLP; the others a mixture of experts routed in float32 (sigmoid scores;
the choice by scores plus a bias within the best ``topk_group`` of
``n_group`` groups, a group scored by its two best; gates the scores
renormalised × ``routed_scaling_factor``) and a shared expert.

The experts held are the program's share (``experts_held`` from
``expert_first`` of ``n_experts``): a token's choices of experts held
elsewhere add nothing, as on one chip of the expert-parallel deployment.
A prompt is padded with token 0 to its bucket (the smallest power of
two, at least ``prefill_bucket_min``, that holds it), as the program
prefills it; no choice is dropped, so the pads change no real
position's result.

:func:`served_logits` runs each prompt and its served tokens layer by
layer, drawing each layer's weights again from the seed
(:mod:`bench.weights`).  Written from the published equations
(arXiv:2412.19437; ``modeling_deepseek.py``); imports neither ``jax``
nor the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..weights import Leaf, draw
from .common import Linear, f32_exact, rmsnorm

__all__ = ["groups", "bucket", "served_logits", "sizes", "inv_freq",
           "softmax_scale", "route"]

_NORM_STD = 0.05
#: std of the router's ``e_score_correction_bias``: learned in the
#: published model, drawn here so that a path without it is seen
BIAS_STD = 0.05
#: float32 scores one attention holds at once (head chunks)
_SCORES = 1 << 26


def sizes(d) -> dict:
    """The sizes of the configuration that :class:`bench.model.Dims`
    leaves in ``program``."""
    p = d.program
    return {k: p[k] for k in (
        "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "moe_intermediate_size", "first_k_dense_replace",
        "n_shared_experts", "n_group", "topk_group", "routed_scaling_factor",
        "experts_held", "expert_first", "yarn_factor",
        "yarn_original_max_position_embeddings", "yarn_beta_fast",
        "yarn_beta_slow", "yarn_mscale", "yarn_mscale_all_dim")}


def groups(d) -> list[list[Leaf]]:
    """The weights: the embedding, one group a layer, the head; scales
    N(0, 1/fan-in), the norms' w and the router's bias N(0, 0.05²)."""
    s = sizes(d)
    dm, H, V, bf = d.d_model, d.n_heads, d.padded_vocab(), d.dtype
    r, qr = s["kv_lora_rank"], s["q_lora_rank"]
    dn, dr, dv = (s["qk_nope_head_dim"], s["qk_rope_head_dim"],
                  s["v_head_dim"])
    ff, E, Eh = s["moe_intermediate_size"], d.n_experts, s["experts_held"]
    fs = ff * s["n_shared_experts"]

    def n(name, shape, fan_in, dtype=bf):
        return Leaf(name, shape, dtype, ("normal", 0.0, 1 / math.sqrt(fan_in)))

    def norm(name, width):
        return Leaf(name, (width,), bf, ("normal", 0.0, _NORM_STD))

    out = [[n("embed", (V, dm), dm)]]
    for i in range(d.n_layers):
        p = f"layers.{i}."
        g = [norm(p + "ln1", dm), n(p + "wq_a", (dm, qr), dm),
             norm(p + "q_norm", qr), n(p + "wq_b", (qr, H * (dn + dr)), qr),
             n(p + "wkv_a", (dm, r + dr), dm), norm(p + "kv_norm", r),
             n(p + "wkv_b", (H * (dn + dv), r), r),
             n(p + "wo", (H * dv, dm), H * dv), norm(p + "ln2", dm)]
        if i < s["first_k_dense_replace"]:
            g += [n(p + "mlp.w1", (dm, d.d_ff), dm),
                  n(p + "mlp.w2", (d.d_ff, dm), d.d_ff),
                  n(p + "mlp.w3", (dm, d.d_ff), dm)]
        else:
            g += [n(p + "moe.router", (dm, E), dm, "float32"),
                  Leaf(p + "moe.bias", (E,), "float32",
                       ("normal", 0.0, BIAS_STD)),
                  n(p + "moe.w1", (Eh, dm, ff), dm),
                  n(p + "moe.w2", (Eh, ff, dm), ff),
                  n(p + "moe.w3", (Eh, dm, ff), dm),
                  n(p + "moe.shared.w1", (dm, fs), dm),
                  n(p + "moe.shared.w2", (fs, dm), fs),
                  n(p + "moe.shared.w3", (dm, fs), dm)]
        out.append(g)
    head = [norm("final_ln", dm)]
    if not d.tie_embeddings:
        head.append(n("lm_head", (dm, V), dm))
    out.append(head)
    return out


def bucket(d, n: int) -> int:
    """The padded length a prompt of ``n`` tokens is prefilled at."""
    return max(int(d.program.get("prefill_bucket_min", 16)),
               1 << (n - 1).bit_length())


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(d) -> torch.Tensor:
    """YaRN's frequencies of the rope dims (float32): the original ones
    for the dims that turn more than ``beta_fast`` times over the
    original context, those ÷ factor for the dims that turn fewer than
    ``beta_slow`` times, a linear blend between."""
    s = sizes(d)
    dim, base, f = s["qk_rope_head_dim"], d.rope_theta, s["yarn_factor"]
    orig = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    if f <= 1:
        return orig

    def turn(rot):      # the dim that turns ``rot`` times over the context
        return dim * math.log(s["yarn_original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(base))
    lo = max(math.floor(turn(s["yarn_beta_fast"])), 0)
    hi = min(math.ceil(turn(s["yarn_beta_slow"])), dim - 1)
    hi = hi + 0.001 if lo == hi else hi
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - lo)
            / (hi - lo)).clamp(0, 1)
    return orig / f * ramp + orig * (1 - ramp)


def softmax_scale(d) -> float:
    s = sizes(d)
    scale = (s["qk_nope_head_dim"] + s["qk_rope_head_dim"]) ** -0.5
    if s["yarn_mscale_all_dim"]:
        scale *= _mscale(s["yarn_factor"], s["yarn_mscale_all_dim"]) ** 2
    return scale


def _rope(x: torch.Tensor, pos: torch.Tensor, d) -> torch.Tensor:
    """x (S, heads, D): each pair (2i, 2i+1) turned by pos·inv_freq[i]
    (cos and sin × YaRN's mscale / mscale_all_dim, 1 as published),
    written back as halves [x_2i…; x_2i+1…], the published layout."""
    s = sizes(d)
    m = _mscale(s["yarn_factor"], s["yarn_mscale"]) \
        / _mscale(s["yarn_factor"], s["yarn_mscale_all_dim"])
    ang = pos.float()[:, None] * inv_freq(d).to(x.device)
    cos, sin = (torch.cos(ang) * m)[:, None], (torch.sin(ang) * m)[:, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], -1)


def _f32(w: dict) -> dict:
    return {k.split(".", 2)[2] if k.startswith("layers.") else k: v.float()
            for k, v in w.items()}


def _mla_in(x, W, d, lin, pos):
    """A sequence's queries (S, H, nope + rope), and per position the
    keys and values of every head (S, H, nope + rope), (S, H, v)."""
    s = sizes(d)
    H, dn = d.n_heads, s["qk_nope_head_dim"]
    S = x.shape[0]
    cq = rmsnorm(lin(x, W["wq_a"]), W["q_norm"], d.norm_eps)
    q = lin(cq, W["wq_b"]).view(S, H, -1)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, d)], -1)
    a = lin(x, W["wkv_a"])
    ckv = rmsnorm(a[:, :s["kv_lora_rank"]], W["kv_norm"], d.norm_eps)
    kpe = _rope(a[:, None, s["kv_lora_rank"]:], pos, d)
    kv = lin(ckv, W["wkv_b"].T).view(S, H, -1)
    k = torch.cat([kv[..., :dn], kpe.expand(S, H, -1)], -1)
    return q, k, kv[..., dn:]


def _attend(q, k, v, qpos, kpos, scale):
    """Causal attention, every head on its own keys: q (Sq, H, Dk), k
    (Sk, H, Dk), v (Sk, H, Dv) → (Sq, H·Dv)."""
    Sq, H, _ = q.shape
    mask = kpos[None, :] > qpos[:, None]
    hc = max(1, min(H, _SCORES // (Sq * k.shape[0])))
    out = []
    for h in range(0, H, hc):
        sc = torch.einsum("qhd,khd->hqk", q[:, h:h + hc], k[:, h:h + hc])
        p = torch.softmax((sc * scale).masked_fill(mask, -math.inf), -1)
        out.append(torch.einsum("hqk,khd->qhd", p, v[:, h:h + hc]))
    return torch.cat(out, 1).reshape(Sq, -1)


def route(x, router, bias, d):
    """The chosen experts (S, top_k) of all ``n_experts`` and their
    gates, float32, as the published ``MoEGate`` (noaux_tc): experts of
    the groups not kept are put to 0 before the top-k."""
    s = sizes(d)
    scores = torch.sigmoid(x @ router)
    choice = (scores + bias).view(x.shape[0], s["n_group"], -1)
    group = choice.topk(2, dim=-1).values.sum(-1)
    keep = torch.zeros_like(group).scatter_(
        1, group.topk(s["topk_group"], dim=-1).indices, 1.0)
    choice = (choice * keep[..., None]).flatten(1)
    idx = choice.topk(d.top_k, dim=-1).indices
    g = scores.gather(1, idx)
    return idx, g / (g.sum(-1, keepdim=True) + 1e-20) \
        * s["routed_scaling_factor"]


def _mlp(x, w1, w2, w3, lin):
    return lin(F.silu(lin(x, w1)) * lin(x, w3), w2)


def _moe(x, W, d, lin):
    s = sizes(d)
    idx, g = route(x, W["moe.router"], W["moe.bias"], d)
    out = _mlp(x, W["moe.shared.w1"], W["moe.shared.w2"],
               W["moe.shared.w3"], lin)
    for e in range(s["experts_held"]):
        sel = idx == s["expert_first"] + e
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel():
            y = _mlp(x[rows], W["moe.w1"][e], W["moe.w2"][e],
                     W["moe.w3"][e], lin)
            out.index_add_(0, rows, (g * sel).sum(-1)[rows, None] * y)
    return out


def _ffn(x, W, d, lin):
    if "mlp.w1" in W:
        return _mlp(x, W["mlp.w1"], W["mlp.w2"], W["mlp.w3"], lin)
    return _moe(x, W, d, lin)


def _layer(W, d, lin, seq):
    """One layer over one sequence's padded prompt and its decoded
    positions, in place in ``seq``."""
    hp, hs, L = seq["hp"], seq["hs"], seq["L"]
    scale = softmax_scale(d)
    ppos = torch.arange(hp.shape[0], device=hp.device)
    q, k, v = _mla_in(rmsnorm(hp, W["ln1"], d.norm_eps), W, d, lin, ppos)
    hp = hp + lin(_attend(q, k, v, ppos, ppos, scale), W["wo"])
    hp = hp + _ffn(rmsnorm(hp, W["ln2"], d.norm_eps), W, d, lin)
    if hs.shape[0]:
        spos = torch.arange(L, L + hs.shape[0], device=hs.device)
        qs, ks, vs = _mla_in(rmsnorm(hs, W["ln1"], d.norm_eps), W, d, lin,
                             spos)
        o = _attend(qs, torch.cat([k[:L], ks]), torch.cat([v[:L], vs]),
                    spos, torch.cat([ppos[:L], spos]), scale)
        hs = hs + lin(o, W["wo"])
        hs = hs + _ffn(rmsnorm(hs, W["ln2"], d.norm_eps), W, d, lin)
    seq["hp"], seq["hs"] = hp, hs


@torch.no_grad()
def served_logits(d, seed: int, device, requests: list[dict],
                  precision: str = "f32") -> list[torch.Tensor]:
    """The logits, at each served token's position, of the model run
    plainly over ``requests`` (each ``{"prompt": [...], "served":
    [...]}``): (len(served), vocab) float32 each, on ``device``."""
    if d.window is not None:
        raise NotImplementedError("DeepSeek-V3 attends over the whole "
                                  "context: no window")
    lin = Linear(precision)
    gs = groups(d)
    with f32_exact():
        emb = draw(gs[0], seed, 0, device)["embed"]
        seqs = []
        for r in requests:
            L, served = len(r["prompt"]), r["served"]
            P = bucket(d, L)
            toks = torch.tensor(r["prompt"] + [0] * (P - L), device=device)
            dec = torch.tensor(served[:-1], dtype=torch.long, device=device)
            seqs.append({"L": L, "hp": emb[toks].float(),
                         "hs": emb[dec].float()})
        del emb
        for i in range(d.n_layers):
            W = _f32(draw(gs[1 + i], seed, 1 + i, device))
            for seq in seqs:
                _layer(W, d, lin, seq)
            del W
        head = draw(gs[-1], seed, len(gs) - 1, device)
        if d.tie_embeddings:
            out_w = draw(gs[0], seed, 0, device)["embed"].float().T
        else:
            out_w = head["lm_head"].float()
        out = []
        for seq in seqs:
            h = torch.cat([seq["hp"][seq["L"] - 1:seq["L"]], seq["hs"]])
            h = rmsnorm(h, head["final_ln"].float(), d.norm_eps)
            out.append(lin(h, out_w)[:, :d.vocab])
        return out
