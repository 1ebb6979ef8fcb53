"""Plain float32 reference of the mixtral family as the program serves
it: RMSNorm with (1 + w), rotary embeddings, causal grouped-query
attention, and a mixture of experts routed in float32 (softmax, top-k,
the top-k gates renormalised), each expert ``silu(x·w1) ⊙ (x·w3) · w2``.

Capacity, as the configuration states it: a prompt is padded with token
0 to its bucket (the smallest power of two, at least
``prefill_bucket_min``, that holds it) and each chunk of
``moe_seq_chunk`` positions gives every expert ``C = max(k, ⌈c·k/E·
capacity_factor⌉)`` slots, filled slot-major (every position's first
choice in order, then every position's second); a choice past C is
dropped and its gate is not given to another expert.  A decoded token
is alone in its chunk, so none of its choices is dropped.

:func:`served_logits` runs each prompt and its served tokens layer by
layer, drawing each layer's weights again from the seed
(:mod:`bench.weights`), so that it needs one layer in float32 at a time.
Imports neither ``jax`` nor the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..weights import Leaf, draw
from .common import Linear, f32_exact, rmsnorm, rope

__all__ = ["groups", "bucket", "served_logits"]

_NORM_STD = 0.05


def groups(d) -> list[list[Leaf]]:
    """The weights: the embedding, one group a layer, the head; scales
    as the program's init (N(0, 1/fan-in)), the norms' w ~ N(0, 0.05²)."""
    dm, H, KV, D, ff, E = (d.d_model, d.n_heads, d.kv_heads, d.head_dim,
                           d.d_ff, d.n_experts)
    bf, V = d.dtype, d.padded_vocab()
    out = [[Leaf("embed", (V, dm), bf, ("normal", 0.0, 1 / math.sqrt(dm)))]]
    for i in range(d.n_layers):
        p = f"layers.{i}."
        s = 1 / math.sqrt(dm)
        out.append([
            Leaf(p + "ln1", (dm,), bf, ("normal", 0.0, _NORM_STD)),
            Leaf(p + "wq", (dm, H * D), bf, ("normal", 0.0, s)),
            Leaf(p + "wk", (dm, KV * D), bf, ("normal", 0.0, s)),
            Leaf(p + "wv", (dm, KV * D), bf, ("normal", 0.0, s)),
            Leaf(p + "wo", (H * D, dm), bf,
                 ("normal", 0.0, 1 / math.sqrt(H * D))),
            Leaf(p + "ln2", (dm,), bf, ("normal", 0.0, _NORM_STD)),
            Leaf(p + "moe.router", (dm, E), "float32", ("normal", 0.0, s)),
            Leaf(p + "moe.w1", (E, dm, ff), bf, ("normal", 0.0, s)),
            Leaf(p + "moe.w2", (E, ff, dm), bf,
                 ("normal", 0.0, 1 / math.sqrt(ff))),
            Leaf(p + "moe.w3", (E, dm, ff), bf, ("normal", 0.0, s)),
        ])
    head = [Leaf("final_ln", (dm,), bf, ("normal", 0.0, _NORM_STD))]
    if not d.tie_embeddings:
        head.append(Leaf("lm_head", (dm, V), bf,
                         ("normal", 0.0, 1 / math.sqrt(dm))))
    out.append(head)
    return out


def bucket(d, n: int) -> int:
    """The padded length a prompt of ``n`` tokens is prefilled at."""
    return max(int(d.program.get("prefill_bucket_min", 16)),
               1 << (n - 1).bit_length())


def _f32(w: dict) -> dict:
    return {k.rsplit(".", 1)[-1] if "moe." not in k
            else "moe." + k.rsplit(".", 1)[-1]: v.float()
            for k, v in w.items()}


def _attend(q, k, v, qpos, kpos, D):
    """Causal GQA: q (Sq, H, D), k and v (Sk, KV, D), each query seeing
    the keys at positions ≤ its own."""
    Sq, H, _ = q.shape
    KV = k.shape[1]
    qg = q.reshape(Sq, KV, H // KV, D)
    s = torch.einsum("qkgd,skd->kgqs", qg, k) / math.sqrt(D)
    s = s.masked_fill((kpos[None, :] > qpos[:, None])[None, None], -math.inf)
    o = torch.einsum("kgqs,skd->qkgd", torch.softmax(s, dim=-1), v)
    return o.reshape(Sq, H * D)


def _keep(gi: torch.Tensor, d) -> torch.Tensor:
    """Which (position, choice) pairs the capacity keeps, for a padded
    prompt's routing ``gi`` (S, k)."""
    S, k = gi.shape
    E = d.n_experts
    chunk = d.moe_seq_chunk if 0 < d.moe_seq_chunk < S else S
    if S % chunk:
        raise ValueError(f"a prompt bucket of {S} is not a whole number "
                         f"of {chunk}-position chunks")
    keep = torch.ones_like(gi, dtype=torch.bool)
    C = max(k, int(math.ceil(chunk * k / E * d.capacity_factor)))
    rows = torch.arange(chunk, device=gi.device)
    for c0 in range(0, S, chunk):
        fill = torch.zeros(E, dtype=torch.long, device=gi.device)
        for s in range(k):
            e = gi[c0:c0 + chunk, s]
            hot = F.one_hot(e, E)
            rank = (fill[None, :] + torch.cumsum(hot, 0) - hot)[rows, e]
            keep[c0:c0 + chunk, s] = rank < C
            fill = fill + hot.sum(0)
    return keep


def _moe(x, W, d, lin, capacity: bool):
    probs = torch.softmax(x @ W["moe.router"], dim=-1)
    gv, gi = torch.topk(probs, d.top_k, dim=-1)
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    keep = _keep(gi, d) if capacity else torch.ones_like(gi, dtype=torch.bool)
    out = torch.zeros_like(x)
    for e in range(d.n_experts):
        sel = (gi == e) & keep
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = lin(F.silu(lin(xe, W["moe.w1"][e])) * lin(xe, W["moe.w3"][e]),
                W["moe.w2"][e])
        out.index_add_(0, rows, (gv * sel).sum(-1)[rows, None] * y)
    return out


def _qkv(x, W, d, lin, pos):
    S = x.shape[0]
    q = rope(lin(x, W["wq"]).view(S, d.n_heads, d.head_dim), pos,
             d.rope_theta)
    k = rope(lin(x, W["wk"]).view(S, d.kv_heads, d.head_dim), pos,
             d.rope_theta)
    return q, k, lin(x, W["wv"]).view(S, d.kv_heads, d.head_dim)


def _layer(W, d, lin, seq):
    """One layer over one sequence's padded prompt and its decoded
    positions, in place in ``seq``."""
    hp, hs, L = seq["hp"], seq["hs"], seq["L"]
    P = hp.shape[0]
    ppos = torch.arange(P, device=hp.device)
    x = rmsnorm(hp, W["ln1"], d.norm_eps)
    q, k, v = _qkv(x, W, d, lin, ppos)
    hp = hp + lin(_attend(q, k, v, ppos, ppos, d.head_dim), W["wo"])
    kp, vp = k[:L], v[:L]
    hp = hp + _moe(rmsnorm(hp, W["ln2"], d.norm_eps), W, d, lin, True)
    if hs.shape[0]:
        spos = torch.arange(L, L + hs.shape[0], device=hs.device)
        x = rmsnorm(hs, W["ln1"], d.norm_eps)
        q, k, v = _qkv(x, W, d, lin, spos)
        kpos = torch.cat([ppos[:L], spos])
        o = _attend(q, torch.cat([kp, k]), torch.cat([vp, v]), spos, kpos,
                    d.head_dim)
        hs = hs + lin(o, W["wo"])
        hs = hs + _moe(rmsnorm(hs, W["ln2"], d.norm_eps), W, d, lin, False)
    seq["hp"], seq["hs"] = hp, hs


@torch.no_grad()
def served_logits(d, seed: int, device, requests: list[dict],
                  precision: str = "f32") -> list[torch.Tensor]:
    """The logits, at each served token's position, of the model run
    plainly over ``requests`` (each ``{"prompt": [...], "served":
    [...]}``): (len(served), vocab) float32 each, on ``device``."""
    if d.window is not None:
        raise NotImplementedError("the reference attends over the whole "
                                  "context: a sliding window is not written")
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
