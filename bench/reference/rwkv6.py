"""Plain float32 reference of the RWKV-6 family as the program runs it.

Per layer: RMSNorm with (1 + w); token shift; a data-dependent lerp for
each of r, k, v, w, g (``x + (x₋₁ − x)·(μ + tanh((x + (x₋₁ − x)·μ)·A)·B)``);
r, k, v and ``silu(g)`` by their projections; the decay ``w =
exp(−exp(w0 + tanh(x_w·A_w)·B_w))``; per 64-wide head the WKV

    y_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t),   S_t = diag(w_t) S_{t−1} + k_tᵀ v_t,

a head-wise normalisation (population variance, ε = 64e-5) with its
weight and bias, ``(y ⊙ silu(g))·W_o`` added to the residual; then the
channel mix ``σ((x_c + (x_c₋₁ − x_c)·μ_r)·W_r) ⊙ (relu((x_c + (x_c₋₁ −
x_c)·μ_k)·W_k)²·W_v)``.  The WKV is taken in chunks of 16 positions, the
decay between two positions of a chunk as ``exp`` of a difference of
summed log-decays (never above 1), the state carried from chunk to
chunk.

:func:`train_steps` follows the train step
(cross-entropy, its gradients by autograd, the global-norm clip and
AdamW, all in float32) for a few steps.  Imports neither ``jax`` nor the
program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..weights import DTYPES, Leaf, draw
from .common import Linear, f32_exact, rmsnorm

__all__ = ["groups", "forward", "train_steps", "wkv"]

N = 64              # head size
#: the LoRA ranks of the five mixes and of the decay, as the program fixes
#: them; the published 7B model's are 64 and 128
_LORA, _LORA_W = 32, 64
_GN_EPS = 64e-5
_MIXES = ("r", "k", "v", "w", "g")
_CHUNK = 16
_SMALL = 0.05


def groups(d) -> list[list[Leaf]]:
    """The weights: the embedding, one group a layer, the head.  Scales
    as the program's init, the norms' w, μ − 0.5, the group norm's
    weight − 1 and bias ~ N(0, 0.05²); w0 evenly from −6 to −0.5."""
    dm, ff, bf = d.d_model, d.d_ff, d.dtype
    H, V, s = dm // N, d.padded_vocab(), 1 / math.sqrt(dm)
    out = [[Leaf("embed", (V, dm), bf, ("normal", 0.0, s))]]
    for i in range(d.n_layers):
        p = f"layers.{i}."
        g = [Leaf(p + "ln1", (dm,), bf, ("normal", 0.0, _SMALL)),
             Leaf(p + "ln2", (dm,), bf, ("normal", 0.0, _SMALL)),
             Leaf(p + "tm.u", (H, N), "float32", ("normal", 0.0, 0.1)),
             Leaf(p + "tm.w0", (dm,), "float32", ("linspace", -6.0, -0.5)),
             Leaf(p + "tm.a_w2", (dm, _LORA_W), bf, ("normal", 0.0, s)),
             Leaf(p + "tm.b_w2", (_LORA_W, dm), bf, ("normal", 0.0, 0.01)),
             Leaf(p + "tm.gn_w", (dm,), "float32", ("normal", 1.0, _SMALL)),
             Leaf(p + "tm.gn_b", (dm,), "float32", ("normal", 0.0, _SMALL))]
        for nm in _MIXES:
            g += [Leaf(p + f"tm.mu_{nm}", (dm,), bf, ("normal", 0.5, _SMALL)),
                  Leaf(p + f"tm.a_{nm}", (dm, _LORA), bf, ("normal", 0.0, s)),
                  Leaf(p + f"tm.b_{nm}", (_LORA, dm), bf,
                       ("normal", 0.0, 0.01))]
        g += [Leaf(p + f"tm.{nm}", (dm, dm), bf, ("normal", 0.0, s))
              for nm in ("wr", "wk", "wv", "wg", "wo")]
        g += [Leaf(p + "cm.mu_k", (dm,), bf, ("normal", 0.5, _SMALL)),
              Leaf(p + "cm.mu_r", (dm,), bf, ("normal", 0.5, _SMALL)),
              Leaf(p + "cm.wk", (dm, ff), bf, ("normal", 0.0, s)),
              Leaf(p + "cm.wv", (ff, dm), bf,
                   ("normal", 0.0, 1 / math.sqrt(ff))),
              Leaf(p + "cm.wr", (dm, dm), bf, ("normal", 0.0, s))]
        out.append(g)
    head = [Leaf("final_ln", (dm,), bf, ("normal", 0.0, _SMALL))]
    if not d.tie_embeddings:
        head.append(Leaf("lm_head", (dm, V), bf, ("normal", 0.0, s)))
    out.append(head)
    return out


def wkv(r, k, v, w, u):
    """The WKV over whole sequences from a zero state, float32.
    r, k, v, w: (B, H, S, N); u: (H, N).  Returns y (B, H, S, N)."""
    B, H, S, _ = r.shape
    pad = -S % _CHUNK
    if pad:
        z = r.new_zeros(B, H, pad, N)
        r, k, v = (torch.cat([t, z], 2) for t in (r, k, v))
        w = torch.cat([w, torch.ones_like(z)], 2)
    nc = r.shape[2] // _CHUNK
    r, k, v, w = (t.reshape(B, H, nc, _CHUNK, N) for t in (r, k, v, w))
    lw = torch.log(w.clamp(min=1e-38))
    a_in = torch.cumsum(lw, dim=3)            # Σ log w up to t, inclusive
    a_ex = a_in - lw                          # … up to t − 1
    t_idx = torch.arange(_CHUNK, device=r.device)
    before = (t_idx[None, :] < t_idx[:, None])[..., None]   # (t, τ, 1)
    expo = torch.where(before, a_ex[..., :, None, :] - a_in[..., None, :, :],
                       torch.full((), -math.inf, device=r.device))
    scores = torch.einsum("bhctn,bhctsn,bhcsn->bhcts", r, torch.exp(expo), k)
    y = scores @ v + (r * u[None, :, None, None, :] * k).sum(
        -1, keepdim=True) * v
    # the state at each chunk's start, carried in order
    to_end = torch.exp(a_in[..., -1:, :] - a_in)           # (b,h,c,τ,n)
    kv = torch.einsum("bhcsn,bhcsm->bhcnm", k * to_end, v)
    decay = torch.exp(a_in[..., -1, :])                     # (b,h,c,n)
    state = r.new_zeros(B, H, N, N)
    inter = []
    for c in range(nc):
        inter.append(torch.einsum("bhtn,bhnm->bhtm",
                                  r[:, :, c] * torch.exp(a_ex[:, :, c]),
                                  state))
        state = decay[:, :, c, :, None] * state + kv[:, :, c]
    y = y + torch.stack(inter, dim=2)
    return y.reshape(B, H, nc * _CHUNK, N)[:, :, :S]


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _block(W, x, d, lin):
    """One layer over x (B, S, d), float32."""
    B, S, dm = x.shape
    H = dm // N

    def heads(t):
        return t.reshape(B, S, H, N).transpose(1, 2)

    xt = rmsnorm(x, W["ln1"], d.norm_eps)
    xx = _shift(xt) - xt
    mixed = {nm: xt + xx * (W[f"tm.mu_{nm}"] + lin(torch.tanh(
        lin(xt + xx * W[f"tm.mu_{nm}"], W[f"tm.a_{nm}"])), W[f"tm.b_{nm}"]))
        for nm in _MIXES}
    r = heads(lin(mixed["r"], W["tm.wr"]))
    k = heads(lin(mixed["k"], W["tm.wk"]))
    v = heads(lin(mixed["v"], W["tm.wv"]))
    g = F.silu(lin(mixed["g"], W["tm.wg"]))
    logw = W["tm.w0"] + lin(torch.tanh(lin(mixed["w"], W["tm.a_w2"])),
                            W["tm.b_w2"])
    y = wkv(r, k, v, heads(torch.exp(-torch.exp(logw))), W["tm.u"])
    yh = y.transpose(1, 2)
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, unbiased=False, keepdim=True) + _GN_EPS)
    y = yh.reshape(B, S, dm) * W["tm.gn_w"] + W["tm.gn_b"]
    out = x + lin(y * g, W["tm.wo"])
    xc = rmsnorm(out, W["ln2"], d.norm_eps)
    xxc = _shift(xc) - xc
    kk = torch.square(torch.relu(lin(xc + xxc * W["cm.mu_k"], W["cm.wk"])))
    return out + torch.sigmoid(lin(xc + xxc * W["cm.mu_r"], W["cm.wr"])) \
        * lin(kk, W["cm.wv"])


def forward(params: dict, d, tokens: torch.Tensor, lin=None,
            remat: bool = True) -> torch.Tensor:
    """Logits (B, S, vocab) of the model with weights ``params`` (the
    program's names, float32) over ``tokens`` (B, S); each layer
    recomputed in the backward pass when ``remat``."""
    lin = lin or Linear("f32")
    h = params["embed"][tokens]
    for i in range(d.n_layers):
        W = {k.split(".", 2)[2]: v for k, v in params.items()
             if k.startswith(f"layers.{i}.")}
        if remat:
            h = checkpoint(_block, W, h, d, lin, use_reentrant=False)
        else:
            h = _block(W, h, d, lin)
    h = rmsnorm(h, params["final_ln"], d.norm_eps)
    out_w = params["embed"].T if d.tie_embeddings else params["lm_head"]
    return lin(h, out_w)[..., :d.vocab]


def lr_scale(step: int, job: dict) -> float:
    """The schedule's scale at ``step``: linear warm-up over
    ``warmup`` steps, then a cosine from 1 to ``floor`` at
    ``total_steps``."""
    warmup, total = job["warmup"], job["total_steps"]
    floor = job.get("lr_floor", 0.1)
    if step < warmup:
        return step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * frac))


def train_steps(d, seed: int, device, batches: list[torch.Tensor],
                job: dict, precision: str = "f32",
                positions: torch.Tensor | None = None) -> dict:
    """Follow the train step over ``batches`` (each (B, S + 1) tokens:
    inputs and next-token labels) from the seed's weights, in float32:
    the mean cross-entropy, its gradients, the clip of their global norm
    to ``clip_norm`` and AdamW, each updated weight stored in its stated
    dtype (bfloat16 weights round on store, as the configuration keeps
    no float32 copy).  Returns each step's loss, the first step's logits
    at the flat positions ``positions`` (b · S + s) where given, each
    leaf's first clipped gradient's norm and each leaf's change over all
    the steps, by the program's parameter names."""
    lin = Linear(precision)
    gs = groups(d)
    stored = {leaf.name: DTYPES[leaf.dtype] for g in gs for leaf in g}
    b1, b2, eps = job["b1"], job["b2"], job["eps"]
    lr, wd = job["lr"], job["weight_decay"]
    with f32_exact():
        params = {}
        for g, leaves in enumerate(gs):
            params.update({k: v.float().requires_grad_(True) for k, v in
                           draw(leaves, seed, g, device).items()})
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        s2 = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, first, sample = [], None, None
        for t, batch in enumerate(batches):
            logits = forward(params, d, batch[:, :-1], lin)
            if t == 0 and positions is not None:
                sample = logits.detach().reshape(-1, logits.shape[-1])[
                    positions.to(logits.device)].clone()
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   batch[:, 1:].reshape(-1))
            grads = torch.autograd.grad(loss, list(params.values()))
            del logits
            losses.append(float(loss.detach()))
            with torch.no_grad():
                grads = dict(zip(params, grads))
                norm = torch.sqrt(sum(torch.sum(g * g)
                                      for g in grads.values()))
                scale = min(1.0, job["clip_norm"] / max(float(norm), 1e-9))
                for g in grads.values():
                    g.mul_(scale)
                if first is None:
                    first = {k: float(torch.linalg.vector_norm(g))
                             for k, g in grads.items()}
                step_lr = lr * lr_scale(job.get("start_step", 0) + t, job)
                c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
                for k, p in params.items():
                    g = grads[k]
                    m[k].mul_(b1).add_((1 - b1) * g)
                    s2[k].mul_(b2).add_((1 - b2) * g * g)
                    upd = (m[k] / c1) / (torch.sqrt(s2[k] / c2) + eps) \
                        + wd * p
                    # stored in the leaf's stated dtype, as the step is
                    p.copy_((p - step_lr * upd).to(stored[k]).float())
                del grads
        change = {}
        for g, leaves in enumerate(gs):
            for k, v in draw(leaves, seed, g, device).items():
                change[k] = float(torch.linalg.vector_norm(
                    params[k].detach() - v.float()))
    return {"losses": losses, "sample_logits": sample,
            "first_grad_norms": first, "change_norms": change}
