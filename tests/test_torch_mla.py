"""DeepSeek-V3 in the port (latent attention, the sigmoid router, the
experts held) against the benchmark's plain float32 reference
(``bench/reference/deepseek_v3.py``), at a small size on the CPU.

The program runs in float32 with the benchmark's weights for a seed
(the router's bias and the norms drawn nonzero).  Tolerances, wider
than mixtral's 3e-6 on logits, each for its reason: the full forward at
2e-5, because its attention is K1's plain version over q and k padded
to 256 with q scaled by scale·16, summed in another order than the
reference's (readings 4.3e-6 to 6.4e-6 over 7 seeds, on logits of
magnitude 4); the prefill followed by decode steps at 3e-5, because the
absorbed decode sums the latent products in another order again
(readings 2.5e-6 to 9.3e-6 over 7 seeds and 10 steps); an expert-parallel
share's sum at 1e-5 (sums of four partial layers).  Each planted fault
moves the logits by more than 1e-2.  Mixtral's expert layer is held bit
for bit to its dispatch as written before the held-expert path.
"""

import math
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import program, spec  # noqa: E402
from bench.model import dims  # noqa: E402
from bench.reference import deepseek_v3 as ref  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.models import (MLAConfig, decode_step, forward,  # noqa: E402
                                init_cache, init_params, prefill)
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving.engine import _scatter_cache  # noqa: E402
from repro_torch.trace import spans  # noqa: E402

FWD_TOL = 2e-5
DECODE_TOL = 3e-5
FAULT = 1e-2
#: a small DeepSeek-V3 in float32 (the published keys the benchmark
#: maps, and the program's own): one dense and two MoE layers, 32
#: experts in 4 groups, 2 kept, top-4, experts 8-15 held
PROGRAM = {"n_experts": 32, "experts_held": 8, "expert_first": 8,
           "kv_lora_rank": 32, "q_lora_rank": 48, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16,
           "moe_intermediate_size": 48, "first_k_dense_replace": 1,
           "n_shared_experts": 1, "n_group": 4, "topk_group": 2,
           "routed_scaling_factor": 2.5, "yarn_factor": 40,
           "yarn_original_max_position_embeddings": 4096,
           "yarn_beta_fast": 32, "yarn_beta_slow": 1, "yarn_mscale": 1,
           "yarn_mscale_all_dim": 1, "prefill_bucket_min": 16,
           "param_dtype": "float32", "dtype": "float32",
           "cache_dtype": "float32"}
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=96, num_experts_per_tok=4, vocab_size=512,
             num_hidden_layers=3, torch_dtype="float32", program=PROGRAM)
CONFIG = spec.load_cell("deepseek-v3.chat").config


@pytest.fixture(autouse=True)
def _two_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _model(seed):
    d = dims(CONFIG, **SMALL)
    cfg, model = program.build_model(d, CONFIG, seed, "cpu")
    return d, cfg, model


def _tokens(seed, n, vocab):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (n,), generator=g).tolist()


def _ref(d, seed, prompt, served):
    """The reference's logits at the prompt's last position and at each
    of ``served`` but the last (as a served request's are read)."""
    return ref.served_logits(d, seed, "cpu", [
        {"prompt": prompt, "served": served}])[0]


# -- the arch ------------------------------------------------------------------


def test_the_arch_resolves_outside_the_shared_tables():
    cfg = get_config("deepseek-v3")
    assert isinstance(cfg, MLAConfig)
    assert "deepseek-v3" not in ARCH_IDS
    assert (cfg.n_layers, cfg.n_experts, cfg.n_held, cfg.expert_width,
            cfg.d_ff) == (61, 256, 8, 2048, 18432)
    kinds = cfg.layer_kinds()
    assert [k.value for k in kinds[:4]] == ["attn", "attn", "attn", "moe"]
    assert isinstance(get_smoke_config("deepseek-v3"), MLAConfig)


# -- against the reference -----------------------------------------------------


@pytest.mark.parametrize("seed", [2**31 + 1, 11])
def test_forward_matches_reference(seed):
    d, cfg, model = _model(seed)
    toks = _tokens(seed, 40, d.vocab)
    logits, aux = forward(model, torch.tensor([toks]), cfg)
    want = _ref(d, seed, toks[:20], toks[20:] + [0])
    assert float(aux) == 0.0
    err = (logits[0, 19:] - want).abs().max()
    assert err < FWD_TOL, err
    assert want.abs().max() > 1.0      # logits of a real spread


@pytest.mark.parametrize("seed", [2**31 + 3, 12])
def test_bucketed_prefill_then_decode_matches_reference(seed):
    """Two requests prefilled alone, each padded to its bucket, their
    latent caches scattered into a batch of 2 slots, then decoded
    together at their own positions."""
    d, cfg, model = _model(seed)
    prompts = [_tokens(seed, 13, d.vocab), _tokens(seed + 1, 21, d.vocab)]
    served = [_tokens(seed + 2, 9, d.vocab), _tokens(seed + 3, 9, d.vocab)]
    cache = init_cache(cfg, 2, 64, device="cpu")
    assert set(cache[0]) == {"latent"}
    assert cache[0]["latent"].shape == (2, 64, 32 + 8)
    got = [[], []]
    for s, p in enumerate(prompts):
        bucket = ref.bucket(d, len(p))
        logits, c1 = prefill(model, torch.tensor([p + [0] * (bucket - len(p))]),
                             cfg, max_len=64, return_all_logits=True,
                             length=len(p))
        got[s].append(logits[0, len(p) - 1])
        cache = _scatter_cache(cache, c1, s)
    pos = torch.tensor([len(p) for p in prompts])
    for t in range(len(served[0]) - 1):
        tok = torch.tensor([served[0][t], served[1][t]])
        logits, cache = decode_step(model, tok, pos, cache, cfg)
        for s in range(2):
            got[s].append(logits[s])
        pos = pos + 1
    for s in range(2):
        want = _ref(d, seed, prompts[s], served[s])
        err = (torch.stack(got[s]) - want).abs().max()
        assert err < DECODE_TOL, (s, err)


def test_the_engine_serves_the_smoke_config():
    """The serving engine over the latent cache: every request served to
    its end, each token the greedy choice of a full forward pass."""
    cfg = get_smoke_config("deepseek-v3").replace(
        param_dtype="float32", dtype="float32", cache_dtype="float32")
    model = init_params(cfg, device="cpu", seed=5)
    engine = ServingEngine(cfg, model, max_batch=2, max_len=64, device="cpu")
    assert set(engine.cache[1]) == {"latent"}
    reqs = [engine.submit(Request(prompt=_tokens(i, n, cfg.vocab),
                                  max_new_tokens=6))
            for i, n in enumerate((5, 17, 9))]
    engine.run_until_drained()
    for r in reqs:
        assert r.done and len(r.output) == 6
        seq = torch.tensor([r.prompt + r.output[:-1]])
        logits = forward(model, seq, cfg)[0][0, len(r.prompt) - 1:]
        assert logits[:, :cfg.vocab].argmax(-1).tolist() == r.output


# -- YaRN and the rope ---------------------------------------------------------


def _published_inv_freq(dim, base, factor, orig, beta_fast, beta_slow):
    """``DeepseekV3YarnRotaryEmbedding._set_cos_sin_cache``'s frequencies,
    as the published modeling code writes them."""
    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(base))
    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2,
                                                  dtype=torch.float32) / dim))
    return inter * (1 - mask) + extra * mask, (low, high)


def test_yarn_frequencies_and_scale_are_the_published():
    cfg = get_config("deepseek-v3")
    want, (low, high) = _published_inv_freq(64, 10000.0, 40.0, 4096, 32, 1)
    got = mla.yarn_inv_freq(cfg)
    assert torch.equal(got, want)
    assert (low, high) == (10, 23)
    orig = 1.0 / 10000.0 ** (torch.arange(0, 64, 2) / 64)
    assert torch.allclose(got[:10], orig[:10], rtol=1e-6)
    assert torch.allclose(got[23:], orig[23:] / 40, rtol=1e-6)
    d = dims(CONFIG)
    assert torch.allclose(ref.inv_freq(d), want, rtol=1e-6)
    scale = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert mla.softmax_scale(cfg) == pytest.approx(scale, rel=1e-12)
    assert ref.softmax_scale(d) == pytest.approx(scale, rel=1e-12)
    assert scale == pytest.approx(0.13523, abs=1e-5)
    # cos and sin unscaled: mscale / mscale_all_dim = 1
    layer = mla.MLALayer(get_smoke_config("deepseek-v3"),
                         dtype=torch.float32, device="meta")
    assert layer._rope_mscale == 1.0


def test_rope_turns_the_pairs_2i_2i_plus_1():
    """Each pair (x_2i, x_2i+1) turned as the complex number x_2i +
    i·x_2i+1 times exp(i·pos·f_i), in its place; its products with
    another such vector are those of the published layout (halves)."""
    cfg = get_smoke_config("deepseek-v3").replace(qk_rope_head_dim=8)
    layer = mla.MLALayer(cfg, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, y = (torch.randn(5, 3, 8, generator=g) for _ in range(2))
    pos = torch.arange(5) * 7
    f = mla.yarn_inv_freq(cfg).double()
    turn = torch.polar(torch.ones(5, 1, 4, dtype=torch.float64),
                       pos[:, None, None] * f)
    z = torch.complex(x[..., 0::2].double(), x[..., 1::2].double()) * turn
    want = torch.stack([z.real, z.imag], -1).flatten(-2)
    got = mla.rope_pairs(x, layer.rotation(pos))
    assert torch.allclose(got.double(), want, atol=1e-5)
    # the published layout: halves [evens; odds], rotated half to half
    d = dims(CONFIG, num_hidden_layers=1, program={
        **PROGRAM, "qk_rope_head_dim": 8})
    halves = ref._rope(x, pos, d), ref._rope(y, pos, d)
    dots = (mla.rope_pairs(x, layer.rotation(pos))
            * mla.rope_pairs(y, layer.rotation(pos))).sum(-1)
    assert torch.allclose(dots, (halves[0] * halves[1]).sum(-1),
                          atol=1e-5)


# -- routing -------------------------------------------------------------------


def _router_case(bias):
    """8 experts in 4 groups of 2, 2 groups kept, top-2, scaling 2.5;
    one token whose sigmoid scores are ``s``."""
    cfg = get_smoke_config("deepseek-v3").replace(
        d_model=8, n_experts=8, n_group=4, topk_group=2, top_k=2,
        routed_scaling_factor=2.5)
    s = torch.tensor([0.95, 0.01, 0.62, 0.60, 0.55, 0.55, 0.50, 0.50])
    router = torch.zeros(8, 8)
    router[0] = torch.log(s / (1 - s))
    x = torch.zeros(1, 8)
    x[0, 0] = 1.0
    p = {"router": router, "bias": torch.tensor(bias)}
    return cfg, x, p, s


def _routes(cfg, x, p):
    """The program's and the reference's choices (sorted) and gates."""
    out = []
    for idx, g in (moe.route_sigmoid(x, p, cfg),
                   ref.route(x, p["router"], p["bias"], dims(
                       CONFIG, num_experts_per_tok=2,
                       program={**PROGRAM, "n_experts": 8, "n_group": 4,
                                "topk_group": 2}))):
        order = idx[0].argsort()
        out.append((idx[0][order].tolist(), g[0][order]))
    return out


def test_routing_keeps_the_best_groups():
    """Expert 0 scores highest, but its group (0, 1) sums lowest of the
    four: the choice comes from the kept groups (2, 3) and (4, 5)."""
    cfg, x, p, s = _router_case([0.0] * 8)
    for idx, g in _routes(cfg, x, p):
        assert idx == [2, 3]
        assert torch.allclose(g, s[[2, 3]] / s[[2, 3]].sum() * 2.5)
    no_limit = cfg.replace(topk_group=4)
    assert sorted(moe.route_sigmoid(x, p, no_limit)[0][0].tolist()) == [0, 2]


def test_the_bias_chooses_but_does_not_weigh():
    """A bias of 0.1 on expert 4 puts it above expert 3 for the choice;
    its gate is its score without the bias, renormalised × 2.5."""
    cfg, x, p, s = _router_case([0, 0, 0, 0, 0.1, 0, 0, 0])
    for idx, g in _routes(cfg, x, p):
        assert idx == [2, 4]
        assert torch.allclose(g, s[[2, 4]] / s[[2, 4]].sum() * 2.5)
        assert g.sum() == pytest.approx(2.5)


def test_expert_parallel_shares_add_up_to_the_whole_layer():
    """32 experts in 4 groups, 4 shares of 8: each share's part of the
    layer (its routed experts only), summed, with the shared expert
    counted once, is the layer that holds all 32."""
    whole = get_smoke_config("deepseek-v3").replace(
        n_experts=32, experts_held=0, expert_first=0, n_group=4,
        topk_group=2, top_k=6, param_dtype="float32", dtype="float32")
    g = torch.Generator().manual_seed(3)
    m = moe.MoE(whole, dtype=torch.float32, device="cpu")
    moe.fill_moe(m, g)
    with torch.no_grad():
        m.bias.normal_(0.0, 0.05, generator=g)
    p = m.leaves()
    x = torch.randn(2, 24, whole.d_model, generator=g)
    full = moe.moe_apply(x, p, whole)[0]
    shared = mlp_apply(x, p["shared"], whole.mlp)
    parts = torch.zeros_like(full)
    for first in range(0, 32, 8):
        cut = whole.replace(experts_held=8, expert_first=first)
        share = {**p, **{k: p[k][first:first + 8] for k in ("w1", "w2",
                                                           "w3")}}
        parts += moe.moe_apply(x, share, cut)[0] - shared
    assert torch.allclose(parts + shared, full, atol=1e-5, rtol=0)
    assert (full - shared).abs().max() > 0.1


# -- planted faults ------------------------------------------------------------


def _softmax_scores(monkeypatch, model):
    route = moe.route_sigmoid

    def routed(x, p, cfg):
        with mock.patch.object(torch, "sigmoid",
                               lambda t: torch.softmax(t, -1)):
            return route(x, p, cfg)
    monkeypatch.setattr(moe, "route_sigmoid", routed)


def _no_bias(monkeypatch, model):
    route = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda x, p, cfg: route(
        x, {**p, "bias": torch.zeros_like(p["bias"])}, cfg))


def _no_group_limit(monkeypatch, model):
    route = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda x, p, cfg: route(
        x, p, cfg.replace(topk_group=cfg.n_group)))


def _rotate_half_rope(monkeypatch, model):
    """The halves turned against each other (i with i + D/2), as
    ``rotate_half`` does without the published code's pairing first."""
    def rope(x, rot):
        half = x.shape[-1] // 2
        z = torch.complex(x[..., :half].float(), x[..., half:].float()) * rot
        return torch.cat([z.real, z.imag], -1).to(x.dtype)
    monkeypatch.setattr(mla, "rope_pairs", rope)


def _no_yarn_mscale(monkeypatch, model):
    for layer in model.layers:
        layer.scale = (layer.cfg.qk_nope_head_dim
                       + layer.cfg.qk_rope_head_dim) ** -0.5


@pytest.mark.parametrize("fault", [_softmax_scores, _no_bias,
                                   _no_group_limit, _rotate_half_rope,
                                   _no_yarn_mscale],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_fails(fault, monkeypatch):
    seed = 2**31 + 1
    d, cfg, model = _model(seed)
    toks = _tokens(seed, 40, d.vocab)
    want = _ref(d, seed, toks[:20], toks[20:] + [0])
    fault(monkeypatch, model)
    logits = forward(model, torch.tensor([toks]), cfg)[0]
    assert (logits[0, 19:] - want).abs().max() > FAULT


# -- mixtral's experts, unchanged -----------------------------------------------


def _dispatch_chunk_before(xc, p, cfg):
    """``moe._dispatch_chunk`` as it was written before the held-expert
    path, verbatim."""
    B, c, d = xc.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(k, int(math.ceil(c * k / E * cfg.capacity_factor)))
    logits = xc.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    f_e = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))
    dispatch = xc.new_zeros((B, c, E, C))
    combine = torch.zeros((B, c, E, C), dtype=torch.float32,
                          device=xc.device)
    fill = torch.zeros((B, E), dtype=torch.long, device=xc.device)
    for slot in range(k):
        e_hot = F.one_hot(gate_idx[..., slot], E)
        pos = fill[:, None, :] + torch.cumsum(e_hot, dim=1) - e_hot
        keep = (e_hot > 0) & (pos < C)
        sel = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C] \
            .to(xc.dtype)
        dispatch = dispatch + sel
        combine = combine + sel.float() * gate_vals[..., slot, None, None]
        fill = fill + e_hot.sum(dim=1)
    xd = torch.einsum("bcek,bcd->ebkd", dispatch, xc).reshape(E, B * C, d)
    h = F.silu(torch.bmm(xd, p["w1"]))
    if "w3" in p:
        h = h * torch.bmm(xd, p["w3"])
    ye = torch.bmm(h, p["w2"]).reshape(E, B, C, d)
    out = torch.einsum("bcek,ebkd->bcd", combine.to(ye.dtype), ye)
    return out, aux


def _moe_apply_before(x, p, cfg):
    """``moe.moe_apply`` as it was written before the held-expert path."""
    B, S, d = x.shape
    chunk = cfg.moe_seq_chunk
    if chunk <= 0 or S <= chunk:
        out, aux = _dispatch_chunk_before(x, p, cfg)
    else:
        outs, auxs = [], []
        for c0 in range(0, S, chunk):
            xc = x[:, c0:c0 + chunk]
            if torch.is_grad_enabled():
                o, a = checkpoint(_dispatch_chunk_before, xc, p, cfg,
                                  use_reentrant=False)
            else:
                o, a = _dispatch_chunk_before(xc, p, cfg)
            outs.append(o)
            auxs.append(a)
        out = torch.cat(outs, dim=1)
        aux = torch.stack(auxs).mean()
    if cfg.n_shared_experts:
        out = out + mlp_apply(x, p["shared"], cfg.mlp)
    return out, aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("arch", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
def test_the_softmax_experts_are_bit_identical(arch, chunk, dtype):
    cfg = get_smoke_config(arch).replace(moe_seq_chunk=chunk,
                                         param_dtype=dtype, dtype=dtype)
    g = torch.Generator().manual_seed(1)
    m = moe.MoE(cfg, dtype=getattr(torch, dtype), device="cpu")
    moe.fill_moe(m, g)
    assert (m.w1.shape[0], m.w1.shape[2]) == (cfg.n_experts, cfg.d_ff)
    assert not hasattr(m, "bias")
    x = torch.randn(2, 32, cfg.d_model, generator=g).to(getattr(torch,
                                                                dtype))
    out, aux = moe.moe_apply(x, m.leaves(), cfg)
    out0, aux0 = _moe_apply_before(x, m.leaves(), cfg)
    assert torch.equal(out, out0) and torch.equal(aux, aux0)


# -- spans, counters, and no host sync ---------------------------------------------


def _engine():
    cfg = get_smoke_config("deepseek-v3")
    model = init_params(cfg, device="cpu", seed=2)
    engine = ServingEngine(cfg, model, max_batch=4, max_len=64, device="cpu")
    for i in range(3):
        engine.submit(Request(prompt=_tokens(i, 9, cfg.vocab),
                              max_new_tokens=8))
    engine.tick()                       # admits, prefills, one decode
    return cfg, engine


def test_a_decode_tick_records_the_mla_and_moe_spans_and_counters():
    cfg, engine = _engine()
    spans.reset()
    spans.enable()
    try:
        engine.tick()
        names = [r.name for r in spans.records()]
        counts = spans.counters()
    finally:
        spans.disable()
        spans.reset()
    n_mla = cfg.n_layers
    n_moe = cfg.n_layers - cfg.first_k_dense_replace
    for name in ("model.attn", "model.mla.q", "model.mla.kv",
                 "model.mla.attend"):
        assert names.count(name) == n_mla, name
    assert names.count("moe.dispatch") == names.count("moe.experts") == n_moe
    routed = cfg.top_k * engine.max_batch * n_moe
    assert counts["moe.pairs_routed"] == routed
    assert 0 < counts["moe.pairs_held"] <= routed


def test_a_decode_tick_with_spans_off_reads_nothing_back():
    """No value leaves the device inside the model's decode step: each
    way a tensor's value reaches Python raises while it runs."""
    cfg, engine = _engine()

    def refuse(*args, **kwargs):
        raise AssertionError("a value read back to the host")
    with mock.patch.multiple(torch.Tensor, item=refuse, tolist=refuse,
                             __bool__=refuse, __int__=refuse,
                             __float__=refuse), \
            mock.patch.object(torch, "nonzero", refuse):
        logits, _ = decode_step(engine.params, engine.tokens, engine.pos,
                                engine.cache, cfg)
    assert logits.shape == (engine.max_batch, cfg.padded_vocab())


@pytest.mark.parametrize("arch, graphed", [("deepseek-v3", True),
                                            ("mixtral-8x22b", False),
                                            ("rwkv6-7b", False)])
def test_a_step_is_graphed_where_its_layers_declare_it(arch, graphed):
    """The CUDA graph is keyed on what each layer declares of its decode
    step (written in place, nothing read back), not on the family."""
    from repro_torch.models.transformer import _capturable
    model = init_params(get_smoke_config(arch), device="cpu", seed=0)
    assert _capturable(model) is graphed


def test_the_card_check_of_the_prefill_attention_holds_on_the_cpu():
    """``chip_smoke.py``'s check of the MLA prefill attention (phase 25),
    run at the smoke width on the CPU, where the attention is the plain
    version: sound rows far under its limit, its planted fault (no
    YaRN m² in the scale) over it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cfg = get_smoke_config("deepseek-v3").replace(param_dtype="float32",
                                                  dtype="float32")
    err = chip_smoke.check_mla_attention(torch, cfg, "cpu", (16, 40),
                                         tag="cpu")
    assert err < 1e-5


def test_the_serve_launcher_serves_deepseek_v3_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-v3", "--smoke", "--device", "cpu", "--requests", "3",
         "--max-new", "4"], capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "3 requests" in proc.stdout


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode step's CUDA graph and "
                    "K1's kernel under the prefill have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_graphed_decode_is_the_eager_one(cuda, dtype):
    """Two copies of one batch's latent cache, one stepped eagerly (spans
    on) and one through the replayed CUDA graph (spans off): the same
    logits and the same cache at every step, across a new cache's
    capture."""
    cfg = get_smoke_config("deepseek-v3").replace(
        param_dtype=dtype, dtype=dtype, cache_dtype=dtype)
    model = init_params(cfg, device=cuda, seed=4)
    g = torch.Generator().manual_seed(4)
    eager = init_cache(cfg, 3, 64, device=cuda)
    for c in eager:
        c["latent"].copy_(torch.randn(c["latent"].shape, generator=g))
    graphed = [{"latent": c["latent"].clone()} for c in eager]
    pos = torch.tensor([5, 17, 30], device=cuda)
    for step in range(4):
        tok = torch.randint(1, cfg.vocab, (3,), generator=g).to(cuda)
        spans.enable()
        try:
            want, _ = decode_step(model, tok, pos, eager, cfg)
        finally:
            spans.disable()
            spans.reset()
        got, _ = decode_step(model, tok, pos, graphed, cfg)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for a, b in zip(graphed, eager):
            assert torch.equal(a["latent"], b["latent"])
        pos = pos + 1
        if step == 1:       # a new cache: the graph is captured again
            graphed = [{"latent": c["latent"].clone()} for c in graphed]
    assert model._decode_graph.cache[0] is graphed[0]["latent"]


@pytest.mark.gpu
def test_the_prefill_on_the_card_matches_reference(cuda):
    """The full forward on the card in float32 (K1's float32 kernel over
    the padded heads) against the reference there."""
    seed = 2**31 + 5
    d = dims(CONFIG, **SMALL)
    cfg, model = program.build_model(d, CONFIG, seed, cuda)
    toks = _tokens(seed, 40, d.vocab)
    logits = forward(model, torch.tensor([toks], device=cuda), cfg)[0]
    want = ref.served_logits(d, seed, cuda, [
        {"prompt": toks[:20], "served": toks[20:] + [0]}])[0]
    err = (logits[0, 19:] - want).abs().max()
    assert err < 1e-4, err
