"""The metric arithmetic on hand-made records: percentiles with misses
at +inf, energy per token, rooflines and model FLOPs by the frozen
formulas, and the trace's busy, idle and per-tick counts."""

import json
import math
from types import SimpleNamespace

import pytest
import torch

from bench import spec
from bench.frozen import roofline as frozen
from bench.model import dims
from bench.stats import gaps, percentile, union_length
from bench.trace import Trace


def _read(name, rec):
    return spec.reader(name).read(rec)


def _dims(config, **overrides):
    cfg = json.loads((spec.BENCH / "configs" / f"{config}.json")
                     .read_text())
    return dims(cfg, **overrides)


def test_percentile_is_nearest_rank_and_keeps_misses():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile(xs[:20], 95) == 19
    assert percentile([1.0] * 95 + [math.inf] * 5, 95) == 1.0
    assert percentile([1.0] * 94 + [math.inf] * 6, 95) == math.inf


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert union_length(iv) == 4
    assert gaps(iv, 0, 8) == [(3, 5), (6, 8)]


def _serve_rec(**kw):
    rec = {"kind": "serve", "requests": [], "events": [], "tokens": 0,
           "energy_j": 0.0, "decode_pairs": 0,
           "dims": _dims("mixtral-8x22b")}
    rec.update(kw)
    return rec


def test_ttft_and_itl_count_misses():
    reqs = [{"ttft_s": 0.1 * i, "gaps_s": [0.02, 0.03]} for i in range(1, 20)]
    reqs.append({"ttft_s": math.inf, "gaps_s": [math.inf]})
    rec = _serve_rec(requests=reqs)
    assert _read("ttft_p95_ms", rec) == pytest.approx(1900.0)
    assert _read("itl_p95_ms", rec) == pytest.approx(30.0)
    reqs += [{"ttft_s": math.inf, "gaps_s": [math.inf] * 3}]
    assert _read("ttft_p95_ms", _serve_rec(requests=reqs)) == math.inf


def test_joules_per_token_and_engine_spans():
    ev = [("prefill", 1.0, 1000, 0.05), ("prefill", 2.0, 3000, 0.1),
          ("decode_tick", 3.0, 64, 0.04), ("decode_tick", 4.0, 32, 0.02)]
    rec = _serve_rec(events=ev, tokens=4098, energy_j=409.8)
    assert _read("joules_per_token", rec) == pytest.approx(0.1)
    assert _read("engine.prefill_ms_per_ktok", rec) == pytest.approx(37.5)
    assert _read("engine.decode_tick_ms", rec) == pytest.approx(30.0)


def test_mfu_serve_is_the_frozen_formula():
    d = _dims("mixtral-8x22b")
    ev = [("prefill", 1.0, 256, 0.02), ("decode_tick", 2.0, 64, 0.03)]
    rec = _serve_rec(events=ev, decode_pairs=1000, dims=d)
    _, active = d.param_count()
    flops = 2 * active * (256 + 64) \
        + d.n_layers * frozen.attention_flops(1, 256, 48, 128) \
        + 4 * 128 * 48 * d.n_layers * 1000
    assert _read("mfu.serve", rec) == pytest.approx(
        100 * flops / 0.05 / 989e12)


def _trace(kernels, ops=(), ranges=(), ticks=()):
    lo = min([a for _, a, _ in kernels] + [r[1] for r in ranges] + [0])
    hi = max([b for _, _, b in kernels] + [r[2] for r in ranges] + [1])
    return Trace(kernels=list(kernels), ops=list(ops),
                 ranges=[("bench.window", lo, hi)] + list(ranges),
                 window=(lo, hi), tick_info=list(ticks))


def test_k1_roofline_from_the_frozen_bound():
    d = _dims("mixtral-8x22b")
    ops = [("repro_torch::flash_attention", 0, 10,
            [[1, 256, 48, 128], [1, 256, 8, 128], [1, 256, 8, 128], [], []],
            ["c10::BFloat16"] * 3)]
    kern = [("flash_attention_tc<128>", 100.0, 110.0),
            ("ampere_bf16_gemm", 110.0, 300.0)]
    rec = _serve_rec(trace=_trace(kern, ops), dims=d)
    bound_ms = frozen.attention_bound(1, 256, 48, 8, 128)[0]
    assert _read("k1_roofline.serve", rec) == pytest.approx(
        100 * bound_ms / 1e3 / 10e-6)
    assert _read("k3_roofline.train", rec) is None


def test_k3_roofline_counts_inputs_and_outputs():
    d = _dims("rwkv6-7b-pp4")
    shp = [2, 64, 2048, 64]
    ops = [("repro_torch::wkv6", 0, 10,
            [shp, shp, shp, shp, [64, 64], [], []],
            ["c10::BFloat16"] * 3 + ["float", "float", "", ""])]
    kern = [("wkv6_kernel", 0.0, 200.0)]
    rec = {"kind": "train", "dims": d, "trace": _trace(kern, ops)}
    meta = [torch.empty(shp, dtype=t, device="meta") for t in
            (torch.bfloat16,) * 3 + (torch.float32,)]
    meta.append(torch.empty(64, 64, device="meta"))
    outs = [torch.empty(shp, device="meta"),
            torch.empty(2, 64, 64, 64, device="meta")]
    bound_ms = frozen.wkv_bound(meta, outs)[0]
    assert _read("k3_roofline.train", rec) == pytest.approx(
        100 * bound_ms / 1e3 / 200e-6)


def test_idle_launches_and_optimizer_share():
    kern = [("a", 0, 10), ("b", 10, 20), ("c", 40, 50), ("d", 60, 100)]
    ranges = [("bench.tick", 0, 30), ("bench.tick", 35, 55),
              ("bench.wait", 55, 58)]
    tr = _trace(kern, ranges=ranges, ticks=[{"admitted": 1},
                                            {"admitted": 0}])
    rec = _serve_rec(trace=tr)
    assert _read("device.idle.serve", rec) == pytest.approx(30.0)
    assert _read("model.launches_per_tick", rec) == 1.0
    assert tr.idle_gaps()[0][0] == "bench.tick(admit)"
    rec = {"kind": "train", "trace": _trace(
        kern, ranges=[("bench.grads", 0, 30), ("bench.update", 30, 100)])}
    assert _read("train.optimizer_share", rec) == pytest.approx(50 / 70 * 100)
    assert _read("device.idle.train", rec) == pytest.approx(30.0)


def test_train_rate_and_mfu():
    d = _dims("rwkv6-7b-pp4")
    rec = {"kind": "train", "steps": 10, "tokens": 40960, "span_s": 7.0,
           "dims": d, "energy_j": 4096.0}
    assert _read("train_tok_s", rec) == pytest.approx(40960 / 7.0)
    assert _read("joules_per_token", rec) == pytest.approx(0.1)
    total, active = d.param_count()
    assert total == active
    assert _read("mfu.train", rec) == pytest.approx(
        100 * 6 * active * 40960 / 7.0 / 989e12)


def test_frozen_formulas_match_the_published_sizes():
    """The weights drawn have the sizes the configurations are known by:
    mixtral-8x22b's 8 layers and head 20.4 B (5.94 B a token), rwkv6-7b
    at the program's LoRA ranks 7.58 B, its 8 layers 2.30 B."""
    total, active = _dims("mixtral-8x22b").param_count()
    assert total == pytest.approx(20.4e9, rel=0.01)
    assert active == pytest.approx(5.94e9, rel=0.01)
    assert _dims("rwkv6-7b-pp4", num_hidden_layers=32).param_count()[0] \
        == 7_576_621_056
    assert _dims("rwkv6-7b-pp4").param_count()[0] == 2_296_811_520
    shape = SimpleNamespace(global_batch=2, seq_len=2048)
    assert frozen.model_flops(_dims("rwkv6-7b-pp4"), shape, "train") \
        == 6 * _dims("rwkv6-7b-pp4").param_count()[1] * 4096
