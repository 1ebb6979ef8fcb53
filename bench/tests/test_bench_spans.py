"""The program's spans as the benchmark reads them (``bench/program_spans.py``
and ``bench/tools/spans.py``): each reading against a known answer on a
synthetic trace; the profiler's record of the program's ranges, which
leaves the harness's own trace, and so every accepted per-layer
reading, as it was; and a run of each cell with the spans on, on the
CPU at small sizes."""

import math
from types import SimpleNamespace

import pytest
import torch

from bench import program_spans as ps
from bench import spec
from bench.model import dims
from bench.tests.test_bench_rehearsal import RUNS
from bench.tools import spans as tool
from bench.trace import _collect

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """A kineto event as ``kineto_results.events()`` yields it; times in
    microseconds."""

    def __init__(self, name, a, b, device=CPU, corr=0, shapes=(),
                 dtypes=()):
        self._v = (name, a, b, device, corr, list(shapes), list(dtypes))

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1e3)

    def duration_ns(self):
        return int((self._v[2] - self._v[1]) * 1e3)

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return 1

    def shapes(self):
        return self._v[5]

    def dtypes(self):
        return self._v[6]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


#: the harness's ranges: the window, a tick that admits a prompt and a
#: decode-only tick
HARNESS = [Event("bench.window", 0, 1000), Event("bench.tick", 0, 400),
           Event("bench.tick", 500, 910)]
#: the program's ranges: an admit with its prefill (one attention layer
#: in it), then two decode ticks of one layer each
PROGRAM = [Event("engine.admit", 10, 200), Event("engine.prefill", 20, 190),
           Event("model.attn", 25, 100),
           Event("engine.decode", 210, 390), Event("model.attn", 220, 300),
           Event("model.ffn", 300, 380),
           Event("engine.decode", 510, 890), Event("model.attn", 520, 700),
           Event("model.ffn", 700, 880)]
#: each kernel's launch on the host, by correlation id (kernel 7's was
#: not traced); kernel 5 is launched inside the attention and runs while
#: the host is in the next span: the host runs ahead
LAUNCHES = [Event("cudaLaunchKernel", t, t + 2, corr=c)
            for c, t in ((1, 30), (2, 230), (3, 310), (4, 530), (5, 690),
                         (6, 710))]
KERNELS = [Event(f"kernel{c}", a, b, CUDA, corr=c)
           for c, a, b in ((1, 40, 150), (2, 240, 330), (3, 330, 380),
                           (4, 540, 650), (5, 760, 800), (6, 800, 895),
                           (7, 915, 950))]
KERNELS.append(Event("Memcpy DtoH (Device -> Pageable)", 380, 385, CUDA))
#: the profiler's marks of the ranges on the device's timeline
ANNOTATIONS = [Event("bench.tick", 240, 380, CUDA),
               Event("engine.decode", 240, 380, CUDA),
               Event("model.attn", 240, 330, CUDA)]


def _program_trace():
    return ps.collect(_prof(HARNESS + PROGRAM + LAUNCHES + KERNELS
                            + ANNOTATIONS))


def _harness_trace(events):
    tr = _collect(_prof(events))
    tr.tick_info = [{"admitted": 1}, {"admitted": 0}]
    return tr


def test_collect_keeps_the_programs_ranges_kernels_and_launches():
    pt = _program_trace()
    assert [s[0] for s in pt.spans] == [e.name() for e in PROGRAM]
    assert [k[0] for k in pt.kernels] == [f"kernel{c}" for c in range(1, 8)]
    assert pt.launches == {1: 30, 2: 230, 3: 310, 4: 530, 5: 690, 6: 710}
    assert pt.annotations == 2


def test_idle_inside_a_span():
    pt = _program_trace()
    # admit [10, 200]: kernel 1 runs 110 of its 190
    assert ps.idle_pct(pt, "engine.admit") == pytest.approx(100 * 80 / 190)
    # decode: 140 of 180, then 110 + 40 + 90 of 380
    assert ps.idle_pct(pt, "engine.decode") == pytest.approx(
        100 * 180 / 560)
    assert ps.idle_pct(pt, "engine.decode", (500, 1000)) == pytest.approx(
        100 * 140 / 380)
    assert ps.idle_pct(pt, "train.backward") is None


def test_kernels_are_put_down_to_the_span_that_launched_them():
    pt = _program_trace()
    # in the decode ticks: kernels 2 (90), 3 (50), 4 (110), 5 (40), 6 (95);
    # launched in the attention: 2, 4 and 5 — kernel 5 by its launch,
    # though it runs while the host is in the ffn; kernel 1, launched in
    # the prefill's attention, is no decode's
    assert ps.launched_share_pct(pt, "model.attn", "engine.decode") \
        == pytest.approx(100 * 240 / 385)
    assert ps.launched_share_pct(pt, "model.ffn", "engine.decode",
                                 (0, 400)) == pytest.approx(100 * 50 / 140)
    assert ps.launched_share_pct(pt, "model.attn", "train.backward") is None


def test_idle_gaps_by_harness_range_and_program_span():
    tr = _harness_trace(HARNESS + KERNELS)
    got, labelled = ps.idle_gaps(tr, _program_trace())
    want = {"bench.tick(admit)/engine.prefill": 40,
            "bench.tick(admit)/engine.admit": 90,
            "outside the harness's ranges": 210,
            "bench.tick/model.ffn": 110, "bench.tick": 20}
    assert {k: round(v * 1e6, 6) for k, v in got} == want
    assert labelled == pytest.approx(100 * 240 / 260)
    # the harness's own labels are the prefixes, the idle time the same
    old = dict(tr.idle_gaps())
    for name, total in old.items():
        assert sum(v for k, v in got if k.split("/")[0] == name) \
            == pytest.approx(total)


def _records(*spans):
    return [SimpleNamespace(name=n, start_ns=a, end_ns=b, attrs=attrs)
            for n, a, b, attrs in spans]


def test_queue_wait_p95():
    recs = _records(*[("engine.queue", 0, i * 1_000_000, {"id": i})
                      for i in range(20)])
    assert ps.queue_wait_p95_ms(recs, list(range(20))) == 18.0
    assert ps.queue_wait_p95_ms(recs, list(range(10))) == 9.0
    # a request of the window never prefilled counts +inf
    assert ps.queue_wait_p95_ms(recs, list(range(20)) + [99]) == 19.0
    assert ps.queue_wait_p95_ms(recs, [98, 99]) == math.inf
    assert ps.queue_wait_p95_ms([], [1]) is None


def test_prefill_padding():
    recs = _records(("engine.prefill", 0, 10, {"length": 10, "bucket": 16}),
                    ("engine.prefill", 0, 20,
                     {"length": 1000, "bucket": 1024}),
                    ("engine.prefill", 0, 99,
                     {"length": 1500, "bucket": 2048}),
                    ("engine.prefill", 0, 100, {"length": 5, "bucket": 16}),
                    ("engine.decode", 0, 50, {}))
    assert ps.prefill_pad_pct(recs, 10, 100) == pytest.approx(
        100 * (6 + 24 + 548) / (16 + 1024 + 2048))
    assert ps.prefill_pad_pct(recs, 200, 300) is None


def test_kernel_load_seconds():
    recs = _records(("kernels.load", 0, 500_000_000, {}),
                    ("kernels.build", 0, 400_000_000, {}),
                    ("kernels.load", 10, 250_000_010, {}))
    assert ps.kernel_load_s(recs) == pytest.approx(0.75)
    assert ps.kernel_load_s(recs[1:2]) is None


def _rec(cell, tr):
    d = dims(spec.load_cell(cell).config)
    if cell.endswith(".train"):
        return {"kind": "train", "trace": tr, "dims": d, "steps": 2,
                "tokens": 8192, "span_s": 1.5}
    return {"kind": "serve", "trace": tr, "dims": d, "requests": [],
            "events": [("prefill", 0.1, 1000.0, 0.06),
                       ("decode_tick", 0.2, 30.0, 0.046)],
            "decode_pairs": 100_000}


#: the operators and kernels the accepted readers read: K1's and K3's
OPS = [Event("repro_torch::flash_attention", 30, 40,
             shapes=[[1, 1024, 48, 128], [1, 1024, 8, 128],
                     [1, 1024, 8, 128]],
             dtypes=["c10::BFloat16"] * 3),
       Event("repro_torch::wkv6", 520, 530,
             shapes=[[2, 64, 2048, 64]] * 4 + [[64, 64], []],
             dtypes=["c10::BFloat16"] * 4 + ["float", ""])]
NAMED = [Event("flash_attention_tc", 40, 150, CUDA, corr=1),
         Event("wkv6_kernel", 540, 650, CUDA, corr=4)]
TRAIN = [Event("bench.window", 0, 1000), Event("bench.grads", 0, 700),
         Event("bench.update", 700, 1000)]


@pytest.mark.parametrize("cell", list(RUNS))
def test_accepted_readers_read_the_same_with_the_programs_ranges(cell):
    harness = TRAIN if cell.endswith(".train") else HARNESS
    base = harness + OPS + NAMED + KERNELS + LAUNCHES
    without = _harness_trace(base)
    with_spans = _harness_trace(base + PROGRAM)
    assert (with_spans.kernels, with_spans.ranges, with_spans.ops) == (
        without.kernels, without.ranges, without.ops)
    read = 0
    for m in spec.load_cell(cell).per_layer:
        reader = spec.reader(m["name"])
        a = reader.read(_rec(cell, without))
        assert reader.read(_rec(cell, with_spans)) == a, m["name"]
        read += a is not None
    assert read >= 3
    # the profiler's marks of the program's ranges on the device's
    # timeline are no kernels to the program's own collection
    assert [k[:3] for k in ps.collect(_prof(base + ANNOTATIONS)).kernels] \
        == [k for k in without.kernels]


@pytest.fixture(scope="module")
def cpu_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("profile", [True, False])
@pytest.mark.parametrize("cell", list(RUNS))
def test_a_run_with_the_spans_on_the_cpu(cell, profile, cpu_threads):
    sizes, traffic = RUNS[cell]
    out = tool.trace_run(cell, 2**31 + 9, 2.0, device="cpu", sizes=sizes,
                         traffic=traffic, profile=profile)
    # no kernel library is loaded on the CPU, and no device traced
    assert out["kernels.load_s"] is None and out["counters"] == {}
    assert "idle_gaps" not in out
    assert (out["profiler_stop_s"] is not None) == profile
    seen = out["spans_in_window"]
    if cell.endswith(".train"):
        assert out["train.backward_idle_pct"] is None
        assert {"train.forward", "train.backward", "optim.adamw",
                "model.rwkv", "kernels.wkv6.backward"} <= set(seen)
    else:
        assert out["engine.admit_idle_pct"] is None
        assert out["model.decode_attn_pct"] is None
        assert 0 < out["engine.queue_wait_p95_ms"] < math.inf
        assert 0 < out["ttft_p95_ms"] < math.inf
        assert 0 <= out["engine.prefill_pad_pct"] < 100
        assert {"engine.queue", "engine.prefill", "engine.decode",
                "model.attn", "moe.experts"} <= set(seen)
    assert all(n > 0 and s >= 0 for n, s in seen.values())


@pytest.mark.parametrize("cell", list(RUNS))
def test_the_cost_in_turns_on_the_cpu(cell, cpu_threads):
    sizes, traffic = RUNS[cell]
    out = tool.cost_run(cell, 2**31 + 9, 2, device="cpu", sizes=sizes,
                        traffic=traffic, ticks=3)
    assert len(out["off_s"]) == len(out["on_s"]) == 2
    assert all(x > 0 for x in out["off_s"] + out["on_s"])
    assert math.isfinite(out["cost_pct"])
