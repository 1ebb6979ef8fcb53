"""The program's spans and counters (``repro_torch.trace.spans``): the
recorder off and on, its parents across threads and in a CPU
``torch.profiler`` trace, and the spans the engine, the model, the train
step and the kernel loader leave, on small models on the CPU."""

import ctypes
import ctypes.util
import subprocess
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import Request, ServingEngine
from repro_torch.trace import spans
from repro_torch.train import steps

PROMPTS = [[3, 1, 4], list(range(1, 18)), [9] * 5, list(range(2, 11)),
           list(range(5, 35))]


@pytest.fixture
def on():
    """Spans on for one test, and off and empty after it."""
    spans.reset()
    spans.enable()
    yield spans
    spans.disable()
    spans.reset()


def _profile(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(spans.PREFIXES)]


def test_off_by_default_and_off_records_nothing(monkeypatch):
    ctx = spans.span("engine.decode", n=3)
    assert ctx is spans.span("model.attn")
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))

    def work():
        with spans.span("engine.decode"):
            with spans.span("model.attn"):
                torch.ones(2) + 1
        spans.add("kernels.built")
        spans.record("engine.queue", 1.0, 2.0, id=0)
    assert _profile(work) == []
    assert entered == []
    assert spans.records() == [] and spans.counters() == {}


def test_parents_nest_on_each_thread(on):
    inner_done = threading.Event()

    def other():
        with spans.span("train.backward"):
            with spans.span("kernels.wkv6.backward", i=1):
                pass
        inner_done.set()

    with spans.span("train.forward"):
        with spans.span("model.rwkv"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        with spans.span("model.head"):
            pass
    assert not t.is_alive() and inner_done.is_set()
    rs = spans.records()
    by = {r.name: r for r in rs}
    idx = {r.name: i for i, r in enumerate(rs)}
    assert by["train.forward"].parent == -1
    assert by["model.rwkv"].parent == idx["train.forward"]
    assert by["model.head"].parent == idx["train.forward"]
    # the other thread's spans: its own stack, not the open main-thread
    # spans around its start
    assert by["train.backward"].parent == -1
    assert by["kernels.wkv6.backward"].parent == idx["train.backward"]
    assert by["kernels.wkv6.backward"].attrs == {"i": 1}
    assert by["train.backward"].thread != by["train.forward"].thread
    for r in rs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = rs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_counters_records_and_reset(on):
    spans.add("kernels.built")
    spans.add("kernels.built", 2)
    spans.record("engine.queue", 1.5, 1.75, id=7)
    assert spans.counters() == {"kernels.built": 3}
    (q,) = spans.records()
    assert (q.name, q.start_ns, q.end_ns, q.parent, q.attrs) == (
        "engine.queue", 1_500_000_000, 1_750_000_000, -1, {"id": 7})
    spans.reset()
    assert spans.records() == [] and spans.counters() == {}


def test_profiled_ranges_match_the_records(on):
    def work():
        for i in range(3):
            with spans.span("engine.decode", tick=i):
                with spans.span("model.attn"):
                    torch.ones(4) * 2
                with spans.span("model.ffn"):
                    torch.ones(4) + 2
    names = _profile(work)
    recorded = [r.name for r in spans.records()]
    assert sorted(names) == sorted(recorded)
    assert len(recorded) == 9
    # with no profiler recording, a span enters no profiled range
    spans.reset()
    with spans.span("engine.decode"):
        pass
    assert [r.name for r in spans.records()] == ["engine.decode"]


@pytest.fixture(scope="module")
def moe():
    cfg = get_smoke_config("mixtral-8x22b").replace(param_dtype="float32")
    return cfg, init_params(cfg, device="cpu", seed=0)


def _serve(cfg, model):
    engine = ServingEngine(cfg, model, max_batch=2, max_len=64, device="cpu")
    reqs = [engine.submit(Request(prompt=p, max_new_tokens=3))
            for p in PROMPTS]
    engine.run_until_drained()
    return [r.output for r in reqs], reqs


def test_engine_spans_per_request(moe, on):
    cfg, model = moe
    outputs, reqs = _serve(cfg, model)
    rs = spans.records()
    ids = sorted(r.request_id for r in reqs)
    for name in ("engine.queue", "engine.prefill"):
        got = [r.attrs["id"] for r in rs if r.name == name]
        assert sorted(got) == ids, name
    prompts = {r.request_id: r.prompt for r in reqs}
    for r in rs:
        if r.name == "engine.prefill":
            n = len(prompts[r.attrs["id"]])
            assert r.attrs["length"] == n
            assert r.attrs["bucket"] == max(16, 1 << (n - 1).bit_length())
            assert r.attrs["bucket"] - r.attrs["length"] >= 0
            kids = [c.name for c in rs if c.parent == rs.index(r)]
            assert kids == ["engine.prefill.model",
                            "engine.prefill.first_token",
                            "engine.prefill.scatter"]
            assert rs[r.parent].name == "engine.admit"
        if r.name == "engine.queue":
            req = next(q for q in reqs if q.request_id == r.attrs["id"])
            assert r.start_ns == round(req.submitted_at * 1e9)
            assert r.end_ns >= r.start_ns
    admits = [r for r in rs if r.name == "engine.admit"]
    assert sum(r.attrs["n"] for r in admits) == len(PROMPTS)
    decodes = [i for i, r in enumerate(rs) if r.name == "engine.decode"]
    assert decodes
    for name in ("model.attn", "model.ffn", "model.head"):
        under = [r for r in rs if r.name == name
                 and r.parent in decodes]
        per_tick = cfg.n_layers if name != "model.head" else 1
        assert len(under) == per_tick * len(decodes), name
    moe_spans = {r.name for r in rs if r.name.startswith("moe.")}
    assert moe_spans == {"moe.dispatch", "moe.experts"}
    # the spans change nothing the engine serves
    spans.disable()
    assert _serve(cfg, model)[0] == outputs


def test_train_step_spans_in_order(on):
    cfg = get_smoke_config("rwkv6-7b").replace(param_dtype="float32",
                                                 remat="full")
    model = init_params(cfg, device="cpu", seed=0)
    opt_cfg = AdamWConfig()
    opt = adamw_init(dict(model.named_parameters()), opt_cfg)
    x = torch.randint(0, cfg.vocab, (1, 2, 17),
                      generator=torch.Generator().manual_seed(0))
    sc = steps.StepConfig()
    _, grads = steps.grads_of(model, cfg, {"tokens": x[:, :, :-1],
                                           "labels": x[:, :, 1:]}, sc)
    steps.apply_update(model, opt, 0, grads, cfg, opt_cfg, sc)
    rs = spans.records()
    top = [r.name for r in rs if r.parent == -1
           and r.name.startswith(("train.", "optim."))]
    assert top == ["train.forward", "train.backward", "train.accumulate",
                   "optim.clip", "optim.adamw"]
    fwd, bwd = (next(r for r in rs if r.name == n)
                for n in ("train.forward", "train.backward"))
    blocks = [r for r in rs if r.name == "model.rwkv"]
    # each block in the forward, and again in the backward's recompute
    assert len(blocks) == 2 * cfg.n_layers
    assert sum(fwd.start_ns <= r.start_ns and r.end_ns <= fwd.end_ns
               for r in blocks) == cfg.n_layers
    assert sum(bwd.start_ns <= r.start_ns and r.end_ns <= bwd.end_ns
               for r in blocks) == cfg.n_layers
    wkv = [r for r in rs if r.name == "kernels.wkv6.backward"]
    assert len(wkv) == cfg.n_layers
    assert all(bwd.start_ns <= r.start_ns and r.end_ns <= bwd.end_ns
               for r in wkv)


def test_kernel_load_and_build(on, monkeypatch, tmp_path):
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    source = tmp_path / "fake_kernel.cu"
    source.write_text("// a stand-in source\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def fake_nvcc(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")
    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    lib = _build.build(source)
    assert lib.exists() and _build.build(source) == lib
    assert spans.counters() == {"kernels.built": 1}
    (b,) = [r for r in spans.records() if r.name == "kernels.build"]
    assert b.attrs == {"source": "fake_kernel"}
    # the load of an entry point: a library found, loaded once
    monkeypatch.setattr(_build, "build", lambda s: libc)
    spans.reset()
    fn = _build.function(source, "abs", [ctypes.c_int])
    assert fn(-3) == 3
    assert _build.function(source, "abs", [ctypes.c_int]) is fn
    (load,) = spans.records()
    assert load.name == "kernels.load"
    assert load.attrs == {"source": "fake_kernel", "entry": "abs"}
    _build._fns.pop((source, "abs"))
