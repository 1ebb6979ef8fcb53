"""The port's ServingEngine against the reference's, on the CPU.

Both engines get the same float32 weights (converted from the JAX tree)
and the same injected step clock, so they must agree exactly: greedy
tokens, the sequence of runtime events with their task ids, costs and
elapsed times, and the AutoScaler's Δ trace.  float32 because bf16 flips
near-ties of the argmax between the frameworks."""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.events import EventKind as JEventKind
from repro.models import init_params as j_init
from repro.serving import AutoScaler as JAutoScaler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.events import EventKind
from repro_torch.launch.serve import report, serve
from repro_torch.models import init_params
from repro_torch.serving import AutoScaler, Request, ServingEngine

ARCH = "llama3.2-1b"
#: tests/test_serving.py's prompts
PROMPTS = {
    "single": ([[5, 9, 2, 7]], 6, 2),
    "mixed": ([[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]], 4, 2),
    "one_slot": ([[1], [2], [3]], 3, 1),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(param_dtype="float32")
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jcfg, jparams), (cfg, tparams)


def _step_clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _recorder(bus):
    events = []
    bus.subscribe(events.append)
    return events


def _key(e):
    """What must agree: everything but PREDICTION times, which the
    clock-less autoscaler governor reads from the wall clock."""
    if e.kind.name == "PREDICTION":
        return e.kind.name, dict(e.data)
    return (e.kind.name, e.time, e.task_id, e.type_name, e.cost, e.elapsed,
            dict(e.data))


def _run(side, engine_cls, request_cls, scaler_cls, prompts, max_new,
         max_batch, **kw):
    cfg, params = side
    engine = engine_cls(cfg, params, max_batch=max_batch, max_len=64,
                        clock=_step_clock(), **kw)
    events = _recorder(engine.bus)
    scaler = scaler_cls(engine.monitor, max_replicas=max_batch,
                        policy="prediction", bus=engine.bus)
    reqs = [engine.submit(request_cls(prompt=list(p),
                                      max_new_tokens=max_new))
            for p in prompts]
    targets = []
    while engine.load:
        targets.append(scaler.target(
            len(engine.queue), sum(r is not None for r in engine.active)))
        engine.tick()
    return ([r.output for r in reqs], [_key(e) for e in events], targets,
            [r.done_at for r in reqs])


@pytest.mark.parametrize("case", list(PROMPTS))
def test_engine_matches_reference(models, case):
    prompts, max_new, max_batch = PROMPTS[case]
    jside, tside = models
    want = _run(jside, JServingEngine, JRequest, JAutoScaler, prompts,
                max_new, max_batch)
    got = _run(tside, ServingEngine, Request, AutoScaler, prompts,
               max_new, max_batch, device="cpu")
    assert got[0] == want[0]                      # greedy tokens
    assert [k[0] for k in got[1]] == [k[0] for k in want[1]]
    assert got[1] == want[1]                      # ids, costs, times
    assert got[2] == want[2]                      # AutoScaler Δ trace
    assert got[3] == want[3]
    assert all(len(o) == max_new for o in got[0])


def test_engine_serves_launcher_workload(models):
    """The launcher's traffic (random 4–23-token prompts, so both
    prompt buckets), with more requests than slots."""
    jside, tside = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=rng.integers(4, 24)).tolist()
               for _ in range(6)]
    want = _run(jside, JServingEngine, JRequest, JAutoScaler, prompts, 5, 4)
    got = _run(tside, ServingEngine, Request, AutoScaler, prompts, 5, 4,
               device="cpu")
    assert got == want
    kinds = {k[0] for k in got[1]}
    assert {"TASK_SUBMITTED", "TASK_READY", "TASK_EXECUTE",
            "TASK_COMPLETED", "PREDICTION"} <= kinds


def test_event_kinds_are_the_reference_enum():
    assert [k.name for k in EventKind] == [k.name for k in JEventKind]


def test_task_ids_follow_reference_scheme(models):
    _, (cfg, params) = models
    engine = ServingEngine(cfg, params, max_batch=2, max_len=64,
                           clock=_step_clock(), device="cpu")
    events = _recorder(engine.bus)
    r = engine.submit(Request(prompt=[3, 4], max_new_tokens=2))
    engine.run_until_drained()
    done = [(e.task_id, e.type_name) for e in events
            if e.kind is EventKind.TASK_COMPLETED]
    # prefill = request_id*2+1, each decode tick = next id * 2, then the
    # request itself
    assert done == [(r.request_id * 2 + 1, "prefill"), (2, "decode_tick"),
                    (r.request_id, "request")]


def test_engine_defaults_to_cuda(models):
    _, (cfg, params) = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "where there is none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)


def test_engine_refuses_params_on_another_device(models):
    _, (cfg, params) = models
    with pytest.raises(ValueError, match="params are on"):
        ServingEngine(cfg, params, device="meta")


@pytest.mark.parametrize("max_len,prompt_len,max_new", [
    (100, 70, 8),     # bucket 128 past the ring, L < Sc
    (20, 18, 2),      # bucket 32 past the ring, L <= Sc; the engine stops
                      # at position max_len - 1
])
def test_bucketed_prefill_past_the_ring_matches_forward(
        models, max_len, prompt_len, max_new):
    """A prompt whose bucket is longer than the cache ring: the ring holds
    the prompt's own keys, never the padding, so the engine's greedy
    tokens are ``forward``'s (decoding stays inside the ring)."""
    from repro_torch.models import forward
    _, (cfg, params) = models
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, size=prompt_len).tolist()
    engine = ServingEngine(cfg, params, max_batch=1, max_len=max_len,
                           device="cpu")
    assert engine._bucketing
    req = engine.submit(Request(prompt=prompt, max_new_tokens=max_new))
    engine.run_until_drained()
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(max_new):
            logits, _ = forward(params, torch.tensor([toks]), cfg)
            toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
    assert req.output == toks[prompt_len:]


def test_serve_launcher_on_cpu():
    cfg = get_smoke_config(ARCH)
    result = serve(cfg, requests=5, max_batch=2, max_new=4, device="cpu")
    assert all(r.done and len(r.output) == 4 for r in result["requests"])
    assert result["engine"].prefills == 5
    lines = report(result)
    assert "tok/s" in lines[0] and "p95" in lines[1] and "Δ" in lines[2]


# ---------------------------------------------------------------------------
# recurrentgemma: exact-length prefill, recurrent states in the slots
# ---------------------------------------------------------------------------

RG_ARCH = "recurrentgemma-2b"
#: prompts of 3–8 tokens (the reference's conv state is whole from
#: conv_width − 1 = 3 tokens on; ROADMAP §3); 12 new tokens carry the
#: longer requests past the 16-slot ring of the local layers
RG_PROMPTS = {
    "mixed": ([[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15]],
              4, 2),
    "ring": ([[5, 9, 2, 7, 11, 3, 8], [21, 22, 23], [30, 31, 32, 33, 34, 35],
              [40, 41, 42, 43, 44, 45, 46, 47]], 12, 4),
}


@pytest.fixture(scope="module")
def rg_models():
    # untied: with tied, scaled embeddings the random smoke model repeats
    # its last prompt token, and greedy tokens would compare nothing
    over = dict(param_dtype="float32", tie_embeddings=False)
    jcfg = jax_smoke_config(RG_ARCH).replace(**over)
    cfg = get_smoke_config(RG_ARCH).replace(**over)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jcfg, jparams), (cfg, tparams)


@pytest.mark.parametrize("case", list(RG_PROMPTS))
def test_recurrent_engine_matches_reference(rg_models, case):
    prompts, max_new, max_batch = RG_PROMPTS[case]
    jside, tside = rg_models
    want = _run(jside, JServingEngine, JRequest, JAutoScaler, prompts,
                max_new, max_batch)
    got = _run(tside, ServingEngine, Request, AutoScaler, prompts,
               max_new, max_batch, device="cpu")
    assert got[0] == want[0]                      # greedy tokens
    assert [k[0] for k in got[1]] == [k[0] for k in want[1]]
    assert got[1] == want[1]                      # ids, costs, times
    assert got[2] == want[2]                      # AutoScaler Δ trace
    assert got[3] == want[3]
    assert all(len(o) == max_new for o in got[0])
    assert any(len(set(o)) > 1 for o in got[0])  # not a repeated token


def test_recurrent_engine_prefills_at_exact_length(rg_models):
    """No bucketing for a recurrent arch: each prompt is prefilled at its
    own length, and the slot's states are the B=1 prefill's."""
    _, (cfg, params) = rg_models
    engine = ServingEngine(cfg, params, max_batch=2, max_len=64,
                           device="cpu")
    assert not engine._bucketing
    seen = []
    engine._prefill = (lambda p, t, *a, f=engine._prefill:
                       seen.append(t.shape[1]) or f(p, t, *a))
    prompt = [3, 1, 4, 1, 5]
    engine.submit(Request(prompt=prompt, max_new_tokens=1))
    engine._admit()
    assert seen == [len(prompt)]
    from repro_torch.models import prefill
    _, cache1 = prefill(params, torch.tensor([prompt]), cfg, max_len=64)
    for c, c1 in zip(engine.cache, cache1):
        for name in c:
            assert torch.equal(c[name][0], c1[name][0]), name


def test_serve_launcher_recurrent_on_cpu():
    cfg = get_smoke_config(RG_ARCH)
    result = serve(cfg, requests=5, max_batch=2, max_new=4, device="cpu")
    assert all(r.done and len(r.output) == 4 for r in result["requests"])
    assert result["engine"].prefills == 5


# ---------------------------------------------------------------------------
# rwkv6-7b: exact-length prefill through the WKV, states in the slots
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
#: prompts of 3–8 tokens; the first tick admits more than one request, so
#: prefills scatter their float32 shift states into the bfloat16 slots of
#: a fresh cache, and later admissions into the float32 ones a decode
#: step left (ROADMAP §3)
RWKV_PROMPTS = {
    "mixed": ([[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15]],
              4, 2),
    "long": ([[5, 9, 2, 7, 11, 3, 8], [21, 22, 23], [30, 31, 32, 33, 34, 35],
              [40, 41, 42, 43, 44, 45, 46, 47]], 12, 4),
}


@pytest.fixture(scope="module")
def rwkv_models():
    jcfg = jax_smoke_config(RWKV_ARCH).replace(param_dtype="float32")
    cfg = get_smoke_config(RWKV_ARCH).replace(param_dtype="float32")
    assert not cfg.tie_embeddings
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jcfg, jparams), (cfg, tparams)


@pytest.mark.parametrize("case", list(RWKV_PROMPTS))
def test_rwkv_engine_matches_reference(rwkv_models, case):
    prompts, max_new, max_batch = RWKV_PROMPTS[case]
    jside, tside = rwkv_models
    want = _run(jside, JServingEngine, JRequest, JAutoScaler, prompts,
                max_new, max_batch)
    got = _run(tside, ServingEngine, Request, AutoScaler, prompts,
               max_new, max_batch, device="cpu")
    assert got[0] == want[0]                      # greedy tokens
    assert [k[0] for k in got[1]] == [k[0] for k in want[1]]
    assert got[1] == want[1]                      # ids, costs, times
    assert got[2] == want[2]                      # AutoScaler Δ trace
    assert got[3] == want[3]
    assert all(len(o) == max_new for o in got[0])
    assert any(len(set(o)) > 1 for o in got[0])  # not a repeated token


def test_rwkv_engine_keeps_the_reference_shift_dtypes(rwkv_models):
    """Two requests admitted in the first tick land in the fresh bfloat16
    shift slots; after the decode step the engine holds the float32 shift
    states the model returned."""
    _, (cfg, params) = rwkv_models
    engine = ServingEngine(cfg, params, max_batch=2, max_len=64,
                           device="cpu")
    assert not engine._bucketing
    for p in ([3, 1, 4], [1, 5, 9, 2]):
        engine.submit(Request(prompt=p, max_new_tokens=3))
    engine._admit()
    assert engine.prefills == 2
    assert engine.cache[0]["shift_t"].dtype == torch.bfloat16
    engine.tick()
    assert all(c[name].dtype == torch.float32 for c in engine.cache
               for name in c)


def test_serve_launcher_rwkv_on_cpu():
    cfg = get_smoke_config(RWKV_ARCH)
    result = serve(cfg, requests=5, max_batch=2, max_new=4, device="cpu")
    assert all(r.done and len(r.output) == 4 for r in result["requests"])
    assert result["engine"].prefills == 5
