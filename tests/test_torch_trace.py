"""Trace record/replay in the port against the reference: a recorded
serving run replays in the simulator alike in both packages.

The port's ``ServingEngine`` on the CPU (the float32 llama3.2-1b smoke
model) is recorded by the port's ``TraceRecorder``; a reference engine
run is recorded by the reference's.  From each one JSONL file, both
packages' ``TraceReplayer`` must build the same task graph and arrival
timeline and give equal reports (every field) and equal re-recorded
traces under every solo policy.  Task ids of the replays' fresh graphs
come from the same start of both packages' counters (``both``, as in
``tests/test_torch_runtime.py``)."""

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as j_init
from repro.serving import AutoScaler as JAutoScaler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.trace import TraceRecorder as JTraceRecorder
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.serving import AutoScaler, Request, ServingEngine
from repro_torch.trace import TraceRecorder
from test_torch_runtime import PORT, REF, SOLO, as_json, both, jsonl

ARCH = "llama3.2-1b"
#: two bursts: three prompts at tick 0 and three at tick 3, two slots
BURSTS = {0: [[5, 9, 2, 7], [1, 2, 3], [4, 5, 6, 7, 8]],
          3: [[9, 10, 11], [11, 12, 13, 14], [3, 1, 4, 1, 5]]}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(param_dtype="float32")
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jcfg, jparams), (cfg, tparams)


def _serve(engine, scaler, request_cls, recorder):
    """Submit ``BURSTS`` at their ticks and drain the engine."""
    reqs, tick = [], 0
    while tick <= max(BURSTS) or engine.load:
        for prompt in BURSTS.get(tick, []):
            reqs.append(engine.submit(request_cls(prompt=list(prompt),
                                                  max_new_tokens=4)))
        scaler.target(len(engine.queue),
                      sum(r is not None for r in engine.active))
        engine.tick()
        tick += 1
    assert all(r.done and len(r.output) == 4 for r in reqs)
    return recorder


def _engine_trace(side, engine_cls, scaler_cls, request_cls, recorder_cls,
                  path, **kw):
    cfg, params = side
    engine = engine_cls(cfg, params, max_batch=2, max_len=64, **kw)
    scaler = scaler_cls(engine.monitor, max_replicas=2, policy="prediction",
                        bus=engine.bus)
    rec = _serve(engine, scaler, request_cls, recorder_cls(bus=engine.bus))
    return rec.to_jsonl(path)


@pytest.fixture(scope="module")
def port_trace(models, tmp_path_factory):
    return _engine_trace(models[1], ServingEngine, AutoScaler, Request,
                         TraceRecorder,
                         tmp_path_factory.mktemp("port") / "serving.jsonl",
                         device="cpu")


@pytest.fixture(scope="module")
def jax_trace(models, tmp_path_factory):
    return _engine_trace(models[0], JServingEngine, JAutoScaler, JRequest,
                         JTraceRecorder,
                         tmp_path_factory.mktemp("jax") / "serving.jsonl")


def _graph(pkg, path):
    """The replayer's graph as plain values: each task's type, cost,
    service and release time, and its dependencies and parent by
    position."""
    graph, timeline = pkg.trace.TraceReplayer(path).build()
    pos = {id(t): i for i, t in enumerate(graph.tasks)}
    rows = [(t.type_name, t.cost, t.service_time, t.release_time,
             [pos[id(d)] for d in t.deps],
             pos[id(t.parent)] if t.parent is not None else None)
            for t in graph.tasks]
    return rows, (tuple(timeline.release_times) if timeline is not None
                  else None)


@pytest.mark.parametrize("trace", ("port_trace", "jax_trace"))
def test_engine_trace_builds_alike(trace, request):
    path = request.getfixturevalue(trace)
    rows, timeline = _graph(PORT, path)
    assert (rows, timeline) == _graph(REF, path)
    # six requests, no prefill or decode-tick samples; the second burst
    # arrives after the first executes, so the timeline is open
    assert len(rows) == 6 and {r[0] for r in rows} == {"request"}
    assert timeline is not None
    assert sorted(r[3] for r in rows) == list(timeline)
    assert timeline[:3] == (0.0, 0.0, 0.0) and min(timeline[3:]) > 0.0


@pytest.mark.parametrize("policy", SOLO)
@pytest.mark.parametrize("trace", ("port_trace", "jax_trace"))
def test_engine_trace_replays_alike(trace, policy, request, tmp_path):
    path = request.getfixturevalue(trace)

    def run(pkg):
        spec = pkg.core.GovernorSpec(resources=2, policy=policy,
                                     monitoring=True)
        bus = pkg.core.EventBus()
        rec = pkg.trace.TraceRecorder(bus=bus)
        rep = pkg.trace.TraceReplayer(path).replay(spec, bus=bus)
        assert rep.tasks_completed == 6 and rep.makespan > 0
        return rep, rec

    (ref, ref_rec), (port, port_rec) = both(run)
    assert as_json(port) == as_json(ref)
    assert (jsonl(port_rec, tmp_path / "port.jsonl")
            == jsonl(ref_rec, tmp_path / "ref.jsonl"))
    # and twice in one package: the replay is deterministic
    again, _ = run(PORT)
    assert as_json(again) == as_json(port)


def test_port_trace_round_trips_jsonl(port_trace, tmp_path):
    again = TraceRecorder.from_jsonl(port_trace).to_jsonl(
        tmp_path / "again.jsonl")
    assert again.read_bytes() == port_trace.read_bytes()


def _sim_trace(tmp_path):
    """A simulator run's trace (worker states, predictions and tasks)."""
    def run(pkg):
        graph = pkg.workloads.build_cholesky(grain="fine", p=4, seed=0)
        ex = pkg.runtime.SimExecutor(pkg.runtime.HYBRID_PE, spec=pkg.core
                                     .GovernorSpec(resources=24,
                                                   policy="prediction",
                                                   monitoring=True))
        rec = pkg.trace.TraceRecorder(bus=ex.bus)
        ex.run(graph)
        return rec

    _, port_rec = both(run)
    return port_rec.to_jsonl(tmp_path / "sim.jsonl")


@pytest.mark.parametrize("trace", ("port_trace", "jax_trace", "sim"))
def test_chrome_export_is_byte_identical(trace, request, tmp_path):
    """The same events give the same Chrome trace in both packages."""
    path = (_sim_trace(tmp_path) if trace == "sim"
            else request.getfixturevalue(trace))
    ref = REF.trace.TraceRecorder.from_jsonl(path).to_chrome(
        tmp_path / "ref.json")
    port = PORT.trace.TraceRecorder.from_jsonl(path).to_chrome(
        tmp_path / "port.json")
    assert port.read_bytes() == ref.read_bytes()
    assert len(port.read_bytes()) > 100

