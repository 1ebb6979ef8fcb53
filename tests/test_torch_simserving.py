"""The port's discrete-event serving frontend (``SimServing``) against
the reference's: the same requests, machine conditions and options give
equal reports (every field, the serving metrics included) and
byte-identical traces, for every SLO class and with overload protection
on and off; and a recorded run replays byte-exactly in the port
(``replay_serving``).  Virtual time only: no model, no wall clock."""

import importlib
import json

import pytest

from test_torch_runtime import PORT, REF, as_json, jsonl

SERVING = {pkg.name: importlib.import_module(f"{pkg.name}.serving")
           for pkg in (REF, PORT)}


def _timeline(pkg, n_cores: int):
    c = pkg.conditions
    return c.ConditionTimeline([
        c.straggler(0.3, core=0, slowdown=5.0),
        c.power_cap(1.0, 0.25 * n_cores),
        c.core_fail(1.5, core=1), c.core_recover(3.0, core=1),
        c.thermal_throttle(2.0, "P", 0.6),
        c.power_cap(4.0, None),
    ])


def _requests(pkg, mix: str, n: int, seed: int):
    """``n`` Poisson requests of one SLO class, or of the default mix of
    all three."""
    s = SERVING[pkg.name]
    process = pkg.workloads.PoissonArrivals(rate=60.0, seed=seed)
    if mix == "default":
        return s.build_requests(process, n, seed=seed)
    slo = {"interactive": s.INTERACTIVE, "standard": s.STANDARD,
           "batch": s.BATCH}[mix]
    return s.build_requests(process, n, mix=((slo, 1.0),), seed=seed)


def _run(pkg, mix, protection, conditions, policy="prediction", seed=5,
         n=240):
    s = SERVING[pkg.name]
    machine = pkg.runtime.HYBRID_PE
    model = s.ServingModel(machine=machine, slots_per_replica=2)
    bus = pkg.core.EventBus()
    rec = pkg.trace.TraceRecorder(bus)
    sim = s.SimServing(
        model, _requests(pkg, mix, n, seed), policy=policy, rate_s=0.25,
        protection=protection, bus=bus, seed=seed,
        conditions=_timeline(pkg, machine.n_cores) if conditions else None)
    sim.run()
    outcomes = [(r.rid, r.outcome, r.tries, r.done_at) for r in sim.requests]
    return sim.report(f"{mix}-{protection}"), outcomes, rec


@pytest.mark.parametrize("conditions", (True, False),
                         ids=("conditions", "steady"))
@pytest.mark.parametrize("protection", (True, False),
                         ids=("protected", "unprotected"))
@pytest.mark.parametrize("mix", ("default", "interactive", "standard",
                                 "batch"))
def test_sim_serving_matches_reference(mix, protection, conditions,
                                       tmp_path):
    ref, ref_out, ref_rec = _run(REF, mix, protection, conditions)
    port, port_out, port_rec = _run(PORT, mix, protection, conditions)
    assert type(port).__module__ == "repro_torch.core.governor"
    assert as_json(port) == as_json(ref)
    assert port.serving == ref.serving and port.serving["completed"] > 0
    assert port_out == ref_out
    assert (jsonl(port_rec, tmp_path / "port.jsonl")
            == jsonl(ref_rec, tmp_path / "ref.jsonl"))


@pytest.mark.parametrize("policy", ("busy", "idle", "hybrid"))
def test_sim_serving_policies_match_reference(policy, tmp_path):
    ref, ref_out, ref_rec = _run(REF, "default", True, True, policy=policy)
    port, port_out, port_rec = _run(PORT, "default", True, True,
                                    policy=policy)
    assert as_json(port) == as_json(ref) and port_out == ref_out
    assert (jsonl(port_rec, tmp_path / "port.jsonl")
            == jsonl(ref_rec, tmp_path / "ref.jsonl"))


@pytest.mark.parametrize("conditions", (True, False),
                         ids=("conditions", "steady"))
def test_replay_serving_round_trips_byte_exactly(conditions, tmp_path):
    """Recorded, reloaded and replayed in the port: the replay publishes
    the original trace byte for byte (the reference's own
    ``tests/test_overload.py`` pin, in the port)."""
    s = SERVING[PORT.name]
    model = s.ServingModel(machine=PORT.runtime.HYBRID_PE,
                           slots_per_replica=2)
    kwargs = dict(policy="prediction", rate_s=0.25, seed=5)
    _, _, rec1 = _run(PORT, "default", True, conditions)
    p1 = rec1.to_jsonl(tmp_path / "orig.jsonl")

    loaded = PORT.trace.TraceRecorder.from_jsonl(p1)
    bus2 = PORT.core.EventBus()
    rec2 = PORT.trace.TraceRecorder(bus2)
    s.replay_serving(loaded.merged_events(), model, bus=bus2, **kwargs).run()
    assert rec2.to_jsonl(tmp_path / "replay.jsonl").read_bytes() \
        == p1.read_bytes()
    subs = [json.loads(ln) for ln in p1.read_text().splitlines()
            if json.loads(ln)["kind"] == "task_submitted"]
    assert len(subs) == 240 and all("slo" in d["data"] for d in subs)
    kinds = {json.loads(ln)["kind"] for ln in p1.read_text().splitlines()}
    assert ("perturbation" in kinds) == conditions
