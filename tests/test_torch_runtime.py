"""The port's task runtime against the reference's: the simulator
(``SimExecutor``, ``SimCluster``, ``run_multi_app`` / ``run_multi_node``,
``ClusterModel``), machine conditions, every workload builder, the four
machine presets and all seven policies, DLB included.  The same scenario
runs through both packages; every field of their ``GovernorReport`` /
``MultiAppReport`` must be equal, and so must their JSONL traces.

Task ids come from a module-global ``itertools.count()`` in each
package's ``runtime/task.py``, so a raw id depends on what the process
built before.  Each scenario therefore builds both packages' graphs from
the same fresh start of that counter (:func:`both`), as the reference's
own ``tests/test_cluster.py`` resets it; the traces then compare byte
for byte with the ids as recorded.  ``ThreadExecutor`` runs on the wall
clock: it is held on completion and dependency order, and its recorded
trace must replay to equal reports in both packages' simulators.
"""

import dataclasses
import importlib
import itertools
import json
import sys
import threading
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _package(name: str) -> SimpleNamespace:
    mods = {m: importlib.import_module(f"{name}.{m}")
            for m in ("core", "runtime", "workloads", "trace")}
    return SimpleNamespace(
        name=name, **mods,
        conditions=importlib.import_module(f"{name}.core.conditions"),
        task=importlib.import_module(f"{name}.runtime.task"))


REF, PORT = _package("repro"), _package("repro_torch")
SOLO = ("busy", "idle", "hybrid", "prediction")
DLB = ("dlb-lewi", "dlb-hybrid", "dlb-prediction")

#: each workload builder of ``WORKLOADS`` at a small size
SMALL = {
    "cholesky-fine": dict(p=4),
    "cholesky-coarse": dict(p=4),
    "hpccg": dict(iterations=3, blocks=6),
    "gauss-seidel": dict(steps=3, bi=4, bj=4),
    "multisaxpy-fine": dict(generations=4, blocks=12),
    "multisaxpy-coarse": dict(generations=4, blocks=6),
    "stream": dict(rounds=3, blocks=24),
}


def both(scenario):
    """``scenario(pkg)`` for the reference, then for the port, each from
    the same fresh start of its package's task-id counter."""
    start = max(next(REF.task._ids), next(PORT.task._ids))
    out = []
    for pkg in (REF, PORT):
        pkg.task._ids = itertools.count(start)
        out.append(scenario(pkg))
    return out


def as_json(report) -> str:
    """Every field of a report (nested reports included), as text: equal
    text means equal fields, NaN included."""
    return json.dumps(dataclasses.asdict(report), sort_keys=True,
                      default=str)


def jsonl(rec, path: Path) -> bytes:
    return rec.to_jsonl(path).read_bytes()


def assert_same(results, tmp_path):
    """``results`` = [(report, recorder)] of the two packages."""
    (ref_rep, ref_rec), (port_rep, port_rec) = results
    assert type(port_rep).__module__.startswith("repro_torch.")
    assert as_json(port_rep) == as_json(ref_rep)
    ref_bytes = jsonl(ref_rec, tmp_path / "ref.jsonl")
    assert len(ref_rec) > 0
    assert jsonl(port_rec, tmp_path / "port.jsonl") == ref_bytes


# -- SimExecutor ---------------------------------------------------------------------


@pytest.mark.parametrize("policy", SOLO)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_workload_under_policy(workload, policy, tmp_path):
    def run(pkg):
        graph = pkg.workloads.WORKLOADS[workload](seed=3, **SMALL[workload])
        spec = pkg.core.GovernorSpec(resources=8, policy=policy,
                                     monitoring=True)
        ex = pkg.runtime.SimExecutor(pkg.runtime.MN4, spec=spec)
        rec = pkg.trace.TraceRecorder(bus=ex.bus)
        return ex.run(graph), rec

    assert_same(both(run), tmp_path)


@pytest.mark.parametrize("policy", ("idle", "prediction", "hetero-prediction"))
@pytest.mark.parametrize("machine", ("MN4", "KNL", "HYBRID_PE", "DVFS2"))
def test_machine_presets(machine, policy, tmp_path):
    def run(pkg):
        m = getattr(pkg.runtime, machine)
        graph = pkg.workloads.build_cholesky(grain="fine", p=5, seed=1)
        spec = pkg.core.GovernorSpec(resources=m.n_cores, policy=policy,
                                     monitoring=True)
        ex = pkg.runtime.SimExecutor(m, spec=spec)
        rec = pkg.trace.TraceRecorder(bus=ex.bus)
        return ex.run(graph), rec

    assert_same(both(run), tmp_path)


@pytest.mark.parametrize("arrivals", ("poisson", "burst", "diurnal"))
def test_open_workload(arrivals, tmp_path):
    def run(pkg):
        w = pkg.workloads
        process = {"poisson": w.PoissonArrivals(rate=4000.0, seed=2),
                   "burst": w.BurstArrivals(burst_size=16, gap=2e-3,
                                            seed=2, jitter=0.2),
                   "diurnal": w.DiurnalArrivals(period=0.02, low_rate=500.0,
                                                high_rate=8000.0, seed=2),
                   }[arrivals]
        graph = w.build_multisaxpy(grain="fine", generations=3, blocks=32,
                                   seed=2)
        spec = pkg.core.GovernorSpec(resources=16, policy="prediction",
                                     monitoring=True)
        ex = pkg.runtime.SimExecutor(pkg.runtime.MN4, spec=spec)
        rec = pkg.trace.TraceRecorder(bus=ex.bus)
        return ex.run(graph, arrivals=process), rec

    assert_same(both(run), tmp_path)


# -- machine conditions --------------------------------------------------------------


def _timeline(pkg, kind: str):
    c = pkg.conditions
    perts = {
        "power-cap": [c.power_cap(0.0, 20.0), c.power_cap(0.002, None)],
        "core-fail-recover": [c.core_fail(5e-4, 2), c.core_recover(2e-3, 2)],
        "thermal-throttle": [c.thermal_throttle(1e-3, "P", 0.6)],
        "straggler": [c.straggler(5e-4, 5, 4.0)],
        "all": [c.power_cap(0.0, 20.0), c.core_fail(5e-4, 2),
                c.straggler(1e-3, 5, 4.0),
                c.thermal_throttle(1.5e-3, "P", 0.6),
                c.core_recover(2e-3, 2)],
    }[kind]
    return c.ConditionTimeline(perts)


@pytest.mark.parametrize("policy", ("busy", "prediction", "hetero-prediction"))
@pytest.mark.parametrize("kind", ("power-cap", "core-fail-recover",
                                  "thermal-throttle", "straggler", "all"))
def test_condition_timeline(kind, policy, tmp_path):
    def run(pkg):
        graph = pkg.workloads.build_gauss_seidel(steps=4, bi=6, bj=6,
                                                 block_elems=200_000, seed=0)
        spec = pkg.core.GovernorSpec(resources=24, policy=policy,
                                     monitoring=True)
        ex = pkg.runtime.SimExecutor(pkg.runtime.HYBRID_PE, spec=spec,
                                     conditions=_timeline(pkg, kind))
        rec = pkg.trace.TraceRecorder(bus=ex.bus)
        return ex.run(graph), rec

    assert_same(both(run), tmp_path)


def test_condition_timeline_round_trip():
    ref = _timeline(REF, "all")
    port = PORT.conditions.ConditionTimeline.from_dicts(ref.to_dicts())
    assert port.to_dicts() == ref.to_dicts()
    assert port.neutralized().to_dicts() == ref.neutralized().to_dicts()
    for scenario in ("random_faults", "random_stragglers"):
        ref_r = getattr(REF.conditions.ConditionTimeline, scenario)(
            n_cores=24, horizon=1.0, seed=4)
        port_r = getattr(PORT.conditions.ConditionTimeline, scenario)(
            n_cores=24, horizon=1.0, seed=4)
        assert port_r.to_dicts() == ref_r.to_dicts()


# -- DLB sharing, the arbiter, multi-app and multi-node -------------------------------


def _two_jobs(pkg, policy, buses=(None, None)):
    w = pkg.workloads
    return [
        pkg.runtime.SimJobSpec(
            name="gauss", graph=w.build_gauss_seidel(
                steps=4, bi=6, bj=6, block_elems=400_000, seed=0),
            policy=policy, cpus=list(range(24)), bus=buses[0]),
        pkg.runtime.SimJobSpec(
            name="stream", graph=w.build_stream(
                rounds=3, blocks=200, block_elems=40_000, seed=1),
            policy=policy, cpus=list(range(24, 48)), bus=buses[1]),
    ]


def _recorded_buses(pkg):
    buses = (pkg.core.EventBus(app="gauss"), pkg.core.EventBus(app="stream"))
    rec = pkg.trace.TraceRecorder()
    rec.attach(buses[0]).attach(buses[1])
    return buses, rec


@pytest.mark.parametrize("policy", DLB)
def test_dlb_two_job_cluster(policy, tmp_path):
    def run(pkg):
        buses, rec = _recorded_buses(pkg)
        broker = pkg.core.ResourceBroker()
        cluster = pkg.runtime.SimCluster(pkg.runtime.MN4, broker=broker)
        for spec in _two_jobs(pkg, policy, buses):
            cluster.add_job(spec)
        reports = cluster.run()
        return reports, broker.total_calls, rec

    (ref, ref_calls, ref_rec), (port, port_calls, port_rec) = both(run)
    assert port_calls == ref_calls
    assert sorted(port) == sorted(ref) == ["gauss", "stream"]
    for app in ref:
        assert as_json(port[app]) == as_json(ref[app])
    assert (jsonl(port_rec, tmp_path / "port.jsonl")
            == jsonl(ref_rec, tmp_path / "ref.jsonl"))


@pytest.mark.parametrize("policy", DLB + ("busy",))
def test_run_multi_app(policy, tmp_path):
    def run(pkg):
        buses, rec = _recorded_buses(pkg)
        specs = _two_jobs(pkg, policy, buses)
        solo = {s.name: g.graph for s, g in
                zip(specs, _two_jobs(pkg, policy))}
        return pkg.runtime.run_multi_app(pkg.runtime.MN4, specs,
                                         solo_graphs=solo), rec

    assert_same(both(run), tmp_path)


@pytest.mark.parametrize("placement", ("predicted", "round-robin"))
def test_run_multi_node(placement, tmp_path):
    def run(pkg):
        m8 = pkg.runtime.MachineModel(name="M8", n_cores=8)
        cm = pkg.runtime.ClusterModel.symmetric(m8, 2)
        gov = pkg.core.GovernorSpec(resources=8, policy="dlb-prediction",
                                    min_borrow_speed=0.0)
        w = pkg.workloads
        buses, rec = _recorded_buses(pkg)
        specs = [pkg.runtime.SimJobSpec(
                     name="gauss", graph=w.build_gauss_seidel(
                         steps=3, bi=4, bj=4, block_elems=300_000, seed=0),
                     governor=gov, bus=buses[0]),
                 pkg.runtime.SimJobSpec(
                     name="stream", graph=w.build_stream(
                         rounds=2, blocks=40, block_elems=40_000, seed=1),
                     governor=gov, bus=buses[1])]
        return pkg.runtime.run_multi_node(cm, specs,
                                          placement=placement), rec

    assert_same(both(run), tmp_path)


def test_cluster_model(tmp_path):
    """A heterogeneous two-node cluster with a distance matrix: the
    model's own numbers, and a job placed on each node."""
    def run(pkg):
        rt = pkg.runtime
        m8 = rt.MachineModel(name="M8", n_cores=8)
        cm = rt.ClusterModel(nodes=(m8, rt.HYBRID_PE),
                             distance=((0.0, 2.0), (2.0, 0.0)))
        model = (cm.n_nodes, cm.n_cores, cm.penalty(0, 1),
                 cm.transfer_time(0, 1), cm.node_of(9), cm.type_of(9),
                 list(cm.cores_of(1))[:3])
        gov = pkg.core.GovernorSpec(resources=8, policy="prediction",
                                    monitoring=True)
        w = pkg.workloads
        buses, rec = _recorded_buses(pkg)
        cluster = rt.SimCluster(cm)
        cluster.add_job(rt.SimJobSpec(
            name="gauss", graph=w.build_gauss_seidel(steps=3, bi=4, bj=4,
                                                     seed=0),
            governor=gov, node=0, bus=buses[0]))
        cluster.add_job(rt.SimJobSpec(
            name="stream", graph=w.build_stream(rounds=2, blocks=40, seed=1),
            governor=gov, node=1, bus=buses[1]))
        return model, cluster.run(), rec

    (ref_m, ref, ref_rec), (port_m, port, port_rec) = both(run)
    assert port_m == ref_m
    for app in ref:
        assert as_json(port[app]) == as_json(ref[app])
    assert (jsonl(port_rec, tmp_path / "port.jsonl")
            == jsonl(ref_rec, tmp_path / "ref.jsonl"))


# -- the threaded executor --------------------------------------------------------------


def _thread_run(pkg):
    """A closed ThreadExecutor run of four dependent waves of six tasks;
    returns the report, the recorder, the graph and each task's rank in
    the order the tasks ran."""
    lock, done = threading.Lock(), {}

    def ran(key):
        with lock:
            done[key] = len(done)

    graph, prev = pkg.runtime.TaskGraph(), []
    for wave in range(4):
        cur = []
        for i in range(6):
            t = pkg.runtime.Task("wave", cost=1.0, fn=partial(ran, (wave, i)))
            t.depends_on(*prev)
            graph.add(t)
            cur.append(t)
        prev = cur
    ex = pkg.runtime.ThreadExecutor(3, policy="prediction")
    rec = pkg.trace.TraceRecorder(bus=ex.bus)
    return ex.run(graph), rec, done


@pytest.mark.parametrize("pkg", (REF, PORT), ids=("repro", "repro_torch"))
def test_thread_executor_completes_in_dependency_order(pkg):
    rep, _, done = _thread_run(pkg)
    assert rep.tasks_completed == len(done) == 24
    assert all(done[(w, i)] > done[(w - 1, j)]
               for w in range(1, 4) for i in range(6) for j in range(6))


@pytest.mark.parametrize("recorded_by", (REF, PORT),
                         ids=("repro", "repro_torch"))
def test_thread_trace_replays_alike(recorded_by, tmp_path):
    """One wall-clock recording, replayed in both packages' simulators
    under every solo policy: equal reports and equal re-recorded traces."""
    _, rec, _ = _thread_run(recorded_by)
    path = rec.to_jsonl(tmp_path / "thread.jsonl")
    for policy in SOLO:
        def run(pkg):
            spec = pkg.core.GovernorSpec(resources=3, policy=policy,
                                         monitoring=True)
            bus = pkg.core.EventBus()
            rec2 = pkg.trace.TraceRecorder(bus=bus)
            rep = pkg.trace.TraceReplayer(path).replay(spec, bus=bus)
            assert rep.tasks_completed == 24
            return rep, rec2

        assert_same(both(run), tmp_path)


# -- chip_smoke.py's phase 20 ------------------------------------------------------------


def test_chip_smoke_quickstart_table_is_the_references():
    """``chip_smoke.py`` holds the port's quickstart table on the card's
    machine to constants: they are the reference's numbers, and the
    port's copies give them here too."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    got = {}
    for policy in SOLO:
        graph = REF.workloads.build_gauss_seidel(steps=30, seed=0)
        spec = REF.core.GovernorSpec(resources=REF.runtime.MN4.n_cores,
                                     policy=policy, monitoring=True)
        r = REF.runtime.SimExecutor(REF.runtime.MN4, spec=spec).run(graph)
        got[policy] = (r.makespan, r.energy, r.edp, r.resumes)
    sharing = {}
    for policy in DLB:
        rep = REF.runtime.run_multi_app(REF.runtime.MN4, [
            REF.runtime.SimJobSpec(
                name="gauss", graph=REF.workloads.build_gauss_seidel(
                    steps=20, seed=0), policy=policy, cpus=list(range(24))),
            REF.runtime.SimJobSpec(
                name="stream", graph=REF.workloads.build_stream(
                    rounds=10, seed=1), policy=policy,
                cpus=list(range(24, 48)))])
        sharing[policy] = (rep.apps["gauss"].makespan,
                           rep.apps["stream"].makespan, rep.total_dlb_calls)
    assert got == chip_smoke.QUICKSTART
    assert sharing == chip_smoke.SHARING
    assert chip_smoke.runtime_tables("port") == (got, sharing)
