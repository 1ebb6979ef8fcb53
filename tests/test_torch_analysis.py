"""The port's copy of the concurrency and determinism analyzer
(``repro_torch.analysis``): its static passes over the port, its CLI
against the reference's on the analyzer's fixtures, and its runtime
lock-order witness over the port's threaded runtime.

The suite-wide witness of ``tests/conftest.py`` is the reference's and
wraps the reference's classes only; each witness test here installs the
port's own witness (strict: an inversion raises on the spot) and puts
back whatever the port had before.
"""

import threading
from functools import partial
from pathlib import Path

import pytest

from repro.analysis.__main__ import main as ref_main
from repro_torch.analysis import install_witness, registered_classes
from repro_torch.analysis import annotations as port_annotations
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.core import EventBus, TaskMonitor
from repro_torch.runtime import Task, TaskGraph, ThreadExecutor
from repro_torch.runtime.sharded import ShardedScheduler
from repro_torch.trace import TraceRecorder

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"


def test_port_cli_is_clean_on_the_port(capsys):
    """``python -m repro_torch.analysis`` with no target analyzes its own
    package, ``src/repro_torch``, and finds nothing."""
    assert port_main([]) == 0
    out = capsys.readouterr().out
    assert out.startswith("clean: 0 findings")
    assert port_main([str(ROOT / "src" / "repro_torch")]) == 0


@pytest.mark.parametrize("target", sorted(
    [p.name for p in FIXTURES.glob("*.py")] + ["."]))
def test_port_cli_exits_as_the_reference(target, capsys):
    """Each fixture (and their directory) gives the same exit code, and
    the same JSON findings, through the port's CLI as through the
    reference's."""
    path = str(FIXTURES / target)
    got, want = port_main([path]), ref_main([path])
    assert got == want == 1
    capsys.readouterr()
    port_main([path, "--json"])
    port_json = capsys.readouterr().out
    ref_main([path, "--json"])
    assert port_json == capsys.readouterr().out


def test_port_registers_its_lock_owners():
    """The port's annotated copies register in the port's registry, the
    eight lock owners among them, each ranked in the LOCK_ORDER."""
    classes = registered_classes()
    for name in ("EventBus", "TaskMonitor", "WorkerManager",
                 "ResourceBroker", "Scheduler", "ShardedScheduler",
                 "ThreadExecutor", "TraceRecorder"):
        assert classes[name].__module__.startswith("repro_torch."), name
        assert name in port_annotations.LOCK_ORDER


@pytest.fixture
def strict_witness():
    saved = port_annotations._witness
    witness = install_witness(strict=True)
    yield witness
    port_annotations._set_witness(saved)
    assert not witness.violations, witness.violations
    assert witness.check_declared() == []


def _waves(n_waves: int, width: int):
    lock, done = threading.Lock(), {}

    def ran(key):
        with lock:
            done[key] = len(done)

    graph, prev = TaskGraph(), []
    for wave in range(n_waves):
        cur = []
        for i in range(width):
            task = Task("wave", cost=1.0, fn=partial(ran, (wave, i)))
            task.depends_on(*prev)
            graph.add(task)
            cur.append(task)
        prev = cur
    return graph, done


@pytest.mark.parametrize("policy", ["busy", "prediction"])
def test_thread_executor_under_the_strict_witness(strict_witness, policy):
    """A closed ThreadExecutor run of six dependent waves of eight tasks
    on four workers, traced: every lock the run takes is the port's
    instrumented one, and no acquisition inverts the declared order."""
    graph, done = _waves(6, 8)
    ex = ThreadExecutor(4, policy=policy)
    rec = TraceRecorder(bus=ex.bus)
    rep = ex.run(graph)
    assert rep.tasks_completed == len(done) == 48
    assert len(rec.events) > 0
    assert strict_witness.observed      # the port's locks were wrapped


def test_sharded_scheduler_under_the_strict_witness(strict_witness):
    """Four threads drain a monitored, traced ShardedScheduler of 400
    tasks, each completing what it polls."""
    bus = EventBus()
    rec = TraceRecorder(bus=bus)
    sched = ShardedScheduler(4, monitor=TaskMonitor(), bus=bus,
                             flush_batch=8)
    sched.submit_all([Task("t", cost=1.0) for _ in range(400)])

    def drain(worker):
        while not sched.drained():
            task = sched.poll(worker)
            if task is not None:
                sched.complete(task, 1e-4, worker)
        sched.flush_worker(worker)

    threads = [threading.Thread(target=drain, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert sched.drained()
    assert sum(e.kind.name == "TASK_COMPLETED" for e in rec.events) == 400
    assert strict_witness.observed


def test_trace_recorder_under_the_strict_witness(strict_witness):
    """Threads publishing onto one bus into one TraceRecorder while the
    main thread reads its events."""
    bus = EventBus()
    rec = TraceRecorder(bus=bus)
    graph, done = _waves(3, 8)
    ex = ThreadExecutor(3, policy="idle", bus=bus)
    reader = threading.Thread(target=lambda: [len(rec.events)
                                               for _ in range(200)])
    reader.start()
    rep = ex.run(graph)
    reader.join(timeout=60)
    assert not reader.is_alive()
    assert rep.tasks_completed == 24
    assert len(rec.events) > 0


def test_strict_port_witness_raises_at_an_inversion():
    """The port's witness is live: taking the Scheduler's lock inside the
    TraceRecorder's (ranked after it) raises at once."""
    from repro_torch.runtime.scheduler import Scheduler

    saved = port_annotations._witness
    try:
        install_witness(strict=True)
        rec, sched = TraceRecorder(), Scheduler()
        with pytest.raises(RuntimeError, match="inversion"):
            with rec._lock:
                with sched._lock:
                    pass
    finally:
        port_annotations._set_witness(saved)
