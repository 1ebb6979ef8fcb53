"""The port's ElasticController against the reference's, and an elastic
drill with real trainers.

The controller scenarios of ``tests/test_elastic.py`` run through both
packages' controllers and must give the same resizes, restores, replica
sets and shards.  Then a drill on the CPU: the float32 llama3.2-1b smoke
model trained one step at a time under each package's controller, with
a checkpoint every 2 steps and a CORE_FAIL at step 3 that rolls the run
back to step 2 — the reference's jitted ``Trainer`` against the port's,
from the same initial weights.  The data stream is not rewound (R6, in
both), so the re-run steps see the next batches, the same ones in both
packages; their losses must agree within ``tests/test_torch_train.py``'s
1e-5 before and after the rollback.  Last, the port's launcher runs."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import conditions as jconditions
from repro.train.elastic import ElasticController as JElasticController
from repro.train.steps import StepConfig as JStepConfig
from repro.train.straggler import StragglerMonitor as JStragglerMonitor
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import named_from_tree, params_from_jax
from repro_torch.core import conditions
from repro_torch.train.elastic import ElasticController
from repro_torch.train.steps import StepConfig
from repro_torch.train.straggler import StragglerMonitor
from repro_torch.train.trainer import Trainer, TrainerConfig, load_state

ROOT = Path(__file__).resolve().parent.parent
ARCH = "llama3.2-1b"

#: each package's controller, straggler monitor, checkpoint manager,
#: conditions module and a state leaf of four zeros
SIDES = {
    "repro": (JElasticController, JStragglerMonitor, JCheckpointManager,
              jconditions, lambda: np.zeros(4, dtype=np.float64)),
    "repro_torch": (ElasticController, StragglerMonitor, CheckpointManager,
                    conditions, lambda: torch.zeros(4, dtype=torch.float64)),
}


def _seed(c, step_time=0.1, n=6):
    for _ in range(n):
        c.on_batches_queued(1, tokens_per_batch=1000.0)
        c.on_step_done(c._task_seq, 1000.0, step_time)


def _drive(c, cond, perts, steps, every):
    """``tests/test_elastic.py``'s fault-tolerant loop: a step, the
    controller's hooks, a checkpoint every ``every`` steps, and the
    perturbation of each step applied."""
    zeros = SIDES[type(c).__module__.split(".")[0]][4]
    state = {"w": zeros()}
    fired = {p.time: p for p in cond.ConditionTimeline(perts)}
    step = 0
    while step < steps:
        state = {"w": state["w"] + 1.0}
        step += 1
        c.on_batches_queued(1, tokens_per_batch=1000.0)
        c.on_step_done(c._task_seq, 1000.0, 0.1, replica=c.set.replicas[0])
        c.maybe_checkpoint(step, state, every=every)
        p = fired.pop(float(step), None)
        if p is not None:
            _, state, step = c.apply_perturbation(p, step, state)
    return float(state["w"][0]), step


def _scenario(name, side, tmp_path):
    """One controller scenario; returns what the two packages must share."""
    Ctl, Straggler, Ckpt, cond, _ = SIDES[side]
    out = {}
    if name == "failure-shrinks":
        c = Ctl(max_replicas=8, global_batch=256)
        out["set"] = c.fail_replica(3, step=10).shards()
    elif name == "prediction-shrinks-when-idle":
        c = Ctl(max_replicas=8, global_batch=64, rate_s=0.1)
        _seed(c)
        out["set"] = c.resize_to_prediction(step=1).shards()
    elif name == "prediction-grows-with-backlog":
        c = Ctl(max_replicas=8, global_batch=64, rate_s=0.1)
        _seed(c)
        c.on_batches_queued(8, tokens_per_batch=1000.0)
        c.set = type(c.set)([0], 64)
        out["set"] = c.resize_to_prediction(step=2).shards()
    elif name == "failed-never-readmitted":
        c = Ctl(max_replicas=4, global_batch=32)
        c.fail_replica(2, step=0)
        _seed(c)
        c.on_batches_queued(16, tokens_per_batch=1000.0)
        out["set"] = c.resize_to_prediction(step=1).shards()
    elif name == "busy-keeps-everything":
        c = Ctl(max_replicas=6, global_batch=32, policy="busy")
        _seed(c)
        out["set"] = c.resize_to_prediction(0).shards()
    elif name == "sweep-drains-straggler":
        c = Ctl(max_replicas=8, global_batch=64,
                straggler=Straggler(threshold=1.5))
        for _ in range(6):
            for r in range(7):
                c.straggler.observe(r, 0.10)
            c.straggler.observe(7, 0.40)
        out["swept"] = c.sweep_stragglers(step=6).shards()
        c.on_batches_queued(16, tokens_per_batch=1000.0)
        for i in range(6):
            c.on_step_done(c._task_seq - i, 1000.0, 0.1)
        out["set"] = c.resize_to_prediction(step=7).shards()
    elif name == "core-fail-restores":
        c = Ctl(max_replicas=4, global_batch=32,
                checkpoint=Ckpt(tmp_path / side))
        out["run"] = _drive(c, cond, [cond.core_fail(5.0, 2)], 10, 2)
    elif name == "core-fail-without-checkpoint":
        c = Ctl(max_replicas=4, global_batch=32)
        out["run"] = _drive(c, cond, [cond.core_fail(5.0, 1)], 8, 1)
    elif name == "recover-rejoins-pool":
        c = Ctl(max_replicas=4, global_batch=32, rate_s=0.1,
                checkpoint=Ckpt(tmp_path / side))
        out["run"] = _drive(c, cond, [cond.core_fail(3.0, 2),
                                      cond.core_recover(6.0, 2)], 8, 1)
        c.on_batches_queued(16, tokens_per_batch=1000.0)
        out["set"] = c.resize_to_prediction(step=9).shards()
    elif name == "straggler-perturbation-drains":
        c = Ctl(max_replicas=4, global_batch=32, straggler=Straggler())
        rs, _, _ = c.apply_perturbation(cond.straggler(2.0, 3, 4.0), step=2,
                                        state=None)
        out["set"] = rs.shards()
        out["drained"] = sorted(c.straggler.drained)
    out.update(resizes=c.resizes, restores=c.restores,
               replicas=c.set.replicas, shards=c.set.shards(),
               failed=sorted(c.failed))
    return out


SCENARIOS = ("failure-shrinks", "prediction-shrinks-when-idle",
             "prediction-grows-with-backlog", "failed-never-readmitted",
             "busy-keeps-everything", "sweep-drains-straggler",
             "core-fail-restores", "core-fail-without-checkpoint",
             "recover-rejoins-pool", "straggler-perturbation-drains")


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_matches_reference(name, tmp_path):
    ref = _scenario(name, "repro", tmp_path)
    port = _scenario(name, "repro_torch", tmp_path)
    assert port == ref
    if name == "core-fail-restores":
        # tests/test_elastic.py's pin: rolled back from step 5 to the
        # step-4 save, then completed on the survivors
        assert port["restores"] == [(5, 4)] and port["run"] == (10.0, 10)


# -- the drill with real trainers -----------------------------------------------------


EVERY, FAIL_AT, LAST = 2, 3, 5


def _tcfg(cls_t, cls_s):
    return cls_t(steps=0, global_batch=4, seq_len=32, log_every=1000,
                 step=cls_s(accum=1, warmup=2))


def _drill(trainer, ctl, cond, state_of, load):
    """One step at a time under ``ctl``, a checkpoint every EVERY steps
    and a CORE_FAIL of replica 2 at FAIL_AT; returns the checkpointed
    states by step."""
    fired = {p.time: p for p in cond.ConditionTimeline(
        [cond.core_fail(float(FAIL_AT), 2)])}
    saved = {}
    while trainer.step < LAST:
        trainer.run(1)
        step, h = trainer.step, trainer.history[-1]
        ctl.on_batches_queued(1, 128.0)
        ctl.on_step_done(ctl._task_seq, 128.0, h["dt"],
                         replica=ctl.set.replicas[0])
        if step % EVERY == 0:
            saved[step] = state_of(trainer)
            assert ctl.maybe_checkpoint(step, saved[step], every=EVERY)
        p = fired.pop(float(step), None)
        if p is not None:
            _, state, resume = ctl.apply_perturbation(p, step,
                                                      state_of(trainer))
            load(trainer, state, resume)
    return saved


@pytest.fixture(scope="module")
def jax_drill(tmp_path_factory):
    """The reference's Trainer and controller through the drill; and the
    Trainer's initial weights (taken before the jitted step donates
    them)."""
    jcfg = jax_smoke_config(ARCH).replace(param_dtype="float32")
    tr = JTrainer(jcfg, _tcfg(JTrainerConfig, JStepConfig))
    init = jax.tree.map(np.asarray, tr.params)
    ctl = JElasticController(max_replicas=4, global_batch=4,
                             checkpoint=JCheckpointManager(
                                 tmp_path_factory.mktemp("jax"), keep=1))

    def load(trainer, state, step):
        # what the reference's Trainer.maybe_restore does
        trainer.params, trainer.opt_state = state["params"], state["opt"]
        trainer.step = step

    _drill(tr, ctl, jconditions,
           lambda t: {"params": t.params, "opt": t.opt_state}, load)
    tr.close()
    return init, tr.history, ctl


def test_elastic_drill_matches_reference(jax_drill, tmp_path):
    init, jhist, jctl = jax_drill
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    tr = Trainer(cfg, _tcfg(TrainerConfig, StepConfig), device="cpu")
    tr.params = params_from_jax(init, cfg, device="cpu")
    ctl = ElasticController(max_replicas=4, global_batch=4,
                            checkpoint=CheckpointManager(tmp_path, keep=1))
    restored = {}

    def load(trainer, state, step):
        load_state(trainer, state, step)
        restored.update({k: q.detach().clone()
                         for k, q in trainer.params.named_parameters()})

    def copied(tree):
        if isinstance(tree, dict):
            return {k: copied(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(copied(v) for v in tree)
        return tree.clone()

    # on the CPU, state() shares storage with the leaves it does not
    # restack: a copy, so that later steps do not move the saved state
    saved = _drill(tr, ctl, conditions, lambda t: copied(t.state()), load)
    tr.close()
    hist = tr.history
    # steps 1-3, the rollback to 2, then 3-5 again
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == [1, 2, 3, 3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               [h["grad_norm"] for h in jhist], rtol=1e-4)
    assert ctl.restores == jctl.restores == [(FAIL_AT, EVERY)]
    assert ctl.resizes == jctl.resizes
    assert ctl.set.shards() == jctl.set.shards() == {0: 2, 1: 1, 3: 1}
    # the rollback put the step-2 checkpoint back, bit for bit
    want = named_from_tree(saved[EVERY]["params"], cfg)
    assert all(torch.equal(q, want[k]) for k, q in restored.items())
    assert tr.step == LAST and len(tr.opt_state["mu"]) == len(restored)


def test_launcher_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.elastic_train", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "replicas: [0, 1, 3]  shards: {0: 3, 1: 3, 3: 2}" in out.stdout
    assert "restored at step 20; continuing 5 steps" in out.stdout
    assert "elastic shrink + restart drill complete" in out.stdout
