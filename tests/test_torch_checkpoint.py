"""The port's checkpoints: the reference's on-disk format, both ways.

``repro_torch.checkpoint`` writes what ``repro.checkpoint`` writes (leaf
order, dtype strings, bf16 as ``uint16`` bits, the manifest's
``treedef``), so a checkpoint of either package restores bit for bit in
the other, and a ``Trainer`` of either continues the other's run.  Those
continuations are held at rtol 1e-5 on the loss, as
tests/test_torch_train.py holds the two Trainers' histories; a restart
of the port's own run is held exactly."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import adamw_init as j_adamw_init
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.compression import init_error_feedback as j_init_ef
from repro.train.steps import StepConfig as JStepConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.train.steps import StepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "llama3.2-1b"


def _tree(seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g)
                   .to(torch.bfloat16),
                   "b": torch.zeros(16)},
        "opt": {"mu": torch.ones((8, 16)),
                "count": torch.tensor(7, dtype=torch.int32)},
        "blocks": ({"x": torch.randn((2, 3), generator=g)},),
        "rest": (),
    }


def _equal(a, b) -> None:
    leaves_a, leaves_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 3, t)
    restored, step = restore_checkpoint(tmp_path, None, t)
    assert step == 3
    _equal(t, restored)
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert restored["opt"]["count"].dtype == torch.int32


def test_atomic_commit_no_tmp_left(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    assert not list(tmp_path.glob(".tmp*"))
    manifest = json.loads(
        (tmp_path / "step_000000001" / "manifest.json").read_text())
    assert manifest["step"] == 1


def test_manifest_uses_monotonic_clock(tmp_path):
    import time

    lo = time.perf_counter()
    save_checkpoint(tmp_path, 1, _tree())
    save_checkpoint(tmp_path, 2, _tree())
    hi = time.perf_counter()
    m1, m2 = (json.loads((tmp_path / f"step_00000000{i}" /
                          "manifest.json").read_text()) for i in (1, 2))
    assert lo <= m1["time"] <= m2["time"] <= hi
    assert m1["unix_time"] > 1e9


def test_manifest_matches_the_references(tmp_path):
    """The same tree saved by both packages: the same manifest (treedef,
    shapes, dtypes) and the same stored arrays."""
    t = _tree()
    save_checkpoint(tmp_path / "port", 4, t)
    jt = jax.tree.map(lambda x: jnp.asarray(x.float().numpy())
                      .astype(str(x.dtype).removeprefix("torch.")), t)
    j_save(tmp_path / "jax", 4, jt)
    mp, mj = (json.loads((tmp_path / d / "step_000000004" /
                          "manifest.json").read_text())
              for d in ("port", "jax"))
    for key in ("step", "n_leaves", "treedef", "shapes", "dtypes"):
        assert mp[key] == mj[key], key
    assert "bfloat16" in mp["dtypes"] and "int32" in mp["dtypes"]
    with np.load(tmp_path / "port" / "step_000000004" / "shard_0.npz") as p, \
            np.load(tmp_path / "jax" / "step_000000004" / "shard_0.npz") as j:
        for i in range(mp["n_leaves"]):
            a, b = p[f"leaf_{i}"], j[f"leaf_{i}"]
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jt = {"p": jax.random.normal(jax.random.PRNGKey(1), (4, 5),
                                 jnp.bfloat16),
          "q": {"c": jnp.asarray(3, jnp.int32),
                "f": jnp.arange(6, dtype=jnp.float32)}}
    j_save(tmp_path, 9, jt)
    like = {"p": torch.zeros((4, 5), dtype=torch.bfloat16),
            "q": {"c": torch.tensor(0, dtype=torch.int32),
                  "f": torch.zeros(6)}}
    got, step = restore_checkpoint(tmp_path, None, like)
    assert step == 9
    assert torch.equal(got["p"], tensor_from_numpy(np.asarray(jt["p"])))
    assert int(got["q"]["c"]) == 3
    assert torch.equal(got["q"]["f"], torch.arange(6, dtype=torch.float32))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = _tree(5)
    save_checkpoint(tmp_path, 2, t)
    like = jax.tree.map(lambda x: jnp.zeros(
        x.shape, str(x.dtype).removeprefix("torch.")), t)
    got, step = j_restore(tmp_path, None, like)
    assert step == 2
    assert got["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got["params"]["w"]).view(np.uint16),
        t["params"]["w"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(got["blocks"][0]["x"]),
                                  t["blocks"][0]["x"].numpy())
    assert int(got["opt"]["count"]) == 7


def test_leaf_count_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, None, {"a": torch.zeros(1)})


def test_restore_goes_to_the_like_trees_device_and_dtype(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.arange(4, dtype=torch.int32)})
    got, _ = restore_checkpoint(tmp_path, 1,
                                {"a": torch.zeros(4, dtype=torch.int64,
                                                  device="meta")})
    assert got["a"].device.type == "meta" and got["a"].dtype == torch.int64


def test_manager_gc_and_async(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in range(1, 6):
        m.save(s, _tree(s), blocking=(s % 2 == 0))
    m.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_000000004", "step_000000005"]
    assert m.latest_step() == 5 and m.saved_steps == [1, 2, 3, 4, 5]
    got, step = m.restore(_tree())
    assert step == 5
    _equal(got, _tree(5))


def test_async_save_holds_a_copy(tmp_path):
    """The caller updates its tensors in place right after an async save;
    the checkpoint holds the values at the save."""
    t = _tree(1)
    want = jax.tree.map(torch.clone, t)
    m = CheckpointManager(tmp_path)
    m.save(1, t, blocking=False)
    for x in jax.tree.leaves(t):
        x.add_(1)
    m.wait()
    got, _ = m.restore(_tree())
    _equal(got, want)


def test_trainer_state_has_the_references_structure():
    """The port Trainer's checkpoint tree has the reference Trainer's
    structure, leaf for leaf (shapes and dtypes), with compression."""
    cfg = get_smoke_config(ARCH)
    tr = Trainer(cfg, TrainerConfig(steps=1, global_batch=2, seq_len=8,
                                    compress=True), device="cpu")
    state = tr.state()
    tr.close()
    jcfg = jax_smoke_config(ARCH)
    from repro.models import init_params as j_init
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    jopt = j_adamw_init(jp, JAdamWConfig())
    jopt["ef"] = j_init_ef(jp)
    jstate = {"params": jp, "opt": jopt}
    from repro_torch.checkpoint.manager import _flatten, _treedef
    assert _treedef(state) == str(jax.tree.structure(jstate))
    for x, y in zip(_flatten(state), jax.tree.leaves(jstate)):
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype)


# -- Trainers across the packages -------------------------------------------------


def _tcfg(cls_t, cls_s, ckpt, steps, every=3):
    return cls_t(steps=steps, global_batch=4, seq_len=32,
                 checkpoint_dir=str(ckpt) if ckpt else None,
                 checkpoint_every=every, log_every=1000,
                 step=cls_s(accum=2, warmup=2))


def _keep_only(src, dst, step: int):
    """A copy of the checkpoint directory ``src`` with ``step`` only."""
    shutil.copytree(src / f"step_{step:09d}", dst / f"step_{step:09d}")
    return dst


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference Trainer, 6 float32 smoke steps, checkpointing at 3
    and 6; its losses."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = jax_smoke_config(ARCH).replace(param_dtype="float32")
    tr = JTrainer(jcfg, _tcfg(JTrainerConfig, JStepConfig, ckpt, 6))
    hist = tr.run()
    tr.close()
    return ckpt, [h["loss"] for h in hist]


def test_reference_trainer_checkpoint_continues_in_the_port(jax_run,
                                                            tmp_path):
    ckpt, jlosses = jax_run
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    tr = Trainer(cfg, _tcfg(TrainerConfig, StepConfig,
                            _keep_only(ckpt, tmp_path, 3), 3),
                 device="cpu")
    assert tr.maybe_restore() and tr.step == 3
    assert int(tr.opt_state["count"]) == 3
    tr.data.close()
    tr.data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4,
                          accum=2, seed=0, start_step=3)
    hist = tr.run(3)
    tr.close()
    assert [h["step"] for h in hist] == [4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses[3:],
                               rtol=1e-5)


def test_port_trainer_checkpoint_continues_in_the_reference(tmp_path):
    cfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    ckpt = tmp_path / "port"
    tr = Trainer(cfg, _tcfg(TrainerConfig, StepConfig, ckpt, 6),
                 device="cpu")
    losses = [h["loss"] for h in tr.run()]
    tr.close()
    jcfg = jax_smoke_config(ARCH).replace(param_dtype="float32")
    jtr = JTrainer(jcfg, _tcfg(JTrainerConfig, JStepConfig,
                               _keep_only(ckpt, tmp_path / "one", 3), 3))
    assert jtr.maybe_restore() and jtr.step == 3
    jtr.data.close()
    jtr.data = JSyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4,
                            accum=2, seed=0, start_step=3)
    jhist = jtr.run(3)
    jtr.close()
    np.testing.assert_allclose([h["loss"] for h in jhist], losses[3:],
                               rtol=1e-5)


def test_checkpoint_restart_continuity(tmp_path):
    """As tests/test_train.py: an interrupted-and-restored run gives
    EXACTLY the losses of an uninterrupted one (bf16 params stored as
    their bits; the data pipeline regenerates batch k for step k)."""
    cfg = get_smoke_config(ARCH)

    def tcfg(ckpt, steps):
        return _tcfg(TrainerConfig, StepConfig, ckpt, steps, every=5)
    ref = Trainer(cfg, tcfg(None, 12), device="cpu")
    ref_losses = [h["loss"] for h in ref.run()]
    ref.close()
    tr1 = Trainer(cfg, tcfg(tmp_path, 10), device="cpu")
    tr1.run()
    tr1.close()
    tr2 = Trainer(cfg, tcfg(tmp_path, 10), device="cpu")
    assert tr2.maybe_restore() and tr2.step == 10
    tr2.data.close()
    tr2.data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4,
                           accum=2, seed=0, start_step=10)
    tr2.run(2)
    tr2.close()
    assert [h["loss"] for h in tr2.history] == ref_losses[10:12]
