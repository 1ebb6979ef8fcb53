"""End-to-end trainer: data pipeline → train step → checkpoint/restart,
with straggler monitoring and optional gradient compression — the port
of :mod:`repro.train.trainer`, on the card unless ``device="cpu"``.
This is what ``python -m repro_torch.launch.train`` drives.

The reference's ``jax.jit`` step with donated buffers becomes the eager
step of :func:`repro_torch.train.steps.make_train_step`, which updates
the model and the optimizer state in place.  Checkpoints hold the
reference's tree (``{"params", "opt": {"mu", "nu", "count"[, "ef"]}}``,
through :func:`repro_torch.convert.tree_from_named`), so a run of either
package restores in the other.

``params`` (the :class:`~repro_torch.models.Transformer`) is the port's
init from ``seed``; a caller may replace it before :meth:`Trainer.run`
with any model of the same config, such as the reference's weights
through :func:`repro_torch.convert.params_from_jax` — the optimizer
state is keyed by parameter name.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import torch

from ..checkpoint import CheckpointManager
from ..convert import named_from_tree, tree_from_named
from ..data import SyntheticLM
from ..models import ModelConfig, init_params
from ..models.transformer import resolve_device
from ..optim import AdamWConfig, adamw_init
from .compression import init_error_feedback
from .steps import StepConfig, make_train_step
from .straggler import StragglerMonitor

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    compress: bool = False
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    step: StepConfig = field(default_factory=StepConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 device: str | torch.device = "cuda") -> None:
        if tcfg.seq_len <= cfg.frontend_len:
            # SyntheticLM makes seq_len − frontend_len tokens a row: none
            # leaves every label masked, fewer than none kills its thread
            # and the first batch never comes.
            raise ValueError(
                f"{cfg.name}: seq_len {tcfg.seq_len} leaves no tokens after "
                f"the {cfg.frontend_len}-position frontend prefix; pass a "
                f"seq_len above {cfg.frontend_len}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.params = init_params(cfg, device=self.device, seed=tcfg.seed)
        named = dict(self.params.named_parameters())
        self.opt_state = adamw_init(named, tcfg.opt)
        #: the step's configuration (``tcfg.compress`` turns compression on)
        self.step_cfg = tcfg.step
        if tcfg.compress:
            self.step_cfg = replace(tcfg.step, compress=True)
            self.opt_state["ef"] = init_error_feedback(named)
        self.step = 0
        self.straggler = StragglerMonitor()
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir) \
            if tcfg.checkpoint_dir else None
        self._step = make_train_step(cfg, tcfg.opt, self.step_cfg)
        self.data = SyntheticLM(
            vocab=cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, accum=tcfg.step.accum,
            frontend_len=cfg.frontend_len, d_model=cfg.d_model,
            seed=tcfg.seed)
        self.history: list[dict] = []

    # -- checkpoint state ----------------------------------------------------

    def _tree(self, named: dict) -> dict:
        return tree_from_named({k: t.detach().cpu() for k, t in named.items()},
                               self.cfg)

    def state(self) -> dict:
        """The reference's checkpoint tree, on the host."""
        opt = {k: self._tree(self.opt_state[k])
               for k in ("mu", "nu", "ef") if k in self.opt_state}
        opt["count"] = self.opt_state["count"].cpu()
        return {"params": self._tree(dict(self.params.named_parameters())),
                "opt": opt}

    # -- restart ----------------------------------------------------------

    def maybe_restore(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        state, step = self.ckpt.restore(self.state())
        named = dict(self.params.named_parameters())
        with torch.no_grad():
            for dst, tree in [(named, state["params"])] + [
                    (self.opt_state[k], state["opt"][k])
                    for k in ("mu", "nu", "ef") if k in self.opt_state]:
                for k, t in named_from_tree(tree, self.cfg).items():
                    dst[k].copy_(t)
        self.opt_state["count"] = state["opt"]["count"].to(self.device)
        self.step = step
        return True

    # -- main loop -----------------------------------------------------------

    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.tcfg.steps
        target = self.step + steps
        while self.step < target:
            batch_np = next(self.data)
            batch = {"tokens": torch.from_numpy(batch_np.tokens)
                     .to(self.device, torch.long),
                     "labels": torch.from_numpy(batch_np.labels)
                     .to(self.device, torch.long)}
            if batch_np.prefix is not None:
                batch["prefix"] = torch.from_numpy(batch_np.prefix) \
                    .to(self.device, torch.bfloat16)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, self.step, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.observe(0, dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "dt": dt,
                   "grad_norm": float(metrics["grad_norm"])}
            self.history.append(rec)
            if self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if (self.ckpt is not None
                    and self.step % self.tcfg.checkpoint_every == 0):
                self.ckpt.save(self.step, self.state(), blocking=False)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.history

    def close(self) -> None:
        self.data.close()
