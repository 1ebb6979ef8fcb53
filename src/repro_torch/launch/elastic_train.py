"""Elastic data parallelism with a replica failure mid-run — the port's
counterpart of ``examples/elastic_train.py``, on the card unless
``--device cpu``:

    python -m repro_torch.launch.elastic_train --arch llama3.2-1b
    python -m repro_torch.launch.elastic_train --arch llama3.2-1b \\
        --smoke --device cpu

A 4-replica job loses replica 2 at step 10: the
:class:`~repro_torch.train.elastic.ElasticController` shrinks the set and
re-balances the global batch over the survivors, and training goes on
from the same parameters.  At step 20 a restore drill: a fresh
:class:`~repro_torch.train.trainer.Trainer` restores the latest
checkpoint (saved every 5 steps) and trains 5 more steps.  ``--smoke``
runs the reduced same-family config; without it the full published one.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from ..configs import get_config, get_smoke_config
from ..train.elastic import ElasticController
from ..train.steps import StepConfig
from ..train.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(steps=0, global_batch=8, seq_len=64,
                             checkpoint_dir=tmp, checkpoint_every=5,
                             log_every=10, step=StepConfig(accum=1,
                                                           warmup=5))
        tr = Trainer(cfg, tcfg, device=args.device)
        ctl = ElasticController(max_replicas=4, global_batch=8)
        print(f"replicas: {ctl.set.replicas}  shards: {ctl.set.shards()}")

        tr.run(10)                       # healthy phase
        print(f"step 10 loss {tr.history[-1]['loss']:.4f} — "
              f"replica 2 FAILS")
        new_set = ctl.fail_replica(2, step=10)
        print(f"replicas: {new_set.replicas}  shards: {new_set.shards()}")
        assert sum(new_set.shards().values()) == 8   # batch conserved

        tr.run(10)                       # degraded but training
        print(f"step 20 loss {tr.history[-1]['loss']:.4f} — "
              f"restore-from-checkpoint drill")

        tr2 = Trainer(cfg, tcfg, device=args.device)
        assert tr2.maybe_restore()
        print(f"restored at step {tr2.step}; continuing 5 steps")
        tr2.run(5)
        losses = [h["loss"] for h in tr2.history]
        print(f"post-restore losses: {np.round(losses, 4)}")
        tr.close()
        tr2.close()
        print("elastic shrink + restart drill complete")


if __name__ == "__main__":
    main()
