"""Training launcher — the port of :mod:`repro.launch.train`, on the card
unless ``--device cpu``:

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 50
    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 3 --device cpu

``--smoke`` runs the reduced same-family config; without it the full
published config (llama3.2-1b fits one H100 with its f32 AdamW state;
no MoE config does: one mixtral-8x22b layer's experts with float32
gradients and AdamW moments need about 34 GB).
``--arch`` takes every id of :data:`repro_torch.configs.ARCH_IDS`; the
MoE configs add their load-balancing aux to the loss, as the
reference's.  The
frontend configs spend ``frontend_len`` of ``--seq-len`` on their prefix,
so internvl2-1b needs ``--seq-len`` above 256 and musicgen-medium above
128 (the Trainer refuses less):

    python -m repro_torch.launch.train --arch internvl2-1b --seq-len 384
"""

from __future__ import annotations

import argparse

from ..configs import get_config, get_smoke_config
from ..train.steps import StepConfig
from ..train.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="positions a row, the frontend prefix included: "
                         "internvl2-1b needs more than 256, "
                         "musicgen-medium more than 128")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    tcfg = TrainerConfig(
        steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, checkpoint_dir=args.checkpoint_dir,
        compress=args.compress, seed=args.seed,
        step=StepConfig(accum=args.accum))
    trainer = Trainer(cfg, tcfg, device=args.device)
    if trainer.maybe_restore():
        print(f"restored from step {trainer.step}")
    try:
        hist = trainer.run()
        print(f"final loss: {hist[-1]['loss']:.4f} "
              f"(over {len(hist)} steps)")
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
