"""Training tier — the port of :mod:`repro.train`: step functions,
straggler monitoring, gradient compression and the :class:`Trainer`
(``trainer.py``).  The elastic controller is not ported yet."""

from .steps import (StepConfig, apply_update, grads_of, make_serve_step,
                    make_train_step)

__all__ = ["StepConfig", "grads_of", "apply_update", "make_train_step",
           "make_serve_step"]
