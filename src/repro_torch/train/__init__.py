"""Training tier — the port of :mod:`repro.train`: step functions, the
elastic controller, straggler monitoring, gradient compression and the
:class:`Trainer` (``trainer.py``)."""

from .steps import (StepConfig, apply_update, grads_of, make_serve_step,
                    make_train_step)

__all__ = ["StepConfig", "grads_of", "apply_update", "make_train_step",
           "make_serve_step"]
