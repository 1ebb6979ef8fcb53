"""Serving tier of the port: the continuous-batching engine in PyTorch,
and copies of the reference's prediction-based autoscaler, SLO classes,
admission control and discrete-event serving frontend
(:mod:`repro.serving`)."""

from .engine import Request, ServingEngine
from .autoscale import AutoScaler
from .slo import BATCH, INTERACTIVE, STANDARD, SLOClass
from .admission import AdmissionController, CircuitBreaker, cap_allowance
from .simserving import (ServingModel, SimRequest, SimServing,
                         build_requests, replay_serving)

__all__ = [
    "Request", "ServingEngine", "AutoScaler",
    "SLOClass", "INTERACTIVE", "STANDARD", "BATCH",
    "AdmissionController", "CircuitBreaker", "cap_allowance",
    "ServingModel", "SimRequest", "SimServing", "build_requests",
    "replay_serving",
]
