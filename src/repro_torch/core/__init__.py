"""The paper's monitor → predictor → policy loop, copied from
:mod:`repro.core`: events, monitoring, prediction, policies, energy,
topology, manager and governor, the DLB sharing policies, the multi-app
arbiter, machine conditions and the cost clauses."""

from .arbiter import (AppPlan, AppShareStats, ClusterArbiter,
                      MultiAppReport, jain_fairness)
from .cost import CostClause, TaskTypeInfo, TaskTypeRegistry
from .energy import CoreState, EnergyMeter, PowerModel
from .events import EventBus, EventKind, RuntimeEvent
from .governor import (DEFAULT_MIN_SAMPLES, GovernorReport, GovernorSpec,
                       PolicyEntry, ResourceGovernor, policy_entry,
                       register_policy, registered_policies)
from .manager import WorkerManager, WorkerState
from .monitoring import (EMA, AccuracyReport, HeteroTypeSnapshot,
                         TaskMonitor, TypeMetrics)
from .policies import (BusyPolicy, HeteroPredictionPolicy, HybridPolicy,
                       IdlePolicy, Policy, PollDecision, PredictionPolicy)
from .prediction import (DEFAULT_PREDICTION_RATE_S, CPUPredictor,
                         HeteroPlan, PredictionConfig)
from .sharing import (DLBHybridPolicy, DLBPredictionPolicy, LeWIPolicy,
                      ResourceBroker, SharingPolicy)
from .topology import CoreTopology, CoreType

__all__ = [
    "AppPlan", "AppShareStats", "ClusterArbiter", "MultiAppReport",
    "jain_fairness",
    "CostClause", "TaskTypeInfo", "TaskTypeRegistry",
    "CoreState", "EnergyMeter", "PowerModel",
    "EventBus", "EventKind", "RuntimeEvent",
    "DEFAULT_MIN_SAMPLES", "GovernorReport", "GovernorSpec", "PolicyEntry",
    "ResourceGovernor", "policy_entry", "register_policy",
    "registered_policies",
    "WorkerManager", "WorkerState",
    "EMA", "AccuracyReport", "HeteroTypeSnapshot", "TaskMonitor",
    "TypeMetrics",
    "BusyPolicy", "HeteroPredictionPolicy", "HybridPolicy", "IdlePolicy",
    "Policy", "PollDecision", "PredictionPolicy",
    "DEFAULT_PREDICTION_RATE_S", "CPUPredictor", "HeteroPlan",
    "PredictionConfig",
    "DLBHybridPolicy", "DLBPredictionPolicy", "LeWIPolicy",
    "ResourceBroker", "SharingPolicy",
    "CoreTopology", "CoreType",
]
