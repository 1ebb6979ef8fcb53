"""Task-based runtime: task graph + dependences, scheduler, a real
threaded executor and a discrete-event simulator (virtual time) that
reproduces the paper's policy dynamics deterministically on a 1-core host.
"""

from .task import Task, TaskGraph
from .scheduler import Scheduler
from .sharded import ShardedScheduler
from .thread_executor import ThreadExecutor, ExecutorReport
from .machine import MachineModel, MN4, KNL, HYBRID_PE, DVFS2
from .cluster import ClusterModel
from .sim import SimExecutor, SimJobSpec, SimReport, SimCluster
from .multiapp import (run_multi_app, run_multi_node, solo_job_spec,
                       predicted_demand)

__all__ = [
    "Task", "TaskGraph", "Scheduler", "ShardedScheduler",
    "ThreadExecutor", "ExecutorReport",
    "MachineModel", "MN4", "KNL", "HYBRID_PE", "DVFS2", "ClusterModel",
    "SimExecutor", "SimJobSpec", "SimReport", "SimCluster",
    "run_multi_app", "run_multi_node", "solo_job_spec",
    "predicted_demand",
]
