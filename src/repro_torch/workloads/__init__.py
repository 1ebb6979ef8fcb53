"""The paper's benchmarks as task graphs (§4):

* Cholesky factorization — coarse (C) and fine (F) grained tiled DAG
* HPCCG — CG mini-app (SpMV / dot / axpy per iteration)
* Gauss-Seidel — heat diffusion, barrier per time step (load imbalance)
* MultiSAXPY — BLAS-1 SAXPY blocks, coarse and fine
* STREAM — memory-transfer triad, highly parallel and balanced

Each builder returns a :class:`~repro.runtime.task.TaskGraph` whose tasks
carry a *cost clause* value (the paper's normalization input), a virtual
``service_time`` for the simulator, and optionally a real numpy payload
for the threaded executor.
"""

from .arrivals import (ArrivalProcess, BurstArrivals, DiurnalArrivals,
                       FixedTimeline, PoissonArrivals, assign_release_times)
from .cholesky import build_cholesky
from .hpccg import build_hpccg
from .gauss_seidel import build_gauss_seidel
from .multisaxpy import build_multisaxpy
from .stream import build_stream

WORKLOADS = {
    "cholesky-fine": lambda **kw: build_cholesky(grain="fine", **kw),
    "cholesky-coarse": lambda **kw: build_cholesky(grain="coarse", **kw),
    "hpccg": build_hpccg,
    "gauss-seidel": build_gauss_seidel,
    "multisaxpy-fine": lambda **kw: build_multisaxpy(grain="fine", **kw),
    "multisaxpy-coarse": lambda **kw: build_multisaxpy(grain="coarse", **kw),
    "stream": build_stream,
}

__all__ = ["build_cholesky", "build_hpccg", "build_gauss_seidel",
           "build_multisaxpy", "build_stream", "WORKLOADS",
           "ArrivalProcess", "BurstArrivals", "DiurnalArrivals",
           "FixedTimeline", "PoissonArrivals", "assign_release_times"]
