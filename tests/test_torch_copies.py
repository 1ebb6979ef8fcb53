"""The port's framework-free modules are copies of the reference's: each
file is byte-identical to its counterpart under ``src/repro`` (the
reference uses relative imports only, and ``repro_torch.analysis`` stands
in for the annotations), and each copied package exports the
reference's names, plus the port's own extras."""

import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

COPIES = [
    # the monitor -> predictor -> policy loop
    "core/events.py", "core/monitoring.py", "core/prediction.py",
    "core/policies.py", "core/energy.py", "core/topology.py",
    "core/manager.py", "core/governor.py",
    # DLB sharing, the arbiter, machine conditions, cost clauses
    "core/conditions.py", "core/cost.py", "core/sharing.py",
    "core/arbiter.py",
    # the task runtime and the simulator
    "runtime/__init__.py", "runtime/task.py", "runtime/machine.py",
    "runtime/scheduler.py", "runtime/sharded.py", "runtime/cluster.py",
    "runtime/sim.py", "runtime/thread_executor.py", "runtime/multiapp.py",
    # the paper's benchmarks
    "workloads/__init__.py", "workloads/common.py", "workloads/arrivals.py",
    "workloads/cholesky.py", "workloads/gauss_seidel.py",
    "workloads/hpccg.py", "workloads/multisaxpy.py", "workloads/stream.py",
    # trace record/replay
    "trace/__init__.py", "trace/recorder.py", "trace/replay.py",
    # serving: SLOs, admission, the autoscaler, the serving simulator
    "serving/slo.py", "serving/admission.py", "serving/autoscale.py",
    "serving/simserving.py",
    # data and training
    "data/__init__.py", "data/synthetic.py", "train/straggler.py",
    "train/elastic.py",
]

#: the framework-free packages (``configs/`` holds copies too, of values)
PACKAGES = ["core", "runtime", "workloads", "trace", "serving", "data",
            "train"]

#: names a package of the port exports beyond the reference's ``__all__``
EXTRAS = {"train": {"grads_of", "apply_update"}}


@pytest.mark.parametrize("path", COPIES)
def test_copy_is_byte_identical(path):
    assert (PORT / path).read_bytes() == (REF / path).read_bytes(), (
        f"src/repro_torch/{path} differs from src/repro/{path}")


def test_every_framework_free_module_is_listed():
    """No copy outside the list: every file of a framework-free package
    whose bytes equal its reference counterpart is held above, so a new
    copy gets a case."""
    same = sorted(str(p.relative_to(PORT)) for pkg in PACKAGES
                  for p in (PORT / pkg).rglob("*.py")
                  if (REF / p.relative_to(PORT)).exists()
                  and p.read_bytes() == (REF / p.relative_to(PORT))
                  .read_bytes())
    assert same == sorted(COPIES)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_the_reference_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    extras = EXTRAS.get(pkg, set())
    assert set(port.__all__) == set(ref.__all__) | extras
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), f"repro_torch.{pkg} lacks {name}"


def test_governor_registers_the_dlb_policies():
    from repro.core import registered_policies as ref_policies
    from repro_torch.core import policy_entry, registered_policies

    assert registered_policies() == ref_policies()
    for name in ("dlb-lewi", "dlb-hybrid", "dlb-prediction"):
        assert policy_entry(name).sharing
