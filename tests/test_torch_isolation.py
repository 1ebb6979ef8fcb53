"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or the reference package
``repro`` (the machine with the card has none of them), and the kernel
dispatch has no path from a CUDA or a meta tensor to the plain
version."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    """Absolute module names imported by ``path`` (relative imports stay
    inside the package and are skipped)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and not str(node.args[0].value).startswith(".")):
            names.append(str(node.args[0].value))
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_has_sources():
    assert (PORT / "kernels" / "csrc" / "flash_attention.cu").exists()
    assert (PORT / "kernels" / "csrc" / "rglru.cu").exists()
    assert (PORT / "kernels" / "csrc" / "wkv6.cu").exists()
    assert PORT / "models" / "rwkv.py" in FILES
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_reference_or_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                   "import ml_dtypes\nimport importlib\n"
                   "importlib.import_module('repro.models')\n"
                   "from .core import y\nimport repro_torch\n")
    assert [n for n in _imports(src) if _forbidden(n)] == [
        "jax.numpy", "repro.core", "ml_dtypes", "repro.models"]


def test_cuda_dispatch_has_no_fallback():
    """``ops.attention``, ``ops.wkv`` and ``ops.rglru`` send every CUDA
    tensor to the kernel wrapper, which raises for what it cannot launch;
    no ``try`` wraps the launch or the build."""
    ops = (PORT / "kernels" / "ops.py").read_text()
    for name in ("ops", "flash_attention", "rglru", "wkv6", "_build"):
        tree = ast.parse((PORT / "kernels" / f"{name}.py").read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    for op in ("attention", "wkv", "rglru"):
        fn = next(n for n in ast.walk(ast.parse(ops))
                  if isinstance(n, ast.FunctionDef) and n.name == op)
        args = fn.args.kwonlyargs + fn.args.args
        assert "impl" not in [a.arg for a in args]


#: each operator's CUDA implementation in ``kernels/ops.py`` and the
#: kernel wrapper it must call
CUDA_IMPLS = {"_attention_cuda": ("_fa", "flash_attention"),
              "_rglru_cuda": ("_rglru", "rglru_scan"),
              "_wkv_cuda": ("_wkv6", "wkv6"),
              "_decode_cuda": ("_fd", "flash_decode")}


@pytest.mark.parametrize("impl", sorted(CUDA_IMPLS))
def test_cuda_implementation_calls_the_kernel(impl):
    """Each operator's CUDA implementation is one call of its kernel
    wrapper: no ``try``, no branch, no name from ``ref``."""
    tree = ast.parse((PORT / "kernels" / "ops.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == impl)
    nodes = list(ast.walk(fn))
    assert not any(isinstance(n, (ast.Try, ast.If, ast.IfExp))
                   for n in nodes)
    names = {n.id for n in nodes if isinstance(n, ast.Name)}
    assert "ref" not in names
    calls = [n.func for n in nodes if isinstance(n, ast.Call)]
    mod, wrapper = CUDA_IMPLS[impl]
    assert len(calls) == 1 and isinstance(calls[0], ast.Attribute)
    assert (calls[0].value.id, calls[0].attr) == (mod, wrapper)


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan", "wkv6",
                                  "flash_decode"])
def test_operator_registers_the_cuda_implementation(name):
    """The CUDA kernel registered for ``repro_torch::<name>`` is the
    function the AST test above reads."""
    import torch

    from repro_torch.kernels import ops

    op = getattr(torch.ops.repro_torch, name).default
    assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CUDA")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CPU")
    impl = {"flash_attention": ops._attention_cuda,
            "rglru_scan": ops._rglru_cuda, "wkv6": ops._wkv_cuda,
            "flash_decode": ops._decode_cuda}[name]
    assert impl.__name__ in CUDA_IMPLS


def test_non_cpu_tensors_go_to_the_kernel(monkeypatch):
    """A meta tensor reaches neither the kernel nor the plain version:
    each operator's fake gives outputs of the right shapes, the launch
    counters stay where they were, and no function of ``ref`` is
    called, forward or backward."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru as k2
    from repro_torch.kernels import wkv6 as k3

    called = []
    for fn in ref.__all__:
        monkeypatch.setattr(ref, fn, lambda *a, fn=fn, **k: called.append(fn))
    before = (fa.launches, k2.launches, k3.launches, fd.launches)

    def meta(*shape):
        return torch.empty(shape, device="meta", requires_grad=True)

    q, k = meta(1, 16, 4, 64), meta(1, 16, 2, 64)
    o = ops.attention(q, k, k, window=8)
    assert o.shape == q.shape and o.device.type == "meta"
    a = meta(2, 16, 8)
    h, last = ops.rglru(a, a)
    assert (h.shape, last.shape) == ((2, 16, 8), (2, 8))
    assert h.dtype == last.dtype == torch.float32
    r = meta(1, 2, 16, 64)
    y, s = ops.wkv(r, r, r, r, meta(2, 64))
    assert (y.shape, s.shape) == ((1, 2, 16, 64), (1, 2, 64, 64))
    loss = o.sum() + h.sum() + last.sum() + y.sum() + s.sum()
    grads = torch.autograd.grad(loss, [q, k, a, r])
    assert [g.shape for g in grads] == [q.shape, k.shape, a.shape, r.shape]
    # decode (inference: no gradient)
    o = ops.decode_attention(q.detach()[:, :1], k.detach(), k.detach(),
                             torch.empty((1,), dtype=torch.int64,
                                         device="meta"))
    assert o.shape == (1, 1, 4, 64) and o.device.type == "meta"
    assert (fa.launches, k2.launches, k3.launches, fd.launches) == before
    assert called == []
