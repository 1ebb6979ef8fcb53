"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or the reference package
``repro`` (the machine with the card has none of them), and the kernel
dispatch has no path from a CUDA tensor to the plain version."""

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
    """``ops.attention``, ``ops.wkv`` and ``ops.rglru`` send every
    non-CPU tensor to the kernel wrapper, which raises for what it cannot
    launch; no ``try`` wraps the launch or the build."""
    ops = (PORT / "kernels" / "ops.py").read_text()
    for name in ("ops", "flash_attention", "rglru", "wkv6", "_build"):
        tree = ast.parse((PORT / "kernels" / f"{name}.py").read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    for op in ("attention", "wkv", "rglru"):
        fn = next(n for n in ast.walk(ast.parse(ops))
                  if isinstance(n, ast.FunctionDef) and n.name == op)
        args = fn.args.kwonlyargs + fn.args.args
        assert "impl" not in [a.arg for a in args]


def test_non_cpu_tensors_go_to_the_kernel():
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    q = torch.empty(1, 16, 4, 64, device="meta")
    k = torch.empty(1, 16, 2, 64, device="meta")
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ops.attention(q, k, k)
    assert fa.launches == before
