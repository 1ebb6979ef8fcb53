"""Checkpointing in the reference's on-disk format: an npz shard + a JSON
manifest, atomic commit, async background save — the port of
:mod:`repro.checkpoint.manager`.

Layout::

    <dir>/step_000123/            (atomic: written as .tmp then renamed)
        manifest.json             tree structure, shapes, dtypes, step
        shard_0.npz               flattened leaves

Leaves are stored in ``jax.tree.flatten`` order (dict keys sorted, tuples
and lists in order), bfloat16 as its bits in a ``uint16`` array under the
dtype string ``"bfloat16"``; the manifest's ``treedef`` is written as JAX
prints it.  So a checkpoint of the same tree written by either package
restores in the other.  One card has no mesh to re-shard onto: a restore
puts each leaf on the device, and in the dtype, of the matching leaf of
the tree it is given.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from ..convert import numpy_from_tensor

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]


def _flatten(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [] if tree is None else [tree]


def _unflatten(like, leaves) -> Any:
    """``like``'s structure with ``leaves`` (an iterator) in its place."""
    if isinstance(like, Mapping):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return None if like is None else next(leaves)


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it."""
    def walk(t) -> str:
        if isinstance(t, Mapping):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


def _storable(x) -> tuple[np.ndarray, str]:
    """A leaf as a host copy numpy can write, and its true dtype."""
    if isinstance(x, torch.Tensor):
        return numpy_from_tensor(x), str(x.dtype).removeprefix("torch.")
    x = np.array(x)
    return x, str(x.dtype)


def _loaded(raw: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).copy())


def _write(directory, step: int, stored: list, treedef: str
           ) -> pathlib.Path:
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard_0.npz",
             **{f"leaf_{i}": s for i, (s, _) in enumerate(stored)})
    manifest = {
        "step": step,
        "n_leaves": len(stored),
        "treedef": treedef,
        "shapes": [list(s.shape) for s, _ in stored],
        "dtypes": [dt for _, dt in stored],
        # The repo's clock convention: ``time`` is monotonic
        # (``time.perf_counter``), meaningful between saves of one
        # process only; ``unix_time`` is durable provenance that no
        # metric consumes.
        "time": time.perf_counter(),
        "unix_time": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    return final


def save_checkpoint(directory, step: int, tree) -> pathlib.Path:
    """Blocking save with atomic rename commit.  Leaves are tensors (on
    any device) or numpy arrays."""
    return _write(directory, step, [_storable(x) for x in _flatten(tree)],
                  _treedef(tree))


def _steps(directory: pathlib.Path) -> list[int]:
    return sorted(int(p.name.split("_")[1])
                  for p in directory.glob("step_*"))


def restore_checkpoint(directory, step: int | None, like_tree):
    """Restore into the structure of ``like_tree`` (tensor leaves): each
    leaf comes back on the device and in the dtype of its ``like_tree``
    leaf.  ``step`` None means the latest.  Returns (tree, step)."""
    directory = pathlib.Path(directory)
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    path = directory / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    like = _flatten(like_tree)
    if manifest["n_leaves"] != len(like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(like)}")
    with np.load(path / "shard_0.npz") as data:
        leaves = [_loaded(data[f"leaf_{i}"], manifest["dtypes"][i])
                  .to(device=ref.device, dtype=ref.dtype)
                  for i, ref in enumerate(like)]
    return _unflatten(like_tree, iter(leaves)), step


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async saves."""

    def __init__(self, directory, keep: int = 3) -> None:
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def save(self, step: int, tree, blocking: bool = True) -> None:
        if self._thread is not None:
            self._thread.join()            # one outstanding save at a time
            self._thread = None
        # Copy to the host synchronously (the caller goes on updating its
        # tensors in place), then serialize in the background.
        stored = [_storable(x) for x in _flatten(tree)]
        treedef = _treedef(tree)

        def work():
            _write(self.directory, step, stored, treedef)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        self.saved_steps.append(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:09d}",
                          ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, like_tree, step: int | None = None):
        return restore_checkpoint(self.directory, step, like_tree)
