"""Architectures the port serves (``--arch <id>``).

Each module exposes ``CONFIG`` (the published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests), as in
:mod:`repro.configs`.  Only llama3.2-1b is ported so far.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

#: canonical ids (CLI, exactly as in the reference) → module names
ARCH_IDS = {
    "llama3.2-1b": "llama3_2_1b",
}


def _module(arch: str):
    mod = ARCH_IDS.get(arch, arch)
    if mod not in ARCH_IDS.values():
        raise ValueError(f"unknown arch {arch!r}; the port serves: "
                         + ", ".join(ARCH_IDS))
    return importlib.import_module(f".{mod}", __name__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
