"""Architectures the port serves (``--arch <id>``).

Each module exposes ``CONFIG`` (the published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests), as in
:mod:`repro.configs`, and all ten of its archs are ported: the dense
attention ones (llama3.2-1b; gemma2-9b, with alternating local/global
layers and softcaps; qwen1.5-110b, with qkv biases; deepseek-coder-33b;
and internvl2-1b and musicgen-medium, which take a frontend ``prefix``),
the mixture-of-experts ones (mixtral-8x22b: every layer MoE, 8 experts,
top-2, sliding window; llama4-maverick-400b-a17b: dense and MoE layers
1:1, 128 experts, top-1 and a shared expert), recurrentgemma-2b and
rwkv6-7b.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

#: canonical ids (CLI, exactly as in the reference) → module names
ARCH_IDS = {
    "internvl2-1b": "internvl2_1b",
    "gemma2-9b": "gemma2_9b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-110b": "qwen1_5_110b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-7b": "rwkv6_7b",
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
