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
rwkv6-7b.  Beside them the port serves one arch of its own,
deepseek-v3 (:data:`PORT_ARCH_IDS`: latent attention, 256 sigmoid-routed
experts of which a card holds 8), which :func:`get_config` resolves and
the tables shared with the reference leave out.  The ``SHAPES`` table
and its helpers are the reference's:
the four input-shape cells, and which (arch × shape) cells are runnable
(``long_500k`` needs a sub-quadratic decode path); the dry-run of
:mod:`repro_torch.launch.dryrun` walks them.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.config import ModelConfig

ARCHS = [
    "internvl2_1b", "gemma2_9b", "deepseek_coder_33b", "llama3_2_1b",
    "qwen1_5_110b", "mixtral_8x22b", "llama4_maverick_400b_a17b",
    "musicgen_medium", "recurrentgemma_2b", "rwkv6_7b",
]

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

#: the port's own archs, served but not in the reference's tables
PORT_ARCH_IDS = {"deepseek-v3": "deepseek_v3"}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(arch: str):
    ids = {**ARCH_IDS, **PORT_ARCH_IDS}
    mod = ids.get(arch, arch)
    if mod not in ids.values():
        raise ValueError(f"unknown arch {arch!r}; the port serves: "
                         + ", ".join(ids))
    return importlib.import_module(f".{mod}", __name__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cell_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-not) for an (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention layers ⇒ 500k KV cache is "
                       "O(S) per layer; skipped per assignment note")
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            out.append((arch, shape))
    return out


__all__ = ["ARCHS", "ARCH_IDS", "SHAPES", "ShapeSpec", "get_config",
           "get_smoke_config", "cell_runnable", "all_cells"]
