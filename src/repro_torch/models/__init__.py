"""The decoder in PyTorch: configuration, layers and the transformer's
entry points (the port of :mod:`repro.models`)."""

from .config import LayerKind, ModelConfig
from .transformer import (Transformer, decode_step, forward, init_cache,
                          init_params, prefill)

__all__ = [
    "LayerKind", "ModelConfig", "Transformer",
    "decode_step", "forward", "init_cache", "init_params", "prefill",
]
