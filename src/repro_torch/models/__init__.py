"""The decoder in PyTorch: configuration, layers and the transformer's
entry points (the port of :mod:`repro.models`)."""

from .config import LayerKind, MLAConfig, ModelConfig
from .sharding import Rules
from .transformer import (Transformer, cache_specs, decode_step, forward,
                          init_cache, init_params, lm_loss, param_specs,
                          prefill)

__all__ = [
    "LayerKind", "MLAConfig", "ModelConfig", "Rules", "Transformer",
    "cache_specs", "decode_step", "forward", "init_cache", "init_params",
    "lm_loss", "param_specs", "prefill",
]
