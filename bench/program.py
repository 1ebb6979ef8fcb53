"""The system under test, as the benchmark builds it: the program's
model configuration from a configuration file, and its model filled
with the benchmark's weights (:mod:`bench.weights`).

This is the one module of the benchmark, with the drivers, that imports
the program (``repro_torch``, from the checkout's ``src/``)."""

from __future__ import annotations

import importlib
import sys

import torch

from .model import Dims
from .spec import ROOT
from .weights import fill_model

__all__ = ["import_program", "model_config", "build_model", "reference"]

#: the program's configuration fields that :class:`Dims` sets
_FIELDS = ("n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "d_ff",
           "vocab", "n_experts", "top_k", "capacity_factor", "moe_seq_chunk",
           "rope_theta", "window", "norm_eps", "tie_embeddings")


def import_program():
    """The program's package, from the checkout's ``src/``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return importlib.import_module("repro_torch")


def reference(d: Dims):
    """The plain reference of the configuration's family."""
    return importlib.import_module(f"bench.reference.{d.family}")


def model_config(d: Dims, config: dict, **settings):
    """The program's ``ModelConfig``: its configuration of ``arch`` with
    every size the benchmark states, and the program's own settings."""
    import_program()
    from repro_torch.configs import get_config
    kw = {name: getattr(d, name) for name in _FIELDS
          if not (name in ("n_experts", "top_k") and d.kind != "moe")}
    kw.update({k: v for k, v in d.program.items()
               if k not in ("prefill_bucket_min",)})
    kw.update(settings)
    cfg = get_config(config["arch"]).replace(**kw)
    if cfg.window is None:
        cfg = cfg.replace(local_mask=None)
    return cfg


def build_model(d: Dims, config: dict, seed: int, device, **settings):
    """(the program's config, its model on ``device`` filled with the
    benchmark's weights for ``seed``)."""
    import_program()
    from repro_torch.models.transformer import Transformer
    cfg = model_config(d, config, **settings)
    model = Transformer(cfg, device=torch.device(device))
    fill_model(reference(d).groups(d), seed, dict(model.named_parameters()))
    return cfg, model
