"""Data pipeline."""

from .synthetic import SyntheticLM, Batch

__all__ = ["SyntheticLM", "Batch"]
