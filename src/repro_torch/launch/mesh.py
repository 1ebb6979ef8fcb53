"""The card's figures, and the sharding rules of a mesh — the port of
:mod:`repro.launch.mesh`.

The reference builds 256- and 512-chip TPU meshes
(``make_production_mesh``); this round of the port runs one card, so it
has no counterpart.  :class:`HW` holds one NVIDIA H100 SXM's figures in
place of one v5e chip's, for the roofline terms of
:mod:`repro_torch.launch.roofline` and the dry-run's fit check.
"""

from __future__ import annotations

from typing import Iterable

from ..models.sharding import Rules

__all__ = ["rules_for_mesh", "HW"]


def rules_for_mesh(axis_names: Iterable[str] = ("data", "model"),
                   overrides: dict | None = None) -> Rules:
    """The reference's rules for a mesh with these axis names: batch and
    FSDP over ``("pod", "data")`` where there is a pod axis, else over
    ``("data",)``; tensor parallelism over ``model``."""
    b = ("pod", "data") if "pod" in tuple(axis_names) else ("data",)
    return Rules(batch=b, fsdp=b, tp="model", overrides=overrides or {})


class HW:
    """NVIDIA H100 SXM (per card; NVIDIA's data sheet, dense) for the
    roofline terms."""

    PEAK_FLOPS = 989e12        # bf16 on the tensor cores
    PEAK_TF32_FLOPS = 495e12   # TF32 on the tensor cores
    PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
    HBM_BW = 3.35e12           # bytes/s
    ICI_BW = 450e9             # NVLink bytes/s a direction (unused on one card)
    HBM_BYTES = 80e9
