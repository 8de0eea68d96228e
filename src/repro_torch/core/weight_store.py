"""Packed read-only weight store — the MRAM analogue.

Ports ``PackedParam`` of ``repro/core/weight_store.py``: one packed weight
matrix (a uint8 carrier of 2/4/8-bit fields) with its per-channel f32
scales.  The store-level ``WeightStore`` / ``freeze`` and the capacity
accounting arrive with the paging slice; the MRAM capacity constant is here
already, for ``placement.plan_for_budget``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import packing

# Siracusa's weight MRAM (paper §II-B; ``repro/core/weight_store.py:34``)
SIRACUSA_MRAM_BYTES = 4 * 1024 * 1024


@dataclasses.dataclass
class PackedParam:
    """One packed weight matrix + its dequant metadata."""

    packed: torch.Tensor              # (..., K_packed) uint8 carrier
    scale: torch.Tensor               # (out_channels,) float32
    bits: int
    orig_shape: Tuple[int, ...]

    def unpack_levels(self) -> torch.Tensor:
        """Materialize int8 levels (reference / non-fused paths)."""
        return packing.unpack(self.packed, self.bits, self.orig_shape[-1])

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        lv = self.unpack_levels().to(dtype)
        scale = self.scale.to(dtype).reshape(
            (-1,) + (1,) * (len(self.orig_shape) - 1))
        return lv * scale
