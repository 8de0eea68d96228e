"""Symmetric per-channel weight quantization (NEMO style).

Ports ``repro/core/quantize.py:57-76`` (``weight_qrange``,
``quantize_weights``).  ``torch.round`` rounds half to even, as
``jnp.round`` does, and the divisions are the same f32 divisions, so the
levels and scales are bit-identical to the reference's.  The activation,
requant and blockwise page-codec parts of the reference module arrive with
the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Signed integer levels (int8 storage) plus one f32 scale per output
    channel (axis 0)."""

    values: torch.Tensor
    scale: torch.Tensor
    bits: int


def weight_qrange(bits: int) -> Tuple[int, int]:
    """Symmetric signed range for a given bit-width (e.g. 4 -> [-8, 7])."""
    if not 2 <= bits <= 8:
        raise ValueError(f"weight bits must be in [2, 8], got {bits}")
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def quantize_weights(w: torch.Tensor, bits: int,
                     channel_axis: int = 0) -> QuantizedTensor:
    """Symmetric per-channel weight quantization to ``bits`` levels; the
    channel axis is moved to the front."""
    qmin, qmax = weight_qrange(bits)
    w = torch.movedim(w.to(torch.float32), channel_axis, 0)
    flat = w.reshape(w.shape[0], -1)
    absmax = flat.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(flat / scale[:, None]), qmin, qmax)
    return QuantizedTensor(values=q.to(torch.int8).reshape(w.shape),
                           scale=scale, bits=bits)
