"""Sub-byte weight packing — the MRAM density model.

Ports ``pack`` / ``unpack`` of ``repro/core/packing.py``.  Signed levels
become offset-binary fields, little-endian within a byte, packed along the
*last* axis (the reduction axis of the matmuls), which is padded to a
multiple of the packing factor.  The carriers are byte-identical to the
reference's.
"""

from __future__ import annotations

import torch

SUPPORTED_BITS = (2, 4, 8)


def packing_factor(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"packing supports bits in {SUPPORTED_BITS}, got {bits}")
    return 8 // bits


def packed_last_dim(n: int, bits: int) -> int:
    f = packing_factor(bits)
    return (n + f - 1) // f


def _to_unsigned(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Map signed levels [-2^(b-1), 2^(b-1)-1] -> unsigned field [0, 2^b-1]."""
    return (levels.to(torch.int32) + (1 << (bits - 1))).to(torch.uint8)


def _to_signed(field: torch.Tensor, bits: int) -> torch.Tensor:
    return (field.to(torch.int32) - (1 << (bits - 1))).to(torch.int8)


def pack(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed integer levels (int8 storage) into a uint8 carrier.

    levels: (..., K) int8 with values in the signed ``bits`` range.
    returns: (..., ceil(K / (8//bits))) uint8.
    """
    f = packing_factor(bits)
    if f == 1:
        return _to_unsigned(levels, 8)
    *lead, k = levels.shape
    pad = (-k) % f
    if pad:
        levels = torch.nn.functional.pad(levels.to(torch.int32), (0, pad))
    u = _to_unsigned(levels, bits).reshape(*lead, (k + pad) // f, f)
    shifts = torch.arange(f, dtype=torch.int32, device=levels.device) * bits
    return (u.to(torch.int32) << shifts).sum(dim=-1).to(torch.uint8)


def unpack(packed: torch.Tensor, bits: int, orig_k: int) -> torch.Tensor:
    """Inverse of :func:`pack` — returns int8 signed levels of length orig_k."""
    f = packing_factor(bits)
    if f == 1:
        return _to_signed(packed, 8)[..., :orig_k]
    shifts = torch.arange(f, dtype=torch.int32, device=packed.device) * bits
    fields = (packed[..., None].to(torch.int32) >> shifts) & ((1 << bits) - 1)
    levels = _to_signed(fields, bits)
    *lead, kp, _ = levels.shape
    return levels.reshape(*lead, kp * f)[..., :orig_k]
