"""Sub-byte weight packing — the MRAM density model.

Ports ``repro/core/packing.py``.  Signed levels become offset-binary
fields, little-endian within a byte, packed along the *last* axis (the
reduction axis of the matmuls), which is padded to a multiple of the
packing factor.  The carriers are byte-identical to the reference's.  The
capacity helpers (``packed_nbytes``, ``mram_rows``) and the bit-plane view
(``to_bitplanes`` / ``from_bitplanes``) are the reference's too.
"""

from __future__ import annotations

from typing import Tuple

import torch

SUPPORTED_BITS = (2, 4, 8)

# One MRAM row in Siracusa = 256 bits; the memsys model counts row reads
MRAM_ROW_BITS = 256


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


def packed_nbytes(shape: Tuple[int, ...], bits: int) -> int:
    """Bytes occupied by a packed tensor of the given *unpacked* shape."""
    *lead, k = shape
    n = 1
    for d in lead:
        n *= int(d)
    return n * packed_last_dim(k, bits)


def mram_rows(shape: Tuple[int, ...], bits: int) -> int:
    """Number of 256-bit MRAM rows the tensor occupies (memsys accounting)."""
    return -(-packed_nbytes(shape, bits) * 8 // MRAM_ROW_BITS)


# ---------------------------------------------------------------------------
# Bit-plane layout (the bit-serial view): N-EUREKA fetches weights one bit
# plane at a time in the 3x3 modes, and the memsys cycle model charges
# ``bits`` planes per weight block.
# ---------------------------------------------------------------------------

def to_bitplanes(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Decompose signed levels into ``bits`` binary planes (offset-binary).

    Returns uint8 (bits, ...) with plane b = bit b of the unsigned
    offset-binary encoding; levels = sum_b plane_b * 2^b - 2^(bits-1).
    """
    u = _to_unsigned(levels, bits)
    return torch.stack([(u >> b) & 1 for b in range(bits)], dim=0)


def from_bitplanes(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes` -> int8 signed levels."""
    weights = (2 ** torch.arange(bits, dtype=torch.int32,
                                 device=planes.device)).reshape(
        (bits,) + (1,) * (planes.ndim - 1))
    u = (planes.to(torch.int32) * weights).sum(dim=0)
    return (u - (1 << (bits - 1))).to(torch.int8)
