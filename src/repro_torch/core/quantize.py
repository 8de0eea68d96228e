"""Symmetric per-channel weight quantization (NEMO style).

Ports ``repro/core/quantize.py:57-76`` (``weight_qrange``,
``quantize_weights``) and ``:98-148`` (``RequantParams``, ``fold_requant``,
``requantize``).  ``torch.round`` rounds half to even, as ``jnp.round``
does, and the divisions are the same f32 divisions on either device, so
the levels, scales and folded requant parameters are bit-identical to the
(eager) reference's.

The QAT half (``_ste_round``, ``fake_quant_weights``;
``repro/core/quantize.py:150-173``) rounds forward and passes the gradient
straight through backward, as the reference's ``jax.custom_vjp`` does.

The page wire codec (``PAGE_SCALE_BLOCK``, ``quantize_blockwise``,
``dequantize_blockwise``; ``repro/core/quantize.py:195-243``) is a copy of
the reference's host-side numpy code, so its levels and scales are
byte-identical: it runs on the host when a paged store is built and at
every decoding fetch, never on the card.

The activation quantizers (``quantize_activations``,
``calibrate_activation_scale``; ``quantize.py:79-95``) and the two matmul
oracles (``int8_matmul_reference``, ``dequant_matmul_reference``;
``:177-186``) are the reference's too; the percentiles interpolate
linearly, as ``jnp.percentile`` (and ``torch.quantile``) do by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

# Fractional bits of the folded integer requant multiplier (the reference's
# REQUANT_SHIFT_BITS): 24 bits keep the requant error < 2^-16 relative.
REQUANT_SHIFT_BITS = 24


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Signed integer levels (int8 storage) plus one f32 scale per output
    channel (axis 0)."""

    values: torch.Tensor
    scale: torch.Tensor
    bits: int

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self) -> torch.Tensor:
        scale = self.scale.reshape((-1,) + (1,) * (self.values.ndim - 1))
        return self.values.to(torch.float32) * scale


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
    # divide by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, which is not the reference's
    # f32 division (nor the CPU's)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(flat / scale[:, None]), qmin, qmax)
    return QuantizedTensor(values=q.to(torch.int8).reshape(w.shape),
                           scale=scale, bits=bits)


def quantize_activations(x: torch.Tensor,
                         scale: Union[torch.Tensor, float],
                         zero_point: Union[torch.Tensor, int] = 0
                         ) -> torch.Tensor:
    """Asymmetric uint8 activation quantization with a given scale / zp."""
    # a tensor divisor: on the card a division by a Python number is a
    # multiply by its rounded reciprocal
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.round(x / scale) + zero_point
    return torch.clamp(q, 0, 255).to(torch.uint8)


def _percentile(flat: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(flat, p)``: linear interpolation between the order
    statistics at floor and ceil of ``q * (n - 1)``, ``q = p / 100``
    (``torch.quantile``'s default method), written out in the reference's
    f32 steps.  ``jnp.percentile`` is jitted, and XLA folds its constants
    into ``q * (n - 1) = p * ((n - 1) * 0.01)`` and fuses the last multiply
    into the add: ``fma(high, w, low * (1 - w))``, here an exact f64
    product and sum rounded once to f32."""
    f32 = dict(dtype=torch.float32, device=flat.device)
    a = torch.sort(flat).values
    n = a.numel()
    step = (torch.tensor(float(n - 1), **f32)
            * torch.tensor(0.01, **f32))
    q = torch.tensor(p, **f32) * step
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1 - w_high
    lo_v = a[int(torch.clamp(low, 0, n - 1))]
    hi_v = a[int(torch.clamp(high, 0, n - 1))]
    fused = (hi_v.to(torch.float64) * w_high.to(torch.float64)
             + (lo_v * w_low).to(torch.float64))
    return fused.to(torch.float32)


def calibrate_activation_scale(x: torch.Tensor, percentile: float = 100.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick (scale, zero_point) so that the observed range maps onto
    [0, 255]: the range's ends are the ``100 - percentile`` and
    ``percentile`` percentiles, linearly interpolated."""
    flat = x.reshape(-1).to(torch.float32)
    lo = _percentile(flat, 100.0 - percentile)
    hi = _percentile(flat, percentile)
    lo = torch.minimum(lo, torch.zeros_like(lo))
    hi = torch.maximum(hi, lo + 1e-8)
    scale = (hi - lo) / torch.full_like(hi, 255.0)
    zp = torch.clamp(torch.round(-lo / scale), 0, 255).to(torch.int32)
    return scale, zp


@dataclasses.dataclass(frozen=True)
class RequantParams:
    """Integer-domain requantization parameters (per output channel):
    ``y = clip(((acc * mult) >> shift) + bias, 0, 255)`` with an int32
    fixed-point ``mult``, a global right ``shift`` and an int32 ``bias``
    that folds the float bias and the output zero-point."""

    mult: torch.Tensor    # (C,) int32
    bias: torch.Tensor    # (C,) int32
    shift: int


def fold_requant(w_scale: torch.Tensor,
                 in_scale: Union[torch.Tensor, float],
                 out_scale: Union[torch.Tensor, float],
                 bias_fp: Optional[torch.Tensor],
                 out_zero_point: int = 0) -> RequantParams:
    """Fold float scales into the NEMO integer (mult, shift, bias) triple:
    ``acc * (w_scale*in_scale/out_scale) + bias_fp/out_scale + zp``."""
    # a tensor divisor, for a true f32 division on the card too
    out_scale = torch.as_tensor(out_scale, dtype=torch.float32,
                                device=w_scale.device)
    rescale = w_scale * in_scale / out_scale                     # (C,) f32
    mult = torch.round(rescale * (1 << REQUANT_SHIFT_BITS)).to(torch.int32)
    if bias_fp is None:
        bias_fp = torch.zeros_like(w_scale)
    bias = torch.round(bias_fp / out_scale).to(torch.int32) + out_zero_point
    return RequantParams(mult=mult, bias=bias, shift=REQUANT_SHIFT_BITS)


def requantize(acc: torch.Tensor, rq: RequantParams) -> torch.Tensor:
    """int32 accumulators -> uint8 through N-EUREKA's NORMQUANT projection.

    As the reference, the 48-bit intermediate of the silicon is emulated in
    f32 and rounds half up, ``floor(x + 0.5)`` (not half to even).  The
    multiply and the add stay two separate torch ops, so no fused
    multiply-add changes the rounding.
    """
    rescale = rq.mult.to(torch.float32) / float(1 << rq.shift)
    y = acc.to(torch.float32) * rescale
    y = torch.floor(y + 0.5)
    y = y + rq.bias.to(torch.float32)
    return torch.clamp(y, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Fake-quant (QAT): straight-through estimators so training can see the
# quantization grid the serving path will use (``quantize.py:150-173``).
# ---------------------------------------------------------------------------

class _STERound(torch.autograd.Function):
    """Round half to even forward; the gradient passes through unchanged
    (the reference's ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


_ste_round = _STERound.apply


def fake_quant_weights(w: torch.Tensor, bits: int,
                       channel_axis: int = 0) -> torch.Tensor:
    """Differentiable (STE) symmetric per-channel weight fake-quantization."""
    qmin, qmax = weight_qrange(bits)
    wm = torch.movedim(w, channel_axis, 0)
    flat = wm.reshape(wm.shape[0], -1)
    absmax = flat.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        torch.ones_like(absmax))
    # minimum / maximum, not clamp: at a bound they split the gradient in
    # halves, as jnp.clip does; clamp passes all of it
    q = torch.minimum(torch.maximum(_ste_round(flat / scale),
                                    torch.full_like(flat, qmin)),
                      torch.full_like(flat, qmax)) * scale
    return torch.movedim(q.reshape(wm.shape), 0, channel_axis)


def int8_matmul_reference(x_q: torch.Tensor, w_q: torch.Tensor
                          ) -> torch.Tensor:
    """int8 x int8 -> int32 matmul in integer arithmetic (oracle helper)."""
    # torch has no int32 GEMM: the exact int64 product wrapped to int32 is
    # the reference's int32 accumulation (both wrap modulo 2^32)
    return torch.matmul(x_q.to(torch.int64), w_q.to(torch.int64)).to(
        torch.int32)


def dequant_matmul_reference(x: torch.Tensor, qt: QuantizedTensor
                             ) -> torch.Tensor:
    """Float activations x quantized weights, computed at full precision."""
    return torch.matmul(x, qt.dequantize().T)


# ---------------------------------------------------------------------------
# Per-block wire codec: the page encoding of ``core/paging.py``.  Cold pages
# cross the host->device link re-encoded at ``page_bits`` with one scale per
# (row, block) group instead of one per output channel.
# ---------------------------------------------------------------------------

# Weights per scale of the page codec: 4/32 = 12.5 % scale bytes on an int8
# payload, matching the N-EUREKA 32-weight fetch granule.
PAGE_SCALE_BLOCK = 32


def quantize_blockwise(w: np.ndarray, bits: int,
                       block: int = PAGE_SCALE_BLOCK
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-(row, block) quantization along the last axis.

    Returns ``(levels, scales)``: ``levels`` int8 of ``w.shape``, ``scales``
    float32 ``(rows, ceil(k / block))``.  A trailing block shorter than
    ``block`` gets its own scale over just the tail elements.
    """
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    qmin, qmax = weight_qrange(bits)
    w = np.asarray(w, np.float32)
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D (rows, k) tensor, got {w.shape}")
    rows, k = w.shape
    nblk = -(-k // block)
    wp = np.pad(w, ((0, 0), (0, nblk * block - k)))
    groups = wp.reshape(rows, nblk, block)
    absmax = np.abs(groups).max(axis=2)
    scales = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)
    q = np.clip(np.round(groups / scales[:, :, None]), qmin, qmax)
    levels = q.astype(np.int8).reshape(rows, nblk * block)[:, :k]
    return levels, scales


def dequantize_blockwise(levels: np.ndarray, scales: np.ndarray,
                         block: int = PAGE_SCALE_BLOCK) -> np.ndarray:
    """Inverse of :func:`quantize_blockwise`: levels x per-block scales."""
    levels = np.asarray(levels)
    rows, k = levels.shape
    nblk = scales.shape[1]
    lp = np.pad(levels.astype(np.float32), ((0, 0), (0, nblk * block - k)))
    out = lp.reshape(rows, nblk, block) * scales[:, :, None].astype(np.float32)
    return out.reshape(rows, nblk * block)[:, :k]
