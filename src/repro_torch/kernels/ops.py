"""Public wrappers over the kernels (reference: ``repro/kernels/ops.py``:
the ``prep_*`` layouts, ``quant_matmul`` (grouped over experts for a 3-D
packed weight), ``quant_matmul_blockscale``,
``quant_matmul_int8``,
``neureka_conv2d`` and ``attention``; ``selective_scan`` has no counterpart
there, since the reference models call the jnp scan directly).

The reference picks a path by ``mode`` (pallas | interpret | xla).  The port
has one rule instead, applied by each kernel wrapper: a CUDA tensor launches
the Hopper kernel or raises, a CPU tensor takes the plain PyTorch version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import packing, quantize
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import neureka_conv as _nkc
from repro_torch.kernels import qmatmul as _qmm
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels.ref import QOffset


def prep_linear(w: torch.Tensor, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float -> (packed (out, ceil(in/f)) uint8, scale (out,))."""
    qt = quantize.quantize_weights(w, bits, channel_axis=0)
    return packing.pack(qt.values, bits), qt.scale


def prep_conv3x3(w: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, 3, 3, in) float -> (packed (out, 3, 3, ceil(in/f)), scale (out,))."""
    qt = quantize.quantize_weights(w, bits, channel_axis=0)
    return packing.pack(qt.values, bits), qt.scale


def prep_dw3x3(w: torch.Tensor, bits: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c, 3, 3) float -> (packed (c, ceil(9/f)), scale (c,))."""
    qt = quantize.quantize_weights(w.reshape(w.shape[0], 9), bits,
                                   channel_axis=0)
    return packing.pack(qt.values, bits), qt.scale


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 *, bits: int, k_orig: int) -> torch.Tensor:
    """Float activations x packed weights -> f32.  x may have leading dims.

    A 3-D ``packed`` (E, N, Kp) with scale (E, N) is a stack of experts:
    x must then be (E, C, K), and the grouped kernel gives (E, C, N) in
    one launch (the reference's vmapped ``quant_matmul``)."""
    if packed.ndim == 3:
        e, n = packed.shape[:2]
        if x.ndim != 3 or x.shape[0] != e or tuple(scale.shape) != (e, n):
            raise ValueError(
                f"grouped quant_matmul takes x (E, C, K), packed (E, N, Kp) "
                f"and scale (E, N); got x {tuple(x.shape)}, packed "
                f"{tuple(packed.shape)}, scale {tuple(scale.shape)}")
        return _qmm.qmatmul_f32_grouped(x.contiguous(), packed, scale,
                                        bits=bits, k_orig=k_orig)
    if packed.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"quant_matmul takes packed (N, Kp) and scale (N,) "
                         f"or a stack of experts, got packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _qmm.qmatmul_f32(x2, packed, scale, bits=bits, k_orig=k_orig)
    return out.reshape(*lead, -1)


def quant_matmul_blockscale(x: torch.Tensor, packed: torch.Tensor,
                            scales: torch.Tensor, *, bits: int, k_orig: int,
                            block: int = 32) -> torch.Tensor:
    """Float activations x *wire-form* packed weights (packed levels +
    per-(row, ``block``) scales) -> f32: the serving path of wire-served
    cold pages (``placement.wire_served_bits``).  x may have leading
    dims.  A stack of experts' packed weights is refused (ROADMAP B
    item 6)."""
    if packed.ndim != 2:
        raise NotImplementedError(
            f"wire-served packed {tuple(packed.shape)}: the grouped "
            "blockscale kernel for MoE experts under wire-served paging "
            "is not ported (ROADMAP B item 6)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _qmm.qmatmul_f32_blockscale(x2, packed, scales, bits=bits,
                                      k_orig=k_orig, block=block)
    return out.reshape(*lead, -1)


def quant_matmul_int8(x_q: torch.Tensor, packed: torch.Tensor,
                      mult: torch.Tensor, bias: torch.Tensor, *, bits: int,
                      k_orig: int) -> torch.Tensor:
    """uint8 activations x packed weights -> requantized uint8.  x_q may have
    leading dims."""
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, x_q.shape[-1]).contiguous()
    out = _qmm.qmatmul_int8(x2, packed, mult, bias, bits=bits, k_orig=k_orig)
    return out.reshape(*lead, -1)


def neureka_conv2d(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
                   bias: torch.Tensor, *, op: str, bits: int, cin: int,
                   stride: int = 1) -> torch.Tensor:
    """One N-EUREKA job: ``op`` in {dense3x3, dw3x3, pw1x1}; x (H, W, C)
    uint8 -> (ceil(H/s), ceil(W/s), Cout) uint8."""
    if op == "dense3x3":
        return _nkc.conv3x3_dense(x, packed, mult, bias, bits=bits, cin=cin,
                                  stride=stride)
    if op == "dw3x3":
        return _nkc.conv3x3_dw(x, packed, mult, bias, bits=bits,
                               stride=stride)
    if op == "pw1x1":
        return _nkc.conv1x1(x, packed, mult, bias, bits=bits, cin=cin,
                            stride=stride)
    raise ValueError(f"unknown N-EUREKA op {op!r}; expected dense3x3, "
                     "dw3x3 or pw1x1")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   h_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan -> (y f32, h_last), h_last written into
    ``h_out`` when given; see
    :func:`repro_torch.kernels.ssm_scan.selective_scan`."""
    return _ssm.selective_scan(x, dt, A, B, C, D, h0, h_out=h_out)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None,
              q_offset: QOffset = None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) attention, or the folded (B*H, S, D)
    form; see :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale, window=window,
                               q_offset=q_offset)
