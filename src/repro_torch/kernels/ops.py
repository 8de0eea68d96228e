"""Public wrappers over the kernels (reference: ``repro/kernels/ops.py``:
the ``prep_*`` layouts, ``quant_matmul`` and ``quant_matmul_blockscale``
(each grouped over experts for a 3-D packed weight),
``quant_matmul_int8``,
``neureka_conv2d`` and ``attention``; ``selective_scan`` has no counterpart
there, since the reference models call the jnp scan directly).

The reference picks a path by ``mode`` (pallas | interpret | xla).  The port
has one rule instead, applied by each kernel wrapper: a CUDA tensor launches
the Hopper kernel or raises, a CPU tensor takes the plain PyTorch version.
Nothing falls back from one to the other.  The serve kernels an LM reaches
(``quant_matmul`` and its grouped form, ``attention``, ``selective_scan``)
also take inputs that all lie on ``meta``, which hold shapes and no data:
they give ``meta`` outputs of the kernel's shapes and dtypes and report the
kernel's FLOPs and bytes to the dry-run's cost counter
(``launch/hlo_analysis.py``).  A ``meta`` input beside a CUDA or CPU one
raises.
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
    dims.

    A 3-D ``packed`` (E, N, Kp) with scales (E, N, nblk) is a stack of
    experts' wire-form pages: x must then be (E, C, K), and the grouped
    kernel gives (E, C, N) in one launch (the reference's vmapped
    ``quant_matmul_blockscale``)."""
    if packed.ndim == 3:
        e, n = packed.shape[:2]
        if (x.ndim != 3 or x.shape[0] != e or scales.ndim != 3
                or tuple(scales.shape[:2]) != (e, n)):
            raise ValueError(
                f"grouped quant_matmul_blockscale takes x (E, C, K), packed "
                f"(E, N, Kp) and scales (E, N, nblk); got x "
                f"{tuple(x.shape)}, packed {tuple(packed.shape)}, scales "
                f"{tuple(scales.shape)}")
        return _qmm.qmatmul_f32_blockscale_grouped(
            x.contiguous(), packed, scales, bits=bits, k_orig=k_orig,
            block=block)
    if packed.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"quant_matmul_blockscale takes packed (N, Kp) and "
                         f"scales (N, nblk) or a stack of experts, got "
                         f"packed {tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)}")
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
                   h_out: Optional[torch.Tensor] = None,
                   y_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan -> (y in x's dtype or ``y_dtype``, h_last),
    h_last written into ``h_out`` when given; see
    :func:`repro_torch.kernels.ssm_scan.selective_scan`."""
    return _ssm.selective_scan(x, dt, A, B, C, D, h0, h_out=h_out,
                               y_dtype=y_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None,
              q_offset: QOffset = None,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) attention, or the folded (B*H, S, D)
    form, out in q's dtype; see
    :func:`repro_torch.kernels.flash_attention.flash_attention`.

    ``compute_dtype`` (the config's ``attn_dtype``) other than f32 rounds
    where the reference's ``chunked_attention`` rounds: q is scaled in f32
    and rounded to it, k and v are rounded to it, and so is P before PV
    (the kernel's bf16 route and the plain version alike); the output comes
    back in q's dtype, unrounded where that is f32.
    At f32 q, k and v go to the kernel as they are: bf16 ones (a bf16
    ``dtype``) take its bf16 route with the scale applied to the f32
    scores and P kept f32-accurate, as the reference keeps p in f32."""
    if compute_dtype != torch.float32:
        d = q.shape[-1]
        scale = scale if scale is not None else 1.0 / (d ** 0.5)
        return _fa.flash_attention(
            (q.to(torch.float32) * scale).to(compute_dtype).contiguous(),
            k.to(compute_dtype).contiguous(), v.to(compute_dtype).contiguous(),
            causal=causal, scale=1.0, window=window, q_offset=q_offset,
            out_dtype=q.dtype, p_dtype=compute_dtype)
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale, window=window,
                               q_offset=q_offset)
