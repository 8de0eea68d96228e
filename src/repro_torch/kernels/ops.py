"""Public wrappers over the kernels (reference: ``repro/kernels/ops.py:42-75``
and ``:147-158``).

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
from repro_torch.kernels import qmatmul as _qmm
from repro_torch.kernels.ref import QOffset


def prep_linear(w: torch.Tensor, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float -> (packed (out, ceil(in/f)) uint8, scale (out,))."""
    qt = quantize.quantize_weights(w, bits, channel_axis=0)
    return packing.pack(qt.values, bits), qt.scale


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 *, bits: int, k_orig: int) -> torch.Tensor:
    """Float activations x packed weights -> f32.  x may have leading dims."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _qmm.qmatmul_f32(x2, packed, scale, bits=bits, k_orig=k_orig)
    return out.reshape(*lead, -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None,
              q_offset: QOffset = None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Sk, D) attention, or the folded (B*H, S, D)
    form; see :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale, window=window,
                               q_offset=q_offset)
