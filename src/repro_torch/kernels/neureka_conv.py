"""N-EUREKA's convolution operators, as Hopper kernels.

Ports ``repro/kernels/neureka_conv.py``: the three operators the silicon
supports (paper §II-C) over HWC uint8 maps with packed 2/4/8-bit weights
and the per-channel NORMQUANT requant to uint8.

- ``conv3x3_dense`` (``_dense3x3_kernel``) and ``conv3x3_dw``
  (``_dw3x3_kernel``) launch ``csrc/neureka_conv.cu``; the dense one is an
  implicit GEMM on the int8 tensor cores, with the block tile that
  ``dense_plan`` chooses;
- ``conv1x1`` is the strided slice plus ``qmatmul_int8``
  (``csrc/qmatmul_int8.cu``), as in the reference.

Stride is 1 or 2; the output is ceil(H/s) x ceil(W/s), with the input read
as zero outside the map (the reference's halo padding,
``neureka_conv.py:97-99``).  Each wrapper launches its kernel for CUDA
tensors and raises on anything it does not take.  For CPU tensors it
computes the plain PyTorch version (``kernels/ref.py``).
``conv3x3_dense.launches`` and ``conv3x3_dw.launches`` count kernel
launches (``conv1x1``'s are ``qmatmul_int8.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.qmatmul import copy_width, qmatmul_int8

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher(name: str, n_ints: int):
    """``<name>_launch(x, packed, mult, bias, out, <n_ints ints>, stream)``."""
    fn = getattr(build.library("neureka_conv"), f"{name}_launch")
    fn.argtypes = [_c_ptr] * 5 + [_c_int] * n_ints + [_c_ptr]
    fn.restype = _c_int
    return fn


DENSE_BN = 16        # output channels a dense block


class DensePlan(NamedTuple):
    """A ``conv3x3_dense`` launch: blocks of ``rows`` output rows by ``tw``
    output pixels (the MMA's M) by DENSE_BN output channels (N)."""
    rows: int
    tw: int
    blocks: int


def dense_tile(h: int, w: int, cout: int, stride: int, rows: int,
               tw: int) -> DensePlan:
    ho, wo = -(-h // stride), -(-w // stride)
    return DensePlan(rows, tw, -(-wo // tw) * -(-ho // rows)
                     * -(-cout // DENSE_BN))


def dense_plan(h: int, w: int, cout: int, stride: int) -> DensePlan:
    """The tile ``conv3x3_dense`` launches for an (h, w) map: output
    rows cut into equal parts of at most 32 pixels, and as many rows as
    keep a block within 64 pixels (one 16-pixel MMA tile a warp); conv0
    gets 2 rows of 28 pixels, 448 blocks.  From conv0's times on an H100
    SXM (``tools/neureka_ab.py --sweep``): 56-64 pixels by 16 channels
    beat every wider or taller tile."""
    ho, wo = -(-h // stride), -(-w // stride)
    tw = -(-wo // -(-wo // 32))
    return dense_tile(h, w, cout, stride, max(1, min(ho, 64 // tw)), tw)


def _check(name: str, x, packed, mult, bias, bits: int, stride: int,
           channels: int, packed_shape):
    """Device, type, shape and contiguity checks shared by the 3x3 ops."""
    tensors = (x, packed, mult, bias)
    if ({t.device.type for t in tensors} != {"cuda"}
            or len({t.device for t in tensors}) != 1):
        raise ValueError(f"{name} needs x, packed, mult and bias on one CUDA "
                         "device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if (x.dtype, packed.dtype, mult.dtype, bias.dtype) != (
            torch.uint8, torch.uint8, torch.float32, torch.int32):
        raise TypeError(f"{name} takes uint8 x and packed, float32 mult and "
                        f"int32 bias, got {x.dtype}, {packed.dtype}, "
                        f"{mult.dtype}, {bias.dtype}")
    n_out = packed.shape[0] if packed.ndim else -1
    if (x.ndim != 3 or x.shape[2] != channels
            or tuple(packed.shape) != tuple(packed_shape)
            or tuple(mult.shape) != (n_out,) or tuple(bias.shape) != (n_out,)):
        raise ValueError(f"{name}: shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)} (want {tuple(packed_shape)}),"
                         f" mult {tuple(mult.shape)}, bias "
                         f"{tuple(bias.shape)}, bits={bits}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous x, packed, mult and bias")


def _out(x: torch.Tensor, stride: int, channels: int) -> torch.Tensor:
    h, w, _ = x.shape
    return torch.empty((-(-h // stride), -(-w // stride), channels),
                       dtype=torch.uint8, device=x.device)


def _launch_dense(x, packed, mult, bias, out, bits: int, cin: int,
                  stride: int, plan: DensePlan):
    h, w, _ = x.shape
    cout, cinp = packed.shape[0], packed.shape[3]
    rc = _launcher("conv3x3_dense", 12)(
        x.data_ptr(), packed.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        out.data_ptr(), h, w, cin, cout, cinp, stride, bits, plan.rows,
        plan.tw, copy_width(w * cin, x.data_ptr()),
        copy_width(9 * cinp, packed.data_ptr()),
        copy_width(cout, out.data_ptr(), (16, 8, 4, 2)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_dense launch failed: CUDA error {rc}")


def conv3x3_dense(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
                  bias: torch.Tensor, *, bits: int, cin: int,
                  stride: int = 1) -> torch.Tensor:
    """x (H, W, Cin) uint8, packed (Cout, 3, 3, ceil(Cin/f)) -> (ceil(H/s),
    ceil(W/s), Cout) uint8."""
    if {t.device.type for t in (x, packed, mult, bias)} == {"cpu"}:
        return ref.conv3x3_dense(x, packed, mult, bias, bits=bits, cin=cin,
                                 stride=stride)
    cout = packed.shape[0] if packed.ndim == 4 else -1
    cinp = -(-cin // (8 // bits)) if bits in (2, 4, 8) else -1
    _check("conv3x3_dense", x, packed, mult, bias, bits, stride, cin,
           (cout, 3, 3, cinp))
    out = _out(x, stride, cout)
    if out.numel() == 0:
        return out
    h, w, _ = x.shape
    _launch_dense(x, packed, mult, bias, out, bits, cin, stride,
                  dense_plan(h, w, cout, stride))
    conv3x3_dense.launches += 1
    return out


conv3x3_dense.launches = 0


def conv3x3_dw(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
               bias: torch.Tensor, *, bits: int,
               stride: int = 1) -> torch.Tensor:
    """Depthwise 3x3: x (H, W, C) uint8, packed (C, ceil(9/f)) along the
    nine taps (t = 3i + j) -> (ceil(H/s), ceil(W/s), C) uint8."""
    if {t.device.type for t in (x, packed, mult, bias)} == {"cpu"}:
        return ref.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride)
    c = x.shape[-1] if x.ndim == 3 else -1
    kp = -(-9 // (8 // bits)) if bits in (2, 4, 8) else -1
    _check("conv3x3_dw", x, packed, mult, bias, bits, stride, c, (c, kp))
    out = _out(x, stride, c)
    if out.numel() == 0:
        return out
    h, w, _ = x.shape
    rc = _launcher("conv3x3_dw", 6)(
        x.data_ptr(), packed.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        out.data_ptr(), h, w, c, kp, stride, bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_dw launch failed: CUDA error {rc}")
    conv3x3_dw.launches += 1
    return out


conv3x3_dw.launches = 0


def conv1x1(x: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
            bias: torch.Tensor, *, bits: int, cin: int,
            stride: int = 1) -> torch.Tensor:
    """Pointwise conv: x (H, W, Cin) uint8 -> (ceil(H/s), ceil(W/s), Cout)
    through ``qmatmul_int8``.  A strided ``x[::s, ::s]`` is copied to a
    contiguous map first (the kernel takes rows of K bytes)."""
    if stride != 1:
        x = x[::stride, ::stride, :]
    h, w, c = x.shape
    out = qmatmul_int8(x.contiguous().reshape(h * w, c), packed, mult, bias,
                       bits=bits, k_orig=cin)
    return out.reshape(h, w, -1)
