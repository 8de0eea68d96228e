"""N-EUREKA's convolution operators, as Hopper kernels.

Ports ``repro/kernels/neureka_conv.py``: the three operators the silicon
supports (paper §II-C) over HWC uint8 maps with packed 2/4/8-bit weights
and the per-channel NORMQUANT requant to uint8.

- ``conv3x3_dense`` (``_dense3x3_kernel``) and ``conv3x3_dw``
  (``_dw3x3_kernel``) launch ``csrc/neureka_conv.cu``; the dense one is an
  implicit GEMM on the int8 tensor cores, with the block tile that
  ``dense_plan`` chooses, the depthwise one channel vectors summed by
  ``dp4a``, with the plan (and the route: taps from a staged window or
  loaded direct) that ``dw_plan`` chooses;
- ``conv1x1`` is the strided slice plus ``qmatmul_int8``
  (``csrc/qmatmul_int8.cu``), as in the reference.

Stride is 1 or 2; the output is ceil(H/s) x ceil(W/s), with the input read
as zero outside the map (the reference's halo padding,
``neureka_conv.py:97-99``).  Each wrapper launches its kernel for CUDA
tensors and raises on anything it does not take.  For CPU tensors it
computes the plain PyTorch version (``kernels/ref.py``).
``conv3x3_dense.launches`` and ``conv3x3_dw.launches`` count kernel
launches (``conv1x1``'s are ``qmatmul_int8.launches``);
``conv3x3_dw.plans`` holds the plans of its latest 64 launches, newest
last.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.launch import forward_only
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


DW_THREADS = 128                 # the most threads a depthwise block
DW_WIDTHS = (16, 8, 4, 2, 1)     # channels (bytes) a thread
MAX_SMEM = 227 * 1024            # shared memory a block can have


class DwPlan(NamedTuple):
    """A ``conv3x3_dw`` launch: each thread takes ``vec`` channels of one
    output pixel; a block ``cg`` channels (a multiple of ``vec``) of
    ``rows`` output rows of ``tc`` pixels, so (cg / vec) * tc * rows
    threads.  ``staged``: the taps come from the block's input window
    staged in shared memory; otherwise each thread loads its nine taps
    from the map into registers."""
    vec: int
    cg: int
    tc: int
    rows: int
    staged: bool
    blocks: int

    @property
    def threads(self) -> int:
        return self.cg // self.vec * self.tc * self.rows


def dw_vec(c: int, width: int = 16) -> int:
    """The widest of DW_WIDTHS, at most ``width``, that divides C."""
    return next(v for v in DW_WIDTHS if v <= width and c % v == 0)


def dw_smem(plan: DwPlan, stride: int) -> int:
    """Shared bytes of a block (csrc/neureka_conv.cu ``dw_layout``): the
    staged window, 3 level words, mult and bias for each channel."""
    def up(v):
        return -(-v // 16) * 16
    window = ((plan.rows - 1) * stride + 3) * (
        (plan.tc - 1) * stride + 3) * plan.cg
    return (up(window) if plan.staged else 0) + up(12 * plan.cg) \
        + 2 * up(4 * plan.cg)


def dw_tile(h: int, w: int, c: int, stride: int, vec: int, cg: int,
            threads: int, staged: bool = True) -> DwPlan:
    """The plan of ``vec`` channels a thread and ``cg`` channels a block
    that has at most ``threads`` threads, with the output's rows and
    columns cut into equal tiles."""
    ho, wo = -(-h // stride), -(-w // stride)
    nv = cg // vec
    tc = -(-wo // -(-wo // max(1, threads // nv)))
    rows = max(1, min(ho, 64, threads // (nv * tc)))
    rows = -(-ho // -(-ho // rows))
    blocks = -(-wo // tc) * -(-ho // rows) * -(-c // cg)
    return DwPlan(vec, cg, tc, rows, staged, blocks)


def dw_groups(c: int, vec: int) -> list:
    """Channel groups a block can take: vec times 1-32 (at most C, and at
    most DW_THREADS threads a row of one pixel), and C itself."""
    out = {vec * n for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
           if vec * n <= c}
    if c // vec <= DW_THREADS:
        out.add(c)
    return sorted(out)


def dw_plans(h: int, w: int, c: int, stride: int, width: int = 16) -> list:
    """Every plan the sweep times at one shape: the widest vector, each
    channel group and thread budget (64 and 128), each route."""
    vec = dw_vec(c, width)
    plans = {dw_tile(h, w, c, stride, vec, cg, t, staged)
             for staged in (True, False) for cg in dw_groups(c, vec)
             for t in (64, DW_THREADS) if cg // vec <= t}
    return sorted(plans)


@functools.lru_cache(maxsize=None)
def dw_plan(h: int, w: int, c: int, stride: int,
            width: int = 16) -> DwPlan:
    """The plan ``conv3x3_dw`` launches: the widest vector that divides C
    and ``width`` (the map pointers' alignment), two vectors of channels a
    block (one where C holds one), DW_THREADS threads at most, the
    output's rows and columns cut into equal tiles; the window staged
    where a block holds several output rows at stride 1 (a staged byte
    then serves up to 9 of its outputs), the taps loaded straight to
    registers otherwise.  From ``tools/neureka_ab.py --sweep --op dw3x3``
    on an H100 SXM (every plan of ``dw_plans`` at the 10 MobileNet-V2
    depthwise shapes, each 2.3-3.7 us): 32-channel groups beat the others
    by 1-8 % but at b3.dw (2.4 % behind 64), the direct route beat the
    staged one by 2-10 % at stride 2 and at the one-row blocks of b0.dw
    and b2.dw, and lost by 1-5 % at the stride-1 maps of 7-28 rows.  The
    same sweep also timed two and four pixels a thread (slower than one
    by 6-41 % and 25-103 %) and 256-thread blocks (never more than 0.4 %
    faster than the best of 128 threads, up to 17 % slower), which the
    kernel therefore does not take.  No SM count enters: the best plans
    ran from 18 to 280 blocks."""
    vec = dw_vec(c, width)
    plan = dw_tile(h, w, c, stride, vec, min(c, 2 * vec), DW_THREADS)
    return plan._replace(staged=stride == 1 and plan.rows > 1)


def _check(name: str, x, packed, mult, bias, bits: int, stride: int,
           channels: int, packed_shape):
    """Device, type, shape and contiguity checks shared by the 3x3 ops."""
    tensors = (x, packed, mult, bias)
    forward_only(name, *tensors)
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
               bias: torch.Tensor, *, bits: int, stride: int = 1,
               plan: Optional[DwPlan] = None) -> torch.Tensor:
    """Depthwise 3x3: x (H, W, C) uint8, packed (C, ceil(9/f)) along the
    nine taps (t = 3i + j) -> (ceil(H/s), ceil(W/s), C) uint8.  ``plan``
    overrides ``dw_plan``'s (for sweeps and tests); a plan the kernel
    cannot take raises."""
    if {t.device.type for t in (x, packed, mult, bias)} == {"cpu"}:
        return ref.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride)
    c = x.shape[-1] if x.ndim == 3 else -1
    kp = -(-9 // (8 // bits)) if bits in (2, 4, 8) else -1
    _check("conv3x3_dw", x, packed, mult, bias, bits, stride, c, (c, kp))
    if x.numel() >= 2 ** 31:
        raise ValueError(f"conv3x3_dw indexes the map in 32 bits: "
                         f"{tuple(x.shape)} is too large")
    out = _out(x, stride, c)
    if out.numel() == 0:
        return out
    h, w, _ = x.shape
    if plan is None:
        plan = dw_plan(h, w, c, stride, copy_width(
            c, x.data_ptr() | out.data_ptr(), DW_WIDTHS[:-1]))
    rc = _launcher("conv3x3_dw", 11)(
        x.data_ptr(), packed.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        out.data_ptr(), h, w, c, kp, stride, bits, plan.vec,
        plan.cg, plan.tc, plan.rows, int(plan.staged),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_dw launch failed: CUDA error {rc} "
                           f"({plan})")
    conv3x3_dw.launches += 1
    conv3x3_dw.plans.append(plan)
    return out


conv3x3_dw.launches = 0
conv3x3_dw.plans = collections.deque(maxlen=64)   # of the latest launches


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
