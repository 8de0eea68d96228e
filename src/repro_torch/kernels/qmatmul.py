"""Fused dequant matmuls — the At-MRAM weight path, as Hopper kernels.

Ports the three kernels of ``repro/kernels/qmatmul.py``:

- ``qmatmul_f32`` (``_qmatmul_f32_kernel``): float activations, f32 out,
  the LM serving path (``csrc/qmatmul_f32.cu``), and
  ``qmatmul_f32_grouped``, the same kernels over a stack of MoE experts in
  one launch (the reference vmaps ``qmatmul_f32`` over them);
- ``qmatmul_f32_blockscale`` (``_qmatmul_f32_blockscale_kernel``): the same
  with one scale per (row, 32-wide K block), the page codec's wire form,
  which wire-served cold pages are multiplied from
  (``csrc/qmatmul_blockscale.cu``);
- ``qmatmul_int8`` (``_qmatmul_int8_kernel``): uint8 activations, int32
  accumulators and the NORMQUANT requant to uint8, N-EUREKA's pointwise
  path (``csrc/qmatmul_int8.cu``), on the int8 tensor cores with the block
  tile and K split that ``int8_plan`` chooses per shape.

Packed 2/4/8-bit weights stay packed in device memory; the kernels unpack
them in registers next to the multiply-adds.  The two f32 kernels run on the
tensor cores at f32 accuracy (x split into TF32 hi and lo parts): M <= 16
(decode) through the weight-streaming loop of ``csrc/qmm_decode.cuh``, larger
M through the main loop of ``csrc/qmm_tc.cuh``; the shape decisions around
them (how far to split K, which copy width the rows allow) are made here, by
``tc_splits``, ``tc_aligned`` and ``decode_aligned``, from the geometry the
built library reports (``tc_geometry``).  Each wrapper launches
its kernel for CUDA tensors and raises on anything it does not take.  For
CPU tensors it computes the plain PyTorch version (``kernels/ref.py``).
Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.launch import sm_count, tile_counters

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int


class TcGeometry(NamedTuple):
    """The launch geometry of both tensor-core loops, as their library
    reports it (``dcmm::geometry``).  M > decode_max_m: ``csrc/qmm_tc.cuh``'s
    block tile bm x bn, its K stage bk (one 32-wide scale group), its blocks
    resident on one SM (the launch bounds) and its copy ring's depth, which is
    also the fewest groups a K split keeps, so that the ring still overlaps
    loads with MMAs.  M <= decode_max_m: ``csrc/qmm_decode.cuh``'s packed rows
    a block (an N tile), its resident blocks an SM, the words of x a block
    stages (hi and lo columns times its K range) and the packed bytes of a
    row a ring stage holds."""
    bm: int
    bn: int
    bk: int
    decode_max_m: int
    blocks_per_sm: int
    stages: int
    decode_bn: int
    decode_blocks_per_sm: int
    decode_x_words: int
    decode_stage_bytes: int


# the decode split rule's limits: at least DECODE_MIN_GROUPS 32-wide groups
# a split, so that a block streams more than one ring stage, and at most
# DECODE_MAX_SPLITS splits, which the last block of a tile adds
DECODE_MIN_GROUPS = 4
DECODE_MAX_SPLITS = 32


@functools.lru_cache(maxsize=None)
def tc_geometry(library: str = "qmatmul_f32") -> TcGeometry:
    """The geometry compiled into ``library`` (``qmatmul_f32`` or
    ``qmatmul_blockscale``); builds it if needed."""
    fn = getattr(build.library(library), f"{library}_tc_geometry")
    fn.argtypes = [_c_ptr]
    fn.restype = None
    g = (_c_int * len(TcGeometry._fields))()
    fn(g)
    return TcGeometry(*g)


def decode_cols(m: int) -> int:
    """B columns of the decode loop for m rows of f32 x: the hi and lo parts
    of each row, in whole 8-column MMA tiles of 1, 2 or 4 (bf16 x needs no
    more)."""
    tiles = -(-2 * m // 8)
    return 8 * (tiles if tiles <= 2 else 4)


def tc_splits(m: int, n: int, k: int, sms: int, geo: TcGeometry,
              bits: int = 8, experts: int = 1) -> int:
    """How many K splits the tensor-core loops run for an (m, k) x (k, n)
    product (k > 0) of ``bits``-bit levels on a card with ``sms`` SMs, or
    for ``experts`` such products in one grouped launch (each of their
    output tiles counts).

    Decode (m <= geo.decode_max_m): enough splits of the n / decode_bn tiles
    to give every SM decode_blocks_per_sm blocks, but no more than
    DECODE_MAX_SPLITS and at least DECODE_MIN_GROUPS groups a split, and as
    many as the block's x slice (decode_cols(m) columns of its K range, in
    decode_x_words, or in one stage's range where that is more) needs; a
    split is whole ring stages (decode_stage_bytes of a row).

    M > decode_max_m: 1 when the output tiles alone give every SM a block;
    else as many splits as fit the card's resident block slots in one wave,
    each split at least ``geo.stages`` groups.

    Both are normalised so that every split owns at least one group.  The
    splits' partial sums are added in a fixed order, so the result does not
    depend on this choice beyond rounding, and one shape always gets the
    same bits."""
    groups = -(-k // geo.bk)
    if m <= geo.decode_max_m:
        gs = 8 * geo.decode_stage_bytes // (geo.bk * bits)   # a stage's groups
        most = max(gs, geo.decode_x_words // (decode_cols(m) * geo.bk)
                   // gs * gs)
        tiles = -(-n // geo.decode_bn) * experts
        want = min(-(-geo.decode_blocks_per_sm * sms // tiles),
                   max(1, groups // DECODE_MIN_GROUPS), DECODE_MAX_SPLITS)
        splits = max(want, -(-groups // most))
        per = -(-(-(-groups // splits)) // gs) * gs
        return -(-groups // per)
    tiles = -(-m // geo.bm) * -(-n // geo.bn) * experts
    if tiles >= sms:
        return 1
    splits = min(geo.blocks_per_sm * sms // tiles,
                 max(1, groups // geo.stages))
    per = -(-groups // splits)
    return -(-groups // per)


def tc_aligned(x: torch.Tensor, packed: torch.Tensor, bits: int,
               geo: TcGeometry) -> bool:
    """Whether the tensor-core path may copy x and packed rows with cp.async:
    16 B x chunks and packed chunks of min(16, bk * bits / 8) bytes (one
    group's bytes), every row starting on a chunk.  Else it takes plain
    loads in the same kernel."""
    chunk = min(16, geo.bk * bits // 8)
    return ((x.shape[1] * x.element_size()) % 16 == 0
            and x.data_ptr() % 16 == 0
            and packed.shape[1] % chunk == 0 and packed.data_ptr() % 16 == 0)


def decode_aligned(packed: torch.Tensor) -> bool:
    """Whether the decode loop may copy packed rows with 16 B cp.async: every
    row starts on 16 B.  Else it takes plain loads in the same kernel."""
    return packed.shape[1] % 16 == 0 and packed.data_ptr() % 16 == 0


def _tc_scratch(library: str, x: torch.Tensor, packed: torch.Tensor,
                bits: int, n: int, experts: int = 1):
    """(aligned, splits, scratch, counters) of one launch of ``experts``
    problems (x (E, M, K) and packed (E, N, Kp) when E > 1).  Split, the
    scratch is the partial sums, (E * splits, N, M rounded up to 4) f32 for
    the decode loop with its counters (one a tile and expert), (E * splits,
    M, N) for M > decode_max_m; unsplit both are None.  Alignment is read
    on the 2-D views: an expert's rows start where the previous expert's
    end, so every row is aligned when the first is and rows are whole
    chunks."""
    m, k = x.shape[-2:]
    x2, p2 = x.reshape(-1, k), packed.reshape(-1, packed.shape[-1])
    geo = tc_geometry(library)
    index = x.device.index
    splits = tc_splits(m, n, k, sm_count(
        torch.cuda.current_device() if index is None else index), geo, bits,
        experts)
    if m <= geo.decode_max_m:
        if splits == 1:
            return int(decode_aligned(p2)), 1, None, None
        part = torch.empty((experts * splits, n, -(-m // 4) * 4),
                           dtype=torch.float32, device=x.device)
        return (int(decode_aligned(p2)), splits, part,
                tile_counters(x.device, experts * -(-n // geo.decode_bn)))
    part = (torch.empty((experts * splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    return int(tc_aligned(x2, p2, bits, geo)), splits, part, None


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("qmatmul_f32").qmatmul_f32_launch
    fn.argtypes = [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                   _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                   _c_int, _c_ptr]
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _launcher_blockscale():
    fn = build.library("qmatmul_blockscale").qmatmul_blockscale_launch
    fn.argtypes = [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,
                   _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
                   _c_ptr]
    fn.restype = _c_int
    return fn


@functools.lru_cache(maxsize=None)
def _launcher_int8():
    fn = build.library("qmatmul_int8").qmatmul_int8_launch
    fn.argtypes = [_c_ptr] * 7 + [_c_int] * 11 + [_c_ptr]
    fn.restype = _c_int
    return fn


def _qmm_f32(name: str, x: torch.Tensor, packed: torch.Tensor,
             scale: torch.Tensor, bits: int, k_orig: int) -> torch.Tensor:
    """Check and launch B1 on the card for E stacked problems: x (E, M, K),
    packed (E, N, Kp), scale (E, N) -> (E, M, N); the 2-D call is E = 1."""
    tensors = (x, packed, scale)
    if ({t.device.type for t in tensors} != {"cuda"}
            or len({t.device for t in tensors}) != 1):
        raise ValueError(f"{name} needs x, packed and scale on one CUDA "
                         f"device (or all on the CPU), got {x.device}, "
                         f"{packed.device}, {scale.device}")
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"packed must be uint8 and scale float32, got "
                        f"{packed.dtype} and {scale.dtype}")
    e, m, k = x.shape
    _e, n, kp = packed.shape
    if (k != k_orig or kp != -(-k // (8 // bits)) or _e != e
            or tuple(scale.shape) != (e, n)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)}, "
                         f"bits={bits}, k_orig={k_orig}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous x, packed and scale")
    if e > 65535:
        raise ValueError(f"{name} takes at most 65535 experts, got {e}")
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0 or k == 0:
        return out.zero_()
    aligned, splits, part, counters = _tc_scratch("qmatmul_f32", x, packed,
                                                  bits, n, e)
    rc = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                     packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                     _ptr(part), _ptr(counters), e, m, n, k, kp, bits,
                     aligned, splits,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def qmatmul_f32(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                *, bits: int, k_orig: int) -> torch.Tensor:
    """x (M, K) f32/bf16 @ packed (N, ceil(K/f)) uint8 with scale (N,) f32
    -> (M, N) f32, where f = 8 // bits."""
    if {x.device.type, packed.device.type, scale.device.type} == {"cpu"}:
        return ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k_orig)
    if x.ndim != 2 or packed.ndim != 2 or scale.ndim != 1:
        raise ValueError("x must be (M, K), packed (N, Kp) and scale (N,)")
    out = _qmm_f32("qmatmul_f32", x[None], packed[None], scale[None], bits,
                   k_orig)[0]
    qmatmul_f32.launches += 1
    return out


qmatmul_f32.launches = 0


def qmatmul_f32_grouped(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor, *, bits: int, k_orig: int
                        ) -> torch.Tensor:
    """B1 for each of E experts in one launch: x (E, C, K) f32/bf16 @
    packed (E, N, ceil(K/f)) uint8 with scale (E, N) f32 -> (E, C, N) f32,
    expert e's rows against expert e's weight (the reference vmaps
    ``qmatmul_f32`` over the experts).  Every expert is computed, its
    empty capacity rows included.  Its launches count in its own
    ``launches``, not in :func:`qmatmul_f32`'s."""
    if {x.device.type, packed.device.type, scale.device.type} == {"cpu"}:
        return ref.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                       k_orig=k_orig)
    if x.ndim != 3 or packed.ndim != 3 or scale.ndim != 2:
        raise ValueError("x must be (E, C, K), packed (E, N, Kp) and scale "
                         "(E, N)")
    out = _qmm_f32("qmatmul_f32_grouped", x, packed, scale, bits, k_orig)
    qmatmul_f32_grouped.launches += 1
    return out


qmatmul_f32_grouped.launches = 0


def qmatmul_f32_blockscale(x: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, *, bits: int, k_orig: int,
                           block: int = 32) -> torch.Tensor:
    """x (M, K) f32 @ packed (N, ceil(K/f)) uint8 with per-(row, block)
    scales (N, ceil(K/block)) f32 -> (M, N) f32, f = 8 // bits.  The kernel
    takes ``block == 32`` (``quantize.PAGE_SCALE_BLOCK``) only."""
    tensors = (x, packed, scales)
    if {t.device.type for t in tensors} == {"cpu"}:
        return ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                          k_orig=k_orig, block=block)
    if ({t.device.type for t in tensors} != {"cuda"}
            or len({t.device for t in tensors}) != 1):
        raise ValueError("qmatmul_f32_blockscale needs x, packed and scales "
                         "on one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    if block != 32:
        raise ValueError(f"the blockscale kernel takes block=32, got {block}")
    if (x.dtype, packed.dtype, scales.dtype) != (
            torch.float32, torch.uint8, torch.float32):
        raise TypeError("qmatmul_f32_blockscale takes float32 x, uint8 "
                        f"packed and float32 scales, got {x.dtype}, "
                        f"{packed.dtype}, {scales.dtype}")
    if x.ndim != 2 or packed.ndim != 2 or scales.ndim != 2:
        raise ValueError("x must be (M, K), packed (N, Kp) and scales "
                         "(N, nblk)")
    m, k = x.shape
    n, kp = packed.shape
    nblk = -(-k // block)
    if (k != k_orig or kp != -(-k // (8 // bits))
            or tuple(scales.shape) != (n, nblk)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)}, bits={bits}, "
                         f"k_orig={k_orig}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qmatmul_f32_blockscale needs contiguous x, packed "
                         "and scales")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    aligned, splits, part, counters = _tc_scratch("qmatmul_blockscale", x,
                                                  packed, bits, n)
    rc = _launcher_blockscale()(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        _ptr(part), _ptr(counters), m, n, k, kp, nblk, bits, aligned, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_f32_blockscale launch failed: CUDA "
                           f"error {rc}")
    qmatmul_f32_blockscale.launches += 1
    return out


qmatmul_f32_blockscale.launches = 0


class Int8Plan(NamedTuple):
    """One launch of ``csrc/qmatmul_int8.cu``: blocks of INT8_BM rows by
    INT8_BN columns, K split into ``splits`` ranges of ``kchunk`` (the last
    block of a tile adds the others' int32 slices).  ``route`` is
    "mma_direct" (each lane loads its MMA fragments straight into
    registers; K a multiple of 8 up to INT8_DIRECT_MAX_K, rows on 8 B,
    unsplit) or "mma_staged" (the tiles copied into shared memory first, at
    any alignment); ``blocks`` is the grid's size."""
    route: str
    splits: int
    kchunk: int
    blocks: int


INT8_BM, INT8_BN = 64, 16   # a block's tile
INT8_KSTAGE = 256           # K a staged block holds in shared memory at once
INT8_DIRECT_MAX_K = 64      # K a direct block holds in registers
INT8_KUNIT = 64             # a split's K range is whole multiples of this
INT8_MAX_SPLITS = 16


def int8_tile_plan(m: int, k: int, n: int, splits: int = 1,
                   direct: bool = False) -> Int8Plan:
    """The launch on a route with K in about ``splits`` ranges: each range
    whole INT8_KUNITs, as many ranges as that leaves (at least 1)."""
    tiles = -(-m // INT8_BM) * -(-n // INT8_BN)
    kchunk = max(k, 0)
    if splits > 1 and k > INT8_KUNIT:
        kchunk = -(-(-(-k // splits)) // INT8_KUNIT) * INT8_KUNIT
    splits = -(-k // kchunk) if kchunk else 1
    if splits == 1:
        kchunk = max(k, 0)
    return Int8Plan("mma_direct" if direct else "mma_staged", splits, kchunk,
                    tiles * splits)


def int8_direct_ok(k: int, aligned: bool) -> bool:
    """Whether the direct route takes K (a positive multiple of 8, at most
    INT8_DIRECT_MAX_K) and rows whose x and packed start on 8 B."""
    return aligned and 0 < k <= INT8_DIRECT_MAX_K and k % 8 == 0


def int8_plan(m: int, k: int, n: int, sms: int = 132,
              aligned: bool = True) -> Int8Plan:
    """The launch ``qmatmul_int8`` makes for an (m, k) x (k, n) product (of
    levels at any bit width) on a card with ``sms`` SMs; ``aligned``: x and
    packed start on 8 B.

    Every MobileNet-V2 job is bound by latency, not by its bytes or MMAs.
    Per-job times of every route, tile and split on an H100 SXM
    (``tools/neureka_ab.py --sweep``) set the rule: the direct route where
    it takes K and the rows, else the staged one; K split into
    INT8_KSTAGE-wide ranges only where the tiles do not give every SM a
    block and a staged block would hold its K three times or more.
    Splitting a shorter K cost more (the slices' second trip through L2)
    than the blocks it added."""
    if int8_direct_ok(k, aligned):
        return int8_tile_plan(m, k, n, direct=True)
    splits = 1
    if (-(-m // INT8_BM) * -(-n // INT8_BN) < sms
            and k > 2 * INT8_KSTAGE):
        splits = min(-(-k // INT8_KSTAGE), INT8_MAX_SPLITS)
    return int8_tile_plan(m, k, n, splits)


def copy_width(row_bytes: int, ptr: int, widths=(16, 8, 4)) -> int:
    """The widest copy (of ``widths``, else 1 byte) that every row of
    ``row_bytes`` bytes from ``ptr`` on starts on: the gate for a kernel's
    wide reads of x, packed and out."""
    for w in widths:
        if row_bytes % w == 0 and ptr % w == 0:
            return w
    return 1


def _launch_int8(x_q, packed, mult, bias, out, bits: int, plan: Int8Plan):
    """Launch ``plan`` into ``out``; split launches take an int32 scratch of
    their slices and the per-stream tile counters."""
    m, k = x_q.shape
    n, kp = packed.shape
    part = counters = None
    if plan.splits > 1:
        part = torch.empty(plan.blocks * INT8_BM * INT8_BN, dtype=torch.int32,
                           device=x_q.device)
        counters = tile_counters(x_q.device, plan.blocks // plan.splits)
    rc = _launcher_int8()(
        x_q.data_ptr(), packed.data_ptr(), mult.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _ptr(part), _ptr(counters), m, n, k, kp, bits,
        int(plan.route == "mma_direct"), plan.splits, plan.kchunk,
        copy_width(k, x_q.data_ptr()), copy_width(kp, packed.data_ptr()),
        copy_width(n, out.data_ptr(), (16, 8, 4, 2)),
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul_int8 launch failed: CUDA error {rc}")


def qmatmul_int8(x_q: torch.Tensor, packed: torch.Tensor, mult: torch.Tensor,
                 bias: torch.Tensor, *, bits: int, k_orig: int
                 ) -> torch.Tensor:
    """uint8 x (M, K) @ packed (N, ceil(K/f)) uint8 -> int32 sums ->
    ``clip(round(acc * mult) + bias, 0, 255)`` uint8 (M, N); ``mult`` (N,)
    f32, ``bias`` (N,) int32, f = 8 // bits."""
    tensors = (x_q, packed, mult, bias)
    if {t.device.type for t in tensors} == {"cpu"}:
        return ref.qmatmul_int8(x_q, packed, mult, bias, bits=bits,
                                k_orig=k_orig)
    if ({t.device.type for t in tensors} != {"cuda"}
            or len({t.device for t in tensors}) != 1):
        raise ValueError("qmatmul_int8 needs x_q, packed, mult and bias on "
                         "one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    if (x_q.dtype, packed.dtype, mult.dtype, bias.dtype) != (
            torch.uint8, torch.uint8, torch.float32, torch.int32):
        raise TypeError("qmatmul_int8 takes uint8 x_q and packed, float32 "
                        f"mult and int32 bias, got {x_q.dtype}, "
                        f"{packed.dtype}, {mult.dtype}, {bias.dtype}")
    if x_q.ndim != 2 or packed.ndim != 2 or mult.ndim != 1 or bias.ndim != 1:
        raise ValueError("x_q must be (M, K), packed (N, Kp), mult and bias "
                         "(N,)")
    m, k = x_q.shape
    n, kp = packed.shape
    if (k != k_orig or kp != -(-k // (8 // bits)) or mult.shape[0] != n
            or bias.shape[0] != n):
        raise ValueError(f"shape mismatch: x_q {tuple(x_q.shape)}, packed "
                         f"{tuple(packed.shape)}, mult {tuple(mult.shape)}, "
                         f"bias {tuple(bias.shape)}, bits={bits}, "
                         f"k_orig={k_orig}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qmatmul_int8 needs contiguous x_q, packed, mult "
                         "and bias")
    out = torch.empty((m, n), dtype=torch.uint8, device=x_q.device)
    if m == 0 or n == 0:
        return out
    index = x_q.device.index
    plan = int8_plan(m, k, n, sm_count(
        torch.cuda.current_device() if index is None else index),
        (x_q.data_ptr() | packed.data_ptr()) % 8 == 0)
    _launch_int8(x_q, packed, mult, bias, out, bits, plan)
    qmatmul_int8.launches += 1
    return out


qmatmul_int8.launches = 0
