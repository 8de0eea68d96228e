"""Port parity: the plain ``qmatmul_f32`` against the reference Pallas kernel
(interpret mode) and its jnp oracle, over the sweep of ``test_kernels.py``.

Tolerances are the reference test's: 1e-4 for f32 x, 2e-2 for bf16 x.  On
CPU tensors the wrapper computes the plain version; the Hopper kernel
itself is held against it on the card by ``test_torch_gpu.py`` and
``chip_smoke.py``.  The numeric design of its two tensor-core loops (decode,
M <= 16, and M > 16) and the shape rules around them (K splits, copy
widths) are checked here too."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.qmatmul import qmatmul_f32 as jqmatmul  # noqa: E402

from repro_torch.core import packing, quantize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qmatmul import (  # noqa: E402
    DECODE_MAX_SPLITS, DECODE_MIN_GROUPS, TcGeometry, decode_aligned,
    decode_cols, qmatmul_f32, tc_aligned, tc_splits)

BITS = (2, 4, 8)
# csrc/qmm_tc.cuh's and csrc/qmm_decode.cuh's geometry (the card reports it
# through tc_geometry; the split and alignment rules are checked here
# against these numbers)
GEO = TcGeometry(bm=64, bn=128, bk=32, decode_max_m=16, blocks_per_sm=2,
                 stages=4, decode_bn=128, decode_blocks_per_sm=2,
                 decode_x_words=8192, decode_stage_bytes=128)


def _operands(rng, m, k, n, bits):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    packed, scale = jops.prep_linear(jnp.asarray(w), bits)
    # copies: arrays exported from JAX are read-only
    return x, np.array(packed), np.array(scale)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (96, 200, 130), (1, 33, 7)])
def test_qmatmul_f32_sweep(rng, bits, m, k, n):
    x, packed, scale = _operands(rng, m, k, n, bits)
    pallas = jqmatmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale),
                      bits=bits, k_orig=k, bm=32, bn=32, bk=64,
                      interpret=True)
    oracle = jref.qmatmul_f32(jnp.asarray(x), jnp.asarray(packed),
                              jnp.asarray(scale), bits=bits, k_orig=k)
    got = qmatmul_f32(torch.from_numpy(x), torch.from_numpy(packed),
                      torch.from_numpy(scale), bits=bits, k_orig=k)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for expect in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_dtypes(rng, bits, dtype):
    x, packed, scale = _operands(rng, 24, 80, 40, bits)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pallas = jqmatmul(jx, jnp.asarray(packed), jnp.asarray(scale), bits=bits,
                      k_orig=80, bm=16, bn=16, bk=40, interpret=True)
    got = qmatmul_f32(tx, torch.from_numpy(packed), torch.from_numpy(scale),
                      bits=bits, k_orig=80)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=2e-2, atol=2e-2)


def test_quant_matmul_leading_dims_matches_xla_mode(rng):
    x = rng.normal(size=(4, 8, 64)).astype(np.float32)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    packed, scale = jops.prep_linear(jnp.asarray(w), 4)
    expect = jops.quant_matmul(jnp.asarray(x), packed, scale, bits=4,
                               k_orig=64, mode="xla")
    got = ops.quant_matmul(torch.from_numpy(x),
                           torch.from_numpy(np.array(packed)),
                           torch.from_numpy(np.array(scale)), bits=4,
                           k_orig=64)
    assert got.shape == (4, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-4,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_version(rng):
    x, packed, scale = _operands(rng, 5, 33, 9, 2)
    before = qmatmul_f32.launches
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scale))
    got = qmatmul_f32(*args, bits=2, k_orig=33)
    assert torch.equal(got, ref.qmatmul_f32(*args, bits=2, k_orig=33))
    assert qmatmul_f32.launches == before        # counts kernel launches only


def test_other_devices_raise_instead_of_falling_back(rng):
    x, packed, scale = _operands(rng, 4, 16, 8, 8)
    meta_x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul_f32(meta_x, torch.from_numpy(packed),
                    torch.from_numpy(scale), bits=8, k_orig=16)


# ---------------------------------------------------------------------------
# The numeric design of the tensor-core path (csrc/qmm_tc.cuh), emulated in
# numpy: x split into TF32 hi / lo, times the exact levels, summed per 32-wide
# K group in f32 and promoted with the per-channel scale (qmatmul_f32) or the
# block scales (qmatmul_f32_blockscale).  It pins the design on the CPU; the
# kernel itself is held against the plain version on the card.

EMU_SHAPES = [(3072, 1024), (8192, 288), (100, 130)]


def _tf32_rna(a):
    """f32 -> f32 with 10 mantissa bits, round to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate_tc(x, levels, pre, passes):
    """sum_kb pre[:, kb] * (sum of the ``passes`` TF32 parts of x times the
    levels over group kb, in f32), promoted in f32 group by group."""
    m, k = x.shape
    n = levels.shape[0]
    groups = -(-k // 32)
    pad = groups * 32 - k
    xp = np.pad(x, ((0, 0), (0, pad)))
    lp = np.pad(levels, ((0, 0), (0, pad))).astype(np.float32)
    hi = _tf32_rna(xp)
    parts = [hi, _tf32_rna(xp - hi)][:passes]
    lg = lp.reshape(n, groups, 32).transpose(1, 2, 0)            # (G, 32, N)
    part = np.zeros((groups, m, n), np.float32)
    for p in parts:
        part += np.matmul(p.reshape(m, groups, 32).transpose(1, 0, 2), lg)
    acc = np.zeros((m, n), np.float32)
    for g in range(groups):
        acc += pre[None, :, g] * part[g]
    return acc


def _emulate_decode(x, levels, pre, passes, splits, stage_groups):
    """The decode loop's order (csrc/qmm_decode.cuh): weights on the MMA's M
    side, each 32-wide group's levels (N, 32) times the B columns, x's TF32
    hi parts then its lo parts (32, 2M), summed in f32 and promoted group by
    group with pre into its K split's f32 sum; a split's hi and lo columns
    added in f32; the splits (whole ring stages of ``stage_groups``) added
    in order.  Returns (M, N) before B1's per-channel scale."""
    m, k = x.shape
    n = levels.shape[0]
    groups = -(-k // 32)
    pad = groups * 32 - k
    xp = np.pad(x, ((0, 0), (0, pad)))
    lp = np.pad(levels, ((0, 0), (0, pad))).astype(np.float32)
    hi = _tf32_rna(xp)
    cols = np.concatenate([hi, _tf32_rna(xp - hi)])[:passes * m]
    per = -(-(-(-groups // splits)) // stage_groups) * stage_groups
    total = np.zeros((n, m), np.float32)
    for g0 in range(0, groups, per):
        acc = np.zeros((n, passes * m), np.float32)
        for g in range(g0, min(groups, g0 + per)):
            ks = slice(32 * g, 32 * g + 32)
            acc += pre[:, g:g + 1] * np.matmul(lp[:, ks], cols[:, ks].T)
        total += acc[:, :m] + acc[:, m:] if passes == 2 else acc
    return total.T


def _decode_route(bits, k, n, m):
    def emulate(x, levels, pre, passes):
        splits = tc_splits(m, n, k, 132, GEO, bits)
        gs = 8 * GEO.decode_stage_bytes // (GEO.bk * bits)
        return _emulate_decode(x, levels, pre, passes, splits, gs)
    return emulate


def _emu_b1(rng, bits, k, n, passes, m=32, route=_emulate_tc):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = torch.from_numpy((rng.normal(size=(n, k)) * k ** -0.5)
                         .astype(np.float32))
    packed, scale = ops.prep_linear(w, bits)
    levels = packing.unpack(packed, bits, k).numpy()
    pre = np.ones((n, -(-k // 32)), np.float32)
    got = route(x, levels, pre, passes) * scale.numpy()[None]
    expect = ref.qmatmul_f32(torch.from_numpy(x), packed, scale, bits=bits,
                             k_orig=k)
    return got, expect.numpy()


def _emu_b3(rng, bits, k, n, passes, m=32, route=_emulate_tc):
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(n, k)) * k ** -0.5).astype(np.float32)
    levels, scales = quantize.quantize_blockwise(w, bits)
    packed = packing.pack(torch.from_numpy(levels), bits)
    got = route(x, levels, scales, passes)
    expect = ref.qmatmul_f32_blockscale(torch.from_numpy(x), packed,
                                        torch.from_numpy(scales), bits=bits,
                                        k_orig=k)
    return got, expect.numpy()


EMULATED = {"qmatmul_f32": _emu_b1, "qmatmul_f32_blockscale": _emu_b3}


@pytest.mark.parametrize("kernel", sorted(EMULATED))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k,n", EMU_SHAPES)
def test_two_tf32_passes_keep_f32_accuracy(rng, kernel, bits, k, n):
    got, expect = EMULATED[kernel](rng, bits, k, n, passes=2)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", sorted(EMULATED))
def test_one_tf32_pass_misses_the_tolerance(rng, kernel):
    """Why the kernel takes two passes: x rounded once to TF32 misses the
    1e-4 tolerance at K = 3,072."""
    got, expect = EMULATED[kernel](rng, 8, 3072, 1024, passes=1)
    assert not np.allclose(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", sorted(EMULATED))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", [(3072, 1024), (1001, 130)])
def test_decode_route_keeps_f32_accuracy(rng, kernel, bits, m, k, n):
    """The decode loop's order of operations, with the K splits the wrapper
    picks (24 at M = 4, K = 3,072), within 1e-4 of the plain version."""
    got, expect = EMULATED[kernel](rng, bits, k, n, passes=2, m=m,
                                   route=_decode_route(bits, k, n, m))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n,splits", [
    (4, 1024, 1024, 8),          # decode: 8 tiles, 8 splits of 4 groups
    (4, 1024, 2048, 8),          # qwen3 wq: 16 tiles
    (4, 3072, 1024, 24),         # qwen3 w_down: 24 splits of 4 groups
    (4, 4096, 16384, 4),         # falcon in_proj: x slice of 32 groups
    (4, 8192, 288, 32),          # falcon x_proj: 3 tiles, at most 32 splits
    (4, 8192, 4096, 8),          # falcon out_proj: 32 tiles, 8 x 32 groups
    (4, 256, 8192, 2),           # falcon dt_proj: 8 groups
    (16, 8192, 4096, 32),        # M = 16: 32 x columns, 8 groups a split
    (1, 100, 3200, 1),           # hymba dt_proj: 4 groups, no split
    (256, 4096, 16384, 1),       # 512 output tiles fill the card
    (256, 1024, 2048, 4),        # 64 tiles: 4 splits of 8 groups
    (256, 1024, 1024, 8),        # 32 tiles: 8 splits of 4 groups
    (256, 8192, 288, 22),        # falcon x_proj: 12 tiles, 22 x 12 groups
    (256, 8192, 4096, 2),        # falcon out_proj: 128 tiles
    (64, 100, 130, 1),           # 4 groups: no split below 4 a split
    (17, 3072, 1024, 24),        # 8 tiles, capped at 96 / 4 groups
])
def test_tc_splits_fill_the_card_in_one_wave(m, k, n, splits):
    got = tc_splits(m, n, k, 132, GEO)
    assert got == splits
    groups = -(-k // GEO.bk)
    if m <= GEO.decode_max_m:
        # decode: whole ring stages (4 groups at 8 bits), an x slice that
        # fits, and at least two blocks an SM unless the split limits bind
        per = -(-(-(-groups // got)) // 4) * 4
        tiles = -(-n // GEO.decode_bn)
        assert decode_cols(m) * per * GEO.bk <= max(
            GEO.decode_x_words, decode_cols(m) * GEO.bk * 4)
        fill = -(-groups * tiles // (GEO.decode_blocks_per_sm * 132))
        assert (per <= -(-fill // 4) * 4         # a split's groups for 2 an SM
                or got >= min(DECODE_MAX_SPLITS,
                              groups // DECODE_MIN_GROUPS))
    else:
        per = -(-groups // got)
        tiles = -(-m // GEO.bm) * -(-n // GEO.bn)
        assert got == 1 or tiles * got <= GEO.blocks_per_sm * 132  # one wave
    assert (got - 1) * per < groups              # every split owns a group


@pytest.mark.parametrize("bits,splits", [(8, 8), (4, 4), (2, 2)])
def test_tc_splits_decode_takes_whole_ring_stages(bits, splits):
    """A ring stage holds 128 B of a row: 4, 8 or 16 groups at 8, 4 or 2
    bits, and a decode split is whole stages (K = 1,024: 32 groups)."""
    got = tc_splits(4, 1024, 1024, 132, GEO, bits)
    assert got == splits
    gs = 32 // bits
    per = -(-(-(-32 // got)) // gs) * gs
    assert per % gs == 0 and (got - 1) * per < 32 <= got * per


def test_decode_aligned_takes_cp_async_only_on_16_byte_rows():
    def case(kp, offset=0):
        return decode_aligned(torch.zeros(3 * kp + offset,
                                          dtype=torch.uint8)[offset:]
                              .view(3, kp))
    assert case(1024) and case(512) and case(16)
    assert not case(100)                     # hymba dt_proj at 8 bits
    assert not case(1001) and not case(8)
    assert not case(1024, offset=4)          # rows 4 B off a chunk


def test_tc_aligned_takes_cp_async_only_on_chunk_rows():
    def case(m, k, bits, dtype=torch.float32):
        x = torch.zeros((m, k), dtype=dtype)
        packed = torch.zeros((3, -(-k // (8 // bits))), dtype=torch.uint8)
        return tc_aligned(x, packed, bits, GEO)
    assert case(17, 1024, 8) and case(17, 1024, 4) and case(17, 1024, 2)
    assert not case(17, 1001, 8)             # K = 1,001: ragged rows
    assert not case(17, 100, 8)              # hymba dt_proj: Kp = 100 bytes
    assert not case(17, 100, 2)              # Kp = 25, not a multiple of 8
    assert case(17, 64, 2)                   # Kp = 16: 8 B chunks
    assert case(17, 1024, 8, torch.bfloat16)
    assert not case(17, 1020, 8, torch.bfloat16)   # rows of 2,040 B
    x = torch.zeros(17 * 1024 + 1)[1:].view(17, 1024)   # 4 B off a chunk
    assert not tc_aligned(x, torch.zeros((3, 1024), dtype=torch.uint8), 8,
                          GEO)
