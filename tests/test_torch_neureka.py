"""Port parity: N-EUREKA's integer operators (``qmatmul_int8``,
``conv3x3_dense``, ``conv3x3_dw``, ``conv1x1``) and the requant helpers
against the reference Pallas kernels (interpret mode) and their jnp
oracles, over the sweep of ``test_kernels.py``.

Every comparison is exact: the whole path is integer up to one f32 rescale
whose rounding both sides share.  On CPU tensors the wrappers compute the
plain versions; the Hopper kernels are held against those on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quantize as jquant  # noqa: E402
from repro.kernels import neureka_conv as jnkc  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.qmatmul import qmatmul_int8 as jqmatmul_int8  # noqa: E402

from repro_torch.core import quantize  # noqa: E402
from repro_torch.kernels import neureka_conv as nkc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_int8  # noqa: E402

BITS = (2, 4, 8)


def _t(a):
    # copies: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(a))


def _requant_operands(rng, n):
    mult = rng.uniform(1e-4, 1e-3, (n,)).astype(np.float32)
    bias = rng.integers(-8, 8, (n,)).astype(np.int32)
    return mult, bias


def _assert_equal(got, *expected):
    got = got.numpy()
    for e in expected:
        np.testing.assert_array_equal(got, np.asarray(e))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m,k,n", [(40, 130, 50), (1, 33, 7), (16, 64, 32)])
def test_qmatmul_int8_exact(rng, bits, m, k, n):
    xq = rng.integers(0, 255, (m, k)).astype(np.uint8)
    w = rng.normal(size=(n, k)).astype(np.float32)
    packed, _ = jops.prep_linear(jnp.asarray(w), bits)
    mult, bias = _requant_operands(rng, n)
    args = (jnp.asarray(xq), packed, jnp.asarray(mult), jnp.asarray(bias))
    pallas = jqmatmul_int8(*args, bits=bits, k_orig=k, bm=16, bn=32, bk=32,
                           interpret=True)
    oracle = jref.qmatmul_int8(*args, bits=bits, k_orig=k)
    got = qmatmul_int8(_t(xq), _t(packed), _t(mult), _t(bias), bits=bits,
                       k_orig=k)
    assert got.dtype == torch.uint8 and got.shape == (m, n)
    _assert_equal(got, pallas, oracle)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hwc", [(12, 10, 24, 16), (7, 7, 3, 32)])
def test_conv3x3_dense_exact(rng, bits, stride, hwc):
    h, w_, cin, cout = hwc
    x = rng.integers(0, 255, (h, w_, cin)).astype(np.uint8)
    wf = rng.normal(size=(cout, 3, 3, cin)).astype(np.float32)
    packed, _ = jops.prep_conv3x3(jnp.asarray(wf), bits)
    tpacked, _ = ops.prep_conv3x3(torch.from_numpy(wf), bits)
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(packed))
    mult, bias = _requant_operands(rng, cout)
    args = (jnp.asarray(x), packed, jnp.asarray(mult), jnp.asarray(bias))
    pallas = jnkc.conv3x3_dense(*args, bits=bits, cin=cin, stride=stride,
                                bco=16, bci=8, interpret=True)
    oracle = jref.conv3x3_dense(*args, bits=bits, cin=cin, stride=stride)
    got = nkc.conv3x3_dense(_t(x), tpacked, _t(mult), _t(bias), bits=bits,
                            cin=cin, stride=stride)
    assert got.shape == (-(-h // stride), -(-w_ // stride), cout)
    _assert_equal(got, pallas, oracle)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_dw_exact(rng, bits, stride):
    h, w_, c = 9, 11, 40
    x = rng.integers(0, 255, (h, w_, c)).astype(np.uint8)
    wf = rng.normal(size=(c, 3, 3)).astype(np.float32)
    packed, _ = jops.prep_dw3x3(jnp.asarray(wf), bits)
    tpacked, _ = ops.prep_dw3x3(torch.from_numpy(wf), bits)
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(packed))
    mult, bias = _requant_operands(rng, c)
    args = (jnp.asarray(x), packed, jnp.asarray(mult), jnp.asarray(bias))
    pallas = jnkc.conv3x3_dw(*args, bits=bits, stride=stride, bc=16,
                             interpret=True)
    oracle = jref.conv3x3_dw(*args, bits=bits, stride=stride)
    got = nkc.conv3x3_dw(_t(x), tpacked, _t(mult), _t(bias), bits=bits,
                         stride=stride)
    _assert_equal(got, pallas, oracle)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_exact(rng, bits, stride):
    x = rng.integers(0, 255, (7, 9, 33)).astype(np.uint8)
    wf = rng.normal(size=(17, 33)).astype(np.float32)
    packed, _ = jops.prep_linear(jnp.asarray(wf), bits)
    mult, bias = _requant_operands(rng, 17)
    args = (jnp.asarray(x), packed, jnp.asarray(mult), jnp.asarray(bias))
    pallas = jnkc.conv1x1(*args, bits=bits, cin=33, stride=stride,
                          interpret=True)
    oracle = jref.conv1x1(*args, bits=bits, cin=33, stride=stride)
    got = nkc.conv1x1(_t(x), _t(packed), _t(mult), _t(bias), bits=bits,
                      cin=33, stride=stride)
    assert got.shape == (-(-7 // stride), -(-9 // stride), 17)
    _assert_equal(got, pallas, oracle)


@pytest.mark.parametrize("op,shape,stride", [
    ("dense3x3", (16, 3, 3, 8), 2), ("dw3x3", (8, 3, 3), 1),
    ("dw3x3", (8, 3, 3), 2), ("pw1x1", (12, 8), 1)])
def test_neureka_conv2d_matches_reference_ops(rng, op, shape, stride):
    x = rng.integers(0, 255, (10, 6, 8)).astype(np.uint8)
    wf = rng.normal(size=shape).astype(np.float32)
    prep = {"dense3x3": "prep_conv3x3", "dw3x3": "prep_dw3x3",
            "pw1x1": "prep_linear"}[op]
    packed, _ = getattr(jops, prep)(jnp.asarray(wf), 4)
    mult, bias = _requant_operands(rng, shape[0])
    expect = jops.neureka_conv2d(jnp.asarray(x), packed, jnp.asarray(mult),
                                 jnp.asarray(bias), op=op, bits=4, cin=8,
                                 stride=stride, mode="xla")
    got = ops.neureka_conv2d(_t(x), _t(packed), _t(mult), _t(bias), op=op,
                             bits=4, cin=8, stride=stride)
    _assert_equal(got, expect)
    with pytest.raises(ValueError, match="unknown N-EUREKA op"):
        ops.neureka_conv2d(_t(x), _t(packed), _t(mult), _t(bias), op="pw3x3",
                           bits=4, cin=8)


def test_quant_matmul_int8_leading_dims(rng):
    xq = rng.integers(0, 255, (3, 5, 24)).astype(np.uint8)
    packed, _ = jops.prep_linear(jnp.asarray(rng.normal(size=(10, 24)),
                                             jnp.float32), 2)
    mult, bias = _requant_operands(rng, 10)
    expect = jops.quant_matmul_int8(jnp.asarray(xq), packed,
                                    jnp.asarray(mult), jnp.asarray(bias),
                                    bits=2, k_orig=24, mode="xla")
    got = ops.quant_matmul_int8(_t(xq), _t(packed), _t(mult), _t(bias),
                                bits=2, k_orig=24)
    assert got.shape == (3, 5, 10)
    _assert_equal(got, expect)


def test_requant_rounds_half_to_even_at_ties():
    # acc * 0.5 lands exactly on .5 for odd acc: jnp.round (and the kernels'
    # rintf) round those to the even neighbour
    acc = np.arange(-7, 12, dtype=np.int32)
    mult = np.full(acc.shape, 0.5, np.float32)
    bias = np.full(acc.shape, 4, np.int32)
    expect = jref._requant_f32(jnp.asarray(acc), jnp.asarray(mult),
                               jnp.asarray(bias))
    got = ref.requant_f32(_t(acc), _t(mult), _t(bias))
    _assert_equal(got, expect)
    # 1.5 -> 2, 2.5 -> 2, 3.5 -> 4, -0.5 -> 0 (clipped at 0 below)
    by_acc = dict(zip(acc.tolist(), got.numpy().tolist()))
    assert [by_acc[a] for a in (3, 5, 7, -1)] == [6, 6, 8, 4]


def test_requantize_rounds_half_up_at_ties():
    # rescale 0.5 exactly (mult 2^23, shift 24): floor(x + 0.5) sends every
    # .5 up, unlike the kernels' half-to-even
    rq_j = jquant.RequantParams(mult=jnp.full((1,), 1 << 23, jnp.int32),
                                bias=jnp.zeros((1,), jnp.int32), shift=24)
    rq_t = quantize.RequantParams(mult=torch.full((1,), 1 << 23,
                                                  dtype=torch.int32),
                                  bias=torch.zeros((1,), dtype=torch.int32),
                                  shift=24)
    acc = np.arange(0, 12, dtype=np.int32)[:, None]
    expect = jquant.requantize(jnp.asarray(acc), rq_j)
    got = quantize.requantize(_t(acc), rq_t)
    _assert_equal(got, expect)
    assert got[:, 0].tolist() == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6]


@pytest.mark.parametrize("zp", [0, 3])
def test_fold_requant_and_requantize_match_reference(rng, zp):
    c = 64
    w_scale = rng.uniform(1e-3, 5e-2, (c,)).astype(np.float32)
    bias_fp = rng.normal(scale=2.0, size=(c,)).astype(np.float32)
    in_scale, out_scale = 0.05, 0.11
    rq_j = jquant.fold_requant(jnp.asarray(w_scale), in_scale, out_scale,
                               jnp.asarray(bias_fp), out_zero_point=zp)
    rq_t = quantize.fold_requant(torch.from_numpy(w_scale), in_scale,
                                 out_scale, torch.from_numpy(bias_fp),
                                 out_zero_point=zp)
    assert rq_t.shift == rq_j.shift == quantize.REQUANT_SHIFT_BITS
    _assert_equal(rq_t.mult, rq_j.mult)
    _assert_equal(rq_t.bias, rq_j.bias)
    assert rq_t.mult.dtype == rq_t.bias.dtype == torch.int32
    acc = rng.integers(-20000, 20000, (33, c)).astype(np.int32)
    _assert_equal(quantize.requantize(_t(acc), rq_t),
                  jquant.requantize(jnp.asarray(acc), rq_j))
    no_bias = quantize.fold_requant(torch.from_numpy(w_scale), in_scale,
                                    out_scale, None)
    _assert_equal(no_bias.bias, jquant.fold_requant(
        jnp.asarray(w_scale), in_scale, out_scale, None).bias)


@pytest.mark.parametrize("name", ["qmatmul_int8", "conv3x3_dense",
                                  "conv3x3_dw"])
def test_wrappers_take_cpu_or_cuda_only(name):
    # a tensor that is neither on the CPU nor on a card is refused, not
    # sent to the plain version
    meta = torch.device("meta")
    if name == "qmatmul_int8":
        args = (torch.empty((4, 8), dtype=torch.uint8, device=meta),
                torch.empty((3, 8), dtype=torch.uint8, device=meta))
        kw = dict(bits=8, k_orig=8)
        fn = qmatmul_int8
    elif name == "conv3x3_dense":
        args = (torch.empty((5, 5, 8), dtype=torch.uint8, device=meta),
                torch.empty((3, 3, 3, 8), dtype=torch.uint8, device=meta))
        kw = dict(bits=8, cin=8)
        fn = nkc.conv3x3_dense
    else:
        args = (torch.empty((5, 5, 3), dtype=torch.uint8, device=meta),
                torch.empty((3, 9), dtype=torch.uint8, device=meta))
        kw = dict(bits=8)
        fn = nkc.conv3x3_dw
    mult = torch.empty((3,), dtype=torch.float32, device=meta)
    bias = torch.empty((3,), dtype=torch.int32, device=meta)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args, mult, bias, **kw)
    assert fn.launches == before


# --- the launch plans and the implicit GEMM of the Hopper kernels ---------

def _mnv2_pw_shapes():
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    return list(dict.fromkeys((j.h * j.w, j.cin, j.cout)
                              for j in mobilenet_v2_jobs(8, 224)
                              if j.op_kind == "pw1x1"))


# every distinct MobileNet-V2 1.0-224 pointwise shape (20 for its 35 jobs),
# and the ragged shapes chip_smoke.py checks on the card
INT8_PLAN_SHAPES = _mnv2_pw_shapes() + [(40, 130, 50), (1, 33, 7),
                                        (63, 130, 17), (17, 33, 7)]


@pytest.mark.parametrize("m,k,n", INT8_PLAN_SHAPES)
def test_int8_plan_covers_k_once(m, k, n):
    from repro_torch.kernels import qmatmul as qmm
    for sms in (132, 114):
        for aligned in (True, False):
            plan = qmm.int8_plan(m, k, n, sms, aligned)
            # the splits' K ranges [z * kchunk, min(k, (z + 1) * kchunk))
            # are non-empty and cover [0, k) exactly once
            ranges = [(z * plan.kchunk, min(k, (z + 1) * plan.kchunk))
                      for z in range(plan.splits)]
            assert all(lo < hi for lo, hi in ranges)
            covered = np.zeros(k, np.int64)
            for lo, hi in ranges:
                covered[lo:hi] += 1
            assert (covered == 1).all()
            tiles = -(-m // qmm.INT8_BM) * -(-n // qmm.INT8_BN)
            if aligned and k % 8 == 0 and k <= qmm.INT8_DIRECT_MAX_K:
                assert plan.route == "mma_direct" and plan.splits == 1
            else:
                # staged (always for unaligned rows); split only where the
                # tiles leave SMs idle and a block would hold its K three
                # times or more
                assert plan.route == "mma_staged"
                assert plan.splits == 1 or (tiles < sms and k > 512)
            if plan.splits > 1:
                assert plan.kchunk % qmm.INT8_KUNIT == 0
                assert plan.splits <= qmm.INT8_MAX_SPLITS
            else:
                assert plan.kchunk == k
            assert plan.blocks == tiles * plan.splits


def _requant_np(acc, mult, bias):
    # the kernels' requant in numpy f32: rint(f32(acc) * mult) + bias,
    # rounded apart, half to even, clipped to uint8
    y = np.rint((acc.astype(np.float32) * mult).astype(np.float32))
    y = (y + bias.astype(np.float32)).astype(np.float32)
    return np.clip(y, 0, 255).astype(np.uint8)


def _dense_implicit_gemm(x, packed, mult, bias, *, bits, cin, stride):
    """csrc/neureka_conv.cu::dense3x3_mma in numpy, block by block as
    dense_plan tiles the map: the staged input rows with their zero halo
    (the map's bytes from a 16 B boundary, at an offset of round_up(Cin,
    16)), the table of K offsets (K = 9 * Cin, tap-major then ci, padded
    with zero levels to a multiple of 32), an im2col gather through it, an
    int matmul and the requant."""
    h, w, _ = x.shape
    cout, cinp = packed.shape[0], packed.shape[3]
    plan = nkc.dense_plan(h, w, cout, stride)
    s, f = stride, 8 // bits
    ho, wo = -(-h // s), -(-w // s)
    k9 = 9 * cin
    kp = -(-k9 // 32) * 32
    left = -(-cin // 16) * 16
    pitch = -(-(left + ((plan.tw - 1) * s + 3) * cin + 16) // 16) * 16
    rows = (plan.rows - 1) * s + 3
    fields = (packed[..., None].astype(np.int64) >> (bits * np.arange(f))) \
        & ((1 << bits) - 1)
    levels = fields.reshape(cout, 9, cinp * f)[:, :, :cin] - (1 << (bits - 1))
    wk = np.zeros((cout, kp), np.int64)
    wk[:, :k9] = levels.reshape(cout, k9)
    kk = np.arange(k9)
    tap, ci = kk // cin, kk % cin
    koff = np.zeros(kp, np.int64)
    koff[:k9] = (tap // 3) * pitch + (tap % 3 - 1) * cin + ci
    flat = x.reshape(h, w * cin).astype(np.int64)
    out = np.zeros((ho, wo, cout), np.uint8)
    for oh0 in range(0, ho, plan.rows):
        for ow0 in range(0, wo, plan.tw):
            ih0 = oh0 * s - 1
            c_lo = max(0, ow0 * s - 1)
            c_hi = min(w, (ow0 + plan.tw - 1) * s + 2)
            b_lo = c_lo * cin // 16 * 16
            b_hi = min(w * cin, -(-(c_hi * cin) // 16) * 16)
            xs = np.zeros((rows, pitch), np.int64)
            for q in range(rows):
                if 0 <= ih0 + q < h:
                    xs[q, left:left + b_hi - b_lo] = flat[ih0 + q, b_lo:b_hi]
            pix = [(r, c) for r in range(plan.rows) for c in range(plan.tw)
                   if oh0 + r < ho and ow0 + c < wo]
            base = np.array([left + (ow0 + c) * s * cin - b_lo + r * s * pitch
                             for r, c in pix])
            a = xs.reshape(-1)[base[:, None] + koff[None, :]]   # im2col
            y = _requant_np(a @ wk.T, mult, bias)
            for (r, c), row in zip(pix, y):
                out[oh0 + r, ow0 + c] = row
    return out


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hwc", [(12, 10, 24, 16), (7, 7, 3, 32),
                                 (9, 11, 40, 8)])
def test_dense_implicit_gemm_matches_reference(rng, bits, stride, hwc):
    h, w_, cin, cout = hwc
    x = rng.integers(0, 255, (h, w_, cin)).astype(np.uint8)
    wf = rng.normal(size=(cout, 3, 3, cin)).astype(np.float32)
    packed, _ = jops.prep_conv3x3(jnp.asarray(wf), bits)
    mult, bias = _requant_operands(rng, cout)
    args = (jnp.asarray(x), packed, jnp.asarray(mult), jnp.asarray(bias))
    pallas = jnkc.conv3x3_dense(*args, bits=bits, cin=cin, stride=stride,
                                bco=16, bci=8, interpret=True)
    got = _dense_implicit_gemm(x, np.asarray(packed), mult, bias, bits=bits,
                               cin=cin, stride=stride)
    _assert_equal(torch.from_numpy(got), pallas)


@pytest.mark.parametrize("shape", [(224, 224, 3, 32, 2), (12, 10, 24, 16, 1),
                                   (7, 7, 3, 32, 2), (9, 11, 40, 8, 2),
                                   (13, 7, 64, 40, 1), (112, 112, 32, 64, 1)])
def test_dense_plan_tiles_the_map(shape):
    h, w, cin, cout, s = shape
    plan = nkc.dense_plan(h, w, cout, s)
    ho, wo = -(-h // s), -(-w // s)
    assert 1 <= plan.rows <= ho and 1 <= plan.tw <= wo
    assert plan.rows * plan.tw <= 64 and plan.tw <= 32
    assert plan.blocks == (-(-wo // plan.tw) * -(-ho // plan.rows)
                           * -(-cout // nkc.DENSE_BN))


# --- the depthwise kernel's tiling and launch plan ------------------------

def _byte_perm(x, y, sel):
    # __byte_perm: result byte n is byte (sel >> 4n) & 7 of (x, y)
    src = np.stack([(x >> (8 * b)) & 0xFF for b in range(4)]
                   + [(y >> (8 * b)) & 0xFF for b in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << (8 * n)
    return out


def _dp4a_us(a, b, c):
    # dp4a.u32.s32: c + unsigned bytes of a times signed bytes of b
    for n in range(4):
        ua = (a >> (8 * n)) & 0xFF
        sb = ((b >> (8 * n)) & 0xFF).astype(np.int64)
        c = c + ua.astype(np.int64) * np.where(sb > 127, sb - 256, sb)
    return c


def _direct_taps(x, ih, iw, ch, vec, live):
    # the direct route's load of each thread's vec channels at (ih, iw):
    # zeros outside the map and for threads with no output
    h, w, _ = x.shape
    inside = live & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
    out = np.zeros((len(ih), vec), np.int64)
    out[inside] = x[ih[inside, None], iw[inside, None],
                    ch[inside, None] + np.arange(vec)]
    return out


def _dw_kernel(x, packed, mult, bias, *, bits, stride, plan):
    """csrc/neureka_conv.cu::dw3x3_vec in numpy, block by block and thread
    by thread (vectorised over a block's threads) as ``plan`` launches it:
    the staged window with its zero halo (flat, pixel-major, cg channels a
    pixel) or, on the direct route, each thread's nine taps read from the
    map with zeros outside it, the level words (kernel row i of channel c:
    taps 3i .. 3i + 2 as signed bytes, byte 3 zero), each thread's vec
    channels of its pixel read at the kernel's offsets, each kernel row's
    taps of four channels moved by the kernel's byte permutes into a word
    a channel and summed by dp4a.  Returns the output and how often each
    byte was written."""
    h, w, c = x.shape
    s, vec, cg, tw = stride, plan.vec, plan.cg, plan.tc
    ho, wo = -(-h // s), -(-w // s)
    ir, ic = (plan.rows - 1) * s + 3, (tw - 1) * s + 3
    tiles_w, tiles_h = -(-wo // tw), -(-ho // plan.rows)
    f = 8 // bits
    fields = (packed[:, :, None].astype(np.int64) >> (bits * np.arange(f))) \
        & ((1 << bits) - 1)
    levels = fields.reshape(c, -1)[:, :9] - (1 << (bits - 1))
    nw = -(-vec // 4)
    zz, yy, xk = np.meshgrid(np.arange(plan.rows), np.arange(tw),
                             np.arange(cg // vec), indexing="ij")
    zz, yy, k = zz.ravel(), yy.ravel(), xk.ravel() * vec
    out = np.zeros((ho, wo, c), np.uint8)
    written = np.zeros((ho, wo, c), np.int64)
    for gy in range(-(-c // cg)):
        c0 = gy * cg
        ncg = min(cg, c - c0)
        lvw = np.zeros((3, cg), np.int64)
        for i in range(3):
            for j in range(3):
                lvw[i, :ncg] |= ((levels[c0:c0 + ncg, 3 * i + j] & 0xFF)
                                 << (8 * j))
        mu = np.zeros(cg, np.float32)
        bi = np.zeros(cg, np.int32)
        mu[:ncg], bi[:ncg] = mult[c0:c0 + ncg], bias[c0:c0 + ncg]
        for bx in range(tiles_w * tiles_h):
            th, twi = divmod(bx, tiles_w)
            oh0, ow0 = th * plan.rows, twi * tw
            xs = np.zeros(ir * ic * cg, np.int64)
            for pix in range(ir * ic):
                q, col = divmod(pix, ic)
                ih, iw = oh0 * s - 1 + q, ow0 * s - 1 + col
                if 0 <= ih < h and 0 <= iw < w:
                    xs[pix * cg:pix * cg + ncg] = x[ih, iw, c0:c0 + ncg]
            oh, ow = oh0 + zz, ow0 + yy
            live = (oh < ho) & (ow < wo) & (k < ncg)
            base = (zz * s * ic + yy * s) * cg + k
            acc = np.zeros((len(k), vec), np.int64)
            for i in range(3):
                lv = lvw[i][k[:, None] + np.arange(vec)]          # (T, vec)
                row = base + i * ic * cg
                if plan.staged:
                    taps = [xs[row[:, None] + j * cg + np.arange(vec)]
                            for j in range(3)]                    # (T, vec)
                else:
                    taps = [_direct_taps(x, oh * s + i - 1, ow * s + j - 1,
                                         c0 + k, vec, live)
                            for j in range(3)]
                words = []
                for t in taps:
                    t4 = np.zeros((len(k), 4 * nw), np.int64)
                    t4[:, :vec] = t
                    words.append((t4.reshape(-1, nw, 4)
                                  << (8 * np.arange(4))).sum(-1))
                for wi in range(nw):
                    x0, x1, x2 = (wd[:, wi] for wd in words)
                    a = _byte_perm(x0, x1, 0x5140)
                    b = _byte_perm(x0, x1, 0x7362)
                    for ci, (src, sel) in enumerate(
                            ((a, 0x4410), (a, 0x5532), (b, 0x6610),
                             (b, 0x7732))):
                        ch = 4 * wi + ci
                        if ch < vec:
                            acc[:, ch] = _dp4a_us(_byte_perm(src, x2, sel),
                                                  lv[:, ch], acc[:, ch])
            ch = k[:, None] + np.arange(vec)
            y = _requant_np(acc[live], mu[ch[live]], bi[ch[live]])
            oo, ww, cc = (np.broadcast_to(oh[live, None], ch[live].shape),
                          np.broadcast_to(ow[live, None], ch[live].shape),
                          c0 + ch[live])
            out[oo, ww, cc] = y
            np.add.at(written, (oo, ww, cc), 1)
    return out, written


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hwc", [(9, 11, 40), (12, 10, 24), (7, 7, 960),
                                 (1, 1, 16)])
def test_dw_kernel_emulation_matches_reference(rng, bits, stride, hwc):
    h, w_, c = hwc
    x = rng.integers(0, 255, (h, w_, c)).astype(np.uint8)
    wf = rng.normal(size=(c, 3, 3)).astype(np.float32)
    packed, _ = jops.prep_dw3x3(jnp.asarray(wf), bits)
    mult, bias = _requant_operands(rng, c)
    args = (jnp.asarray(x), packed, jnp.asarray(mult), jnp.asarray(bias))
    pallas = np.asarray(jnkc.conv3x3_dw(*args, bits=bits, stride=stride,
                                        bc=16 if c < 64 else 64,
                                        interpret=True))
    # the plan launched from aligned and from odd pointers, both routes,
    # and a block of several channel vectors
    first = nkc.dw_plan(h, w_, c, stride)
    plans = {first, nkc.dw_plan(h, w_, c, stride, width=1)}
    plans |= {nkc.dw_tile(h, w_, c, stride, first.vec, cg, 128, staged)
              for cg in (first.cg, min(c, 4 * first.vec))
              for staged in (True, False)}
    for plan in plans:
        got, written = _dw_kernel(x, np.asarray(packed), mult, bias,
                                  bits=bits, stride=stride, plan=plan)
        assert (written == 1).all(), plan
        np.testing.assert_array_equal(got, pallas, err_msg=str(plan))


def _mnv2_dw_shapes():
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    return list(dict.fromkeys((j.h, j.w, j.cin, j.stride)
                              for j in mobilenet_v2_jobs(8, 224)
                              if j.op_kind == "dw3x3"))


# every distinct MobileNet-V2 1.0-224 depthwise shape (10 for its 17 jobs),
# and ragged ones: C not a multiple of 16, odd maps, a single pixel
DW_PLAN_SHAPES = _mnv2_dw_shapes() + [
    (9, 11, 40, 1), (9, 11, 40, 2), (12, 10, 24, 2), (9, 11, 17, 1),
    (7, 5, 1, 2), (1, 1, 16, 1), (225, 3, 2, 2)]


def test_dw_plan_shapes_are_mobilenets():
    assert len(_mnv2_dw_shapes()) == 10


@pytest.mark.parametrize("h,w,c,stride", DW_PLAN_SHAPES)
def test_dw_plan_covers_every_output_once(h, w, c, stride):
    ho, wo = -(-h // stride), -(-w // stride)
    for width in (16, 8, 1):
        plans = set(nkc.dw_plans(h, w, c, stride, width))
        # the rule's plan is one the sweep times
        assert nkc.dw_plan(h, w, c, stride, width) in plans
        for plan in plans:
            assert plan.vec <= width and c % plan.vec == 0
            assert plan.cg % plan.vec == 0 and plan.threads <= nkc.DW_THREADS
            assert 1 <= plan.rows <= 64
            assert nkc.dw_smem(plan, stride) <= nkc.MAX_SMEM
            tw = plan.tc
            tiles = (-(-wo // tw), -(-ho // plan.rows), -(-c // plan.cg))
            assert plan.blocks == np.prod(tiles) and tiles[2] <= 65535
            # the kernel's blocks x threads x vector lanes, as flat output
            # indices: each output byte exactly once
            th, tw_i, gy, z, y, xk, v = np.meshgrid(
                *(np.arange(n) for n in (tiles[1], tiles[0], tiles[2],
                                         plan.rows, plan.tc,
                                         plan.cg // plan.vec, plan.vec)),
                indexing="ij", sparse=True)
            oh = th * plan.rows + z
            ow = tw_i * tw + y
            ch = gy * plan.cg + xk * plan.vec + v
            hit = np.broadcast_to((oh < ho) & (ow < wo) & (ch < c),
                                  np.broadcast_shapes(oh.shape, ow.shape,
                                                      ch.shape))
            flat = np.broadcast_to((oh * wo + ow) * c + ch, hit.shape)[hit]
            counts = np.bincount(flat, minlength=ho * wo * c)
            assert counts.size == ho * wo * c and (counts == 1).all(), plan
