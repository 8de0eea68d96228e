"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips, from inside the ``cuda`` fixture, unless a
CUDA device of compute capability 9.0 is present.  On a machine with one:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import packing, paging, placement, quantize  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import neureka_conv as nkc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.qmatmul import (int8_plan,  # noqa: E402
                                         qmatmul_f32,
                                         qmatmul_f32_blockscale,
                                         qmatmul_f32_blockscale_grouped,
                                         qmatmul_f32_grouped,
                                         qmatmul_int8)
from repro_torch.kernels.ssm_scan import selective_scan  # noqa: E402
from repro_torch.models import mobilenet_v2 as mnv2  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _packed(rng, n, k, bits, dev):
    # the model's init scale (std K^-0.5) keeps outputs O(1) at K = 3072
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)) * k ** -0.5
    packed, scale = ops.prep_linear(w, bits)
    return packed.to(dev), scale.to(dev)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 2048), (256, 3072, 1024),
                                   (1, 33, 7), (96, 200, 130), (17, 129, 65)])
def test_qmatmul_kernel_matches_plain(cuda, rng, bits, m, k, n):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    packed, scale = _packed(rng, n, k, bits, cuda)
    before = qmatmul_f32.launches
    got = qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
    torch.cuda.synchronize()
    assert qmatmul_f32.launches == before + 1
    expect = ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits,m,k,n", [(4, 24, 80, 40), (2, 256, 1024, 1024),
                                        (4, 256, 1024, 1024),
                                        (8, 256, 1024, 1024)])
def test_qmatmul_kernel_bf16_input(cuda, rng, bits, m, k, n):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    packed, scale = _packed(rng, n, k, bits, cuda)
    xb = x.to(cuda, torch.bfloat16)
    got = qmatmul_f32(xb, packed, scale, bits=bits, k_orig=k)
    expect = ref.qmatmul_f32(xb, packed, scale, bits=bits, k_orig=k)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,offsets", [
    (4, 16, 8, 64, 512, 128, None, (0, 64, 192, 448)),
    (4, 16, 8, 64, 256, 128, 48, (0, 64, 100, 192)),
    (2, 4, 2, 37, 37, 16, None, None),
    (3, 1, 1, 17, 80, 64, None, None),
    (1, 2, 1, 1, 64, 32, 16, None),
    # head dim 256 (gemma-7b): its prefill chunk, a window, a ragged span
    (4, 16, 16, 64, 512, 256, None, (0, 64, 192, 448)),
    (2, 4, 4, 40, 300, 256, 64, None),
    (1, 2, 2, 13, 13, 256, None, None),
])
def test_flash_kernel_matches_plain(cuda, rng, b, hq, hkv, sq, sk, d, window,
                                    offsets):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(cuda)
    q, k, v = t(b, hq, sq, d), t(b, hkv, sk, d), t(b, hkv, sk, d)
    off = (None if offsets is None
           else torch.tensor(offsets, dtype=torch.int32, device=cuda))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    expect = ref.flash_attention(q, k, v, causal=True, window=window,
                                 q_offset=off)
    torch.testing.assert_close(got, expect, rtol=3e-5, atol=3e-5)


def test_flash_kernel_not_causal_folded(cuda, rng):
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 50, 16)).astype(
        np.float32)).to(cuda) for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    expect = ref.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, expect, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "hymba-1.5b", "qwen2-moe-a2.7b"])
def test_serving_on_the_card_matches_the_cpu(cuda, arch):
    cfg = get_config(arch).smoke()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, int(rng.integers(5, 40))).astype(np.int32)
               for _ in range(6)]
    out = {}
    for dev in ("cpu", "cuda"):
        packed = freeze_for_serving(params, bits=8, device=dev)
        eng = ServingEngine(cfg, packed, batch_slots=4, max_len=128,
                            device=dev, prefill_chunk=16)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out[dev] = {r.uid: r.generated for r in eng.run_until_done()}
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("continuous", [False, True])
def test_scheduled_xr_serve_on_the_card_matches_the_cpu(cuda, continuous):
    """The XR traffic of ``chip_smoke.py`` (24 requests) behind the
    ``Scheduler`` on the virtual clock: the card gives the CPU's tokens and
    decisions per uid (admission, first-token and finish times,
    preemptions, rejections) and counters."""
    import chip_smoke as cs
    from repro_torch import serving

    cfg = get_config("qwen3-0.6b").smoke()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        packed = freeze_for_serving(params, bits=8, device=dev)
        eng = serving.ServingEngine(cfg, packed, batch_slots=cs.XR["slots"],
                                    max_len=cs.XR["max_len"], device=dev)
        clock = cs.VirtualClock()
        sched = cs.xr_scheduler(serving.Scheduler, eng, clock, continuous)
        before = qmatmul_f32.launches
        done, admitted = cs.serve_xr(sched, clock, cs.xr_traffic(
            serving.Request, cfg.vocab_size, 24))
        launched = qmatmul_f32.launches - before
        out[dev] = ({r.uid: r.generated for r in done},
                    cs.xr_record(sched, done, admitted))
        serving.validate(sched.metrics.summary(paging=eng.paging_summary()))
    assert launched > 0
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1]
    if continuous:
        assert out["cuda"][1]["counters"]["preemptions"] > 0


def _requant(rng, n, dev):
    mult = torch.from_numpy(rng.uniform(1e-4, 1e-3, (n,)).astype(np.float32))
    bias = torch.from_numpy(rng.integers(-8, 8, (n,)).astype(np.int32))
    return mult.to(dev), bias.to(dev)


def _u8(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)
                            ).to(dev)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(40, 130, 50), (1, 1280, 1000),
                                   (49, 320, 1280), (12544, 16, 96),
                                   (3136, 24, 144), (17, 33, 7)])
def test_qmatmul_int8_kernel_matches_plain(cuda, rng, bits, m, k, n):
    x = _u8(rng, (m, k), cuda)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    packed = ops.prep_linear(w, bits)[0].to(cuda)
    mult, bias = _requant(rng, n, cuda)
    before = qmatmul_int8.launches
    got = qmatmul_int8(x, packed, mult, bias, bits=bits, k_orig=k)
    torch.cuda.synchronize()
    assert qmatmul_int8.launches == before + 1
    assert torch.equal(got, ref.qmatmul_int8(x, packed, mult, bias,
                                             bits=bits, k_orig=k))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w,cin,cout", [(12, 10, 24, 16), (7, 7, 3, 32),
                                          (224, 224, 3, 32)])
def test_conv3x3_dense_kernel_matches_plain(cuda, rng, bits, stride, h, w,
                                            cin, cout):
    x = _u8(rng, (h, w, cin), cuda)
    wf = torch.from_numpy(rng.normal(size=(cout, 3, 3, cin)).astype(
        np.float32))
    packed = ops.prep_conv3x3(wf, bits)[0].to(cuda)
    mult, bias = _requant(rng, cout, cuda)
    before = nkc.conv3x3_dense.launches
    got = nkc.conv3x3_dense(x, packed, mult, bias, bits=bits, cin=cin,
                            stride=stride)
    torch.cuda.synchronize()
    assert nkc.conv3x3_dense.launches == before + 1
    assert torch.equal(got, ref.conv3x3_dense(x, packed, mult, bias,
                                              bits=bits, cin=cin,
                                              stride=stride))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w,c", [(9, 11, 40), (112, 112, 96),
                                   (7, 7, 960), (12, 10, 24), (9, 11, 17),
                                   (7, 5, 1)])
def test_conv3x3_dw_kernel_matches_plain(cuda, rng, bits, stride, h, w, c):
    x = _u8(rng, (h, w, c), cuda)
    wf = torch.from_numpy(rng.normal(size=(c, 3, 3)).astype(np.float32))
    packed = ops.prep_dw3x3(wf, bits)[0].to(cuda)
    mult, bias = _requant(rng, c, cuda)
    before = nkc.conv3x3_dw.launches
    got = nkc.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride)
    torch.cuda.synchronize()
    assert nkc.conv3x3_dw.launches == before + 1
    expect = ref.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride)
    assert torch.equal(got, expect)
    # every plan the sweep times, forced
    for plan in nkc.dw_plans(h, w, c, stride):
        got = nkc.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride,
                             plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, expect), plan


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w,c", [(9, 11, 40), (56, 56, 144), (7, 7, 960)])
def test_conv3x3_dw_kernel_x_at_a_byte_offset(cuda, rng, bits, stride, h, w,
                                              c):
    # x starts one byte into its buffer: the plan takes one channel a
    # thread, and a forced 16 B plan is refused, not run
    buf = _u8(rng, (h * w * c + 1,), cuda)
    x = buf[1:].view(h, w, c)
    assert x.data_ptr() % 2 == 1 and x.is_contiguous()
    wf = torch.from_numpy(rng.normal(size=(c, 3, 3)).astype(np.float32))
    packed = ops.prep_dw3x3(wf, bits)[0].to(cuda)
    mult, bias = _requant(rng, c, cuda)
    expect = ref.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride)
    got = nkc.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(got, expect)
    # the wrapper records the plan it launched: one channel a thread
    assert nkc.conv3x3_dw.plans[-1] == nkc.dw_plan(h, w, c, stride, width=1)
    wide = nkc.dw_plan(h, w, c, stride)
    assert wide.vec > 1
    before = nkc.conv3x3_dw.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        nkc.conv3x3_dw(x, packed, mult, bias, bits=bits, stride=stride,
                       plan=wide)
    assert nkc.conv3x3_dw.launches == before
    assert nkc.conv3x3_dw.plans[-1] != wide


def test_conv1x1_strided_on_the_card(cuda, rng):
    x = _u8(rng, (7, 9, 33), cuda)
    wf = torch.from_numpy(rng.normal(size=(17, 33)).astype(np.float32))
    packed = ops.prep_linear(wf, 4)[0].to(cuda)
    mult, bias = _requant(rng, 17, cuda)
    got = nkc.conv1x1(x, packed, mult, bias, bits=4, cin=33, stride=2)
    assert torch.equal(got, ref.conv1x1(x, packed, mult, bias, bits=4,
                                        cin=33, stride=2))


@pytest.mark.parametrize("bits", [8, 2])
def test_mobilenet_on_the_card_matches_the_cpu(cuda, bits):
    params = mnv2.init_params(torch.Generator().manual_seed(0),
                              weight_bits=bits, img=96, device="cpu")
    frozen = mnv2.freeze_packed(params, weight_bits=bits, img=96)
    on_card = {n: {k: v.to(cuda) for k, v in leaf.items()}
               for n, leaf in frozen.items()}
    image = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (96, 96, 3)).astype(np.uint8))
    counts = (nkc.conv3x3_dense.launches, nkc.conv3x3_dw.launches,
              qmatmul_int8.launches)
    got = mnv2.apply(on_card, image.to(cuda), weight_bits=bits, img=96)
    torch.cuda.synchronize()
    assert (nkc.conv3x3_dense.launches - counts[0],
            nkc.conv3x3_dw.launches - counts[1],
            qmatmul_int8.launches - counts[2]) == (1, 17, 35)
    assert torch.equal(got.cpu(), mnv2.apply(frozen, image, weight_bits=bits,
                                             img=96))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_mobilenet_freeze_on_the_card_matches_the_cpu(cuda, bits):
    params = mnv2.init_params(torch.Generator().manual_seed(1),
                              weight_bits=bits, img=32, device="cpu")
    on_cpu = mnv2.freeze_packed(params, weight_bits=bits, img=32)
    on_card = mnv2.freeze_packed(
        {n: {k: v.to(cuda) for k, v in leaf.items()}
         for n, leaf in params.items()}, weight_bits=bits, img=32)
    for name, leaf in on_card.items():
        assert torch.equal(leaf["packed"].cpu(), on_cpu[name]["packed"])
        assert torch.equal(leaf["bias"].cpu(), on_cpu[name]["bias"])
        torch.testing.assert_close(leaf["mult"].cpu(), on_cpu[name]["mult"],
                                   rtol=1e-6, atol=0)


def _scan_inputs(rng, bsz, s, di, n, dev, h0=True):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    x = t(rng.normal(size=(bsz, s, di)))
    dt = t(rng.uniform(0.001, 0.1, (bsz, s, di)))
    A = t(-rng.uniform(0.5, 2.0, (di, n)))
    B = t(rng.normal(size=(bsz, s, n)))
    C = t(rng.normal(size=(bsz, s, n)))
    D = t(rng.normal(size=(di,)))
    return x, dt, A, B, C, D, (t(rng.normal(size=(bsz, di, n))) if h0
                               else None)


# the falcon-mamba prefill and decode shapes, a hymba prefill, ragged S and
# Di, the sweep of the reference's kernel test (test_ssm_kernel.py:11-16),
# and an empty sequence (h_last = h0)
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("bsz,s,di,n", [
    (4, 64, 8192, 16), (4, 1, 8192, 16), (4, 200, 3200, 16),
    (2, 37, 200, 16), (2, 20, 12, 4), (1, 64, 32, 16), (2, 33, 24, 8),
    (1, 7, 8, 4), (3, 45, 70, 32), (2, 0, 64, 16)])
def test_selective_scan_kernel_matches_plain(cuda, rng, bsz, s, di, n, h0):
    args = _scan_inputs(rng, bsz, s, di, n, cuda, h0)
    before = selective_scan.launches
    y, h = selective_scan(*args)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    y_ref, h_ref = ref.selective_scan(*args)
    torch.testing.assert_close(y, y_ref, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(h, h_ref, rtol=5e-4, atol=5e-4)


def test_selective_scan_kernel_pads_are_state_no_ops(cuda, rng):
    """dt = 0 at the pads: h_last equals the real tokens' h_last exactly."""
    x, dt, A, B, C, D, h0 = _scan_inputs(rng, 4, 64, 8192, 16, cuda)
    real = 37
    dt_pad = dt.clone()
    dt_pad[:, real:] = 0
    _, h_pad = selective_scan(x, dt_pad, A, B, C, D, h0)
    _, h_real = selective_scan(x[:, :real].contiguous(),
                               dt[:, :real].contiguous(), A,
                               B[:, :real], C[:, :real], D, h0)
    torch.cuda.synchronize()
    assert torch.equal(h_pad, h_real)


def test_selective_scan_kernel_strided_b_c_and_types(cuda, rng):
    x, dt, A, _, _, D, h0 = _scan_inputs(rng, 2, 40, 64, 16, cuda)
    dbc = torch.from_numpy(rng.normal(size=(2, 40, 8 + 32)).astype(
        np.float32)).to(cuda)
    B, C = dbc[..., 8:24], dbc[..., 24:]
    y, h = selective_scan(x, dt, A, B, C, D, h0)
    y_ref, h_ref = ref.selective_scan(x, dt, A, B, C, D, h0)
    torch.testing.assert_close(y, y_ref, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(h, h_ref, rtol=5e-4, atol=5e-4)
    # bf16 x, dt and strided B, C take the kernel's bf16 route: y in bf16
    xb, dtb, dbcb = x.bfloat16(), dt.bfloat16(), dbc.bfloat16()
    Bb, Cb = dbcb[..., 8:24], dbcb[..., 24:]
    before = dict(selective_scan.launches_by_dtype)
    y, h = selective_scan(xb, dtb, A, Bb, Cb, D, h0)
    assert (selective_scan.launches_by_dtype["bfloat16"]
            == before.get("bfloat16", 0) + 1)
    y_ref, h_ref = ref.selective_scan(xb, dtb, A, Bb, Cb, D, h0)
    assert y.dtype == y_ref.dtype == torch.bfloat16
    torch.testing.assert_close(y, y_ref, **SCAN_BF16_TOL)
    torch.testing.assert_close(h, h_ref, rtol=5e-4, atol=5e-4)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        selective_scan(xb, dt, A, B, C, D, h0)


# bf16 inputs: the kernel and the plain version widen the same bf16 values
# and scan in f32, so h_last holds the f32 tolerance; y is rounded to bf16
# by both, and a 5e-4 difference before that rounding may move it by one
# bf16 ulp (2^-8 of |y|), so y holds two ulps
SCAN_BF16_TOL = dict(rtol=2 ** -7, atol=5e-4)


# hymba-1.5b's and falcon-mamba-7b's prefill and decode shapes, a ragged S,
# a Di whose rows are not whole 16 B (the plain-load ring), N 4 / 8 / 32
@pytest.mark.parametrize("bsz,s,di,n", [
    (4, 1163, 3200, 16), (4, 1, 3200, 16), (4, 64, 8192, 16),
    (4, 1, 8192, 16), (2, 37, 200, 16), (2, 33, 70, 8), (3, 45, 68, 32),
    (2, 20, 12, 4), (2, 1, 12, 4)])
def test_selective_scan_kernel_bf16_matches_plain(cuda, rng, bsz, s, di, n):
    """B7's bf16 route (bf16 x, dt, B, C; f32 A, D, h0) against its plain
    version, which widens the same inputs to f32."""
    x, dt, A, B, C, D, h0 = _scan_inputs(rng, bsz, s, di, n, cuda)
    args = (x.bfloat16(), dt.bfloat16(), A, B.bfloat16(), C.bfloat16(), D, h0)
    y, h = selective_scan(*args)
    y_ref, h_ref = ref.selective_scan(*args)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, y_ref, **SCAN_BF16_TOL)
    torch.testing.assert_close(h, h_ref, rtol=5e-4, atol=5e-4)
    cache = h0.clone()
    y_ip, h_ip = selective_scan(*args[:-1], cache, h_out=cache)
    torch.cuda.synchronize()
    assert torch.equal(y_ip, y) and torch.equal(h_ip, h)


@pytest.mark.parametrize("s", [64, 1])
def test_selective_scan_kernel_writes_the_state_over_h0(cuda, rng, s):
    """h_out = h0 (the serve cache's in-place update) gives the same y and
    h_last as a fresh output, bit for bit."""
    x, dt, A, B, C, D, h0 = _scan_inputs(rng, 4, s, 8192, 16, cuda)
    y, h = selective_scan(x, dt, A, B, C, D, h0)
    cache = h0.clone()
    y_ip, h_ip = selective_scan(x, dt, A, B, C, D, cache, h_out=cache)
    torch.cuda.synchronize()
    assert h_ip is cache
    assert torch.equal(y_ip, y) and torch.equal(h_ip, h)


def flash_bf16_bound(expect, p_rounded):
    """chip_smoke.py's bound on |B2 bf16 - plain|, elementwise: both round
    the output to bf16 and may land one ulp apart (2^-7 of |o|, 1e-5 near
    0); with P rounded to bf16 the kernel rounds each weight at its running
    max, the plain version at the row's final max, which moves o by about
    2^-9 of the row's typical |o|: 2^-7 of the row's largest |o| on top."""
    bound = expect.abs() * 2 ** -7 + 1e-5
    if p_rounded:
        bound = bound + 2 ** -7 * expect.abs().amax(-1, keepdim=True)
    return bound


def assert_flash_bf16_close(got, expect, p_rounded):
    got, expect = got.float(), expect.float()
    ratio = ((got - expect).abs() / flash_bf16_bound(expect, p_rounded)).max()
    assert ratio <= 1, f"max err {ratio.item():.3f} of the bound"


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,offsets,causal", [
    (4, 16, 8, 64, 512, 128, None, (0, 64, 192, 448), True),   # qwen3 chunk
    (4, 25, 5, 1163, 2048, 64, 1024, (0, 0, 0, 0), True),       # hymba prompt
    (4, 16, 16, 64, 512, 256, None, (0, 64, 192, 448), True),   # gemma chunk
    (2, 4, 2, 100, 24, 64, None, None, True),    # rows that see no key
    (2, 8, 8, 32, 64, 32, 16, (0, 70), True),
    (1, 2, 2, 64, 280, 16, 40, (256,), False),
    (2, 6, 3, 45, 300, 32, None, (10, 255), True),
    (3, 4, 4, 17, 80, 16, None, None, True)])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_flash_kernel_bf16_matches_plain(cuda, rng, b, hq, hkv, sq, sk, d,
                                         window, offsets, causal, p_dtype):
    """B2's bf16 route at every head dim (16, 32, 64, 128, 256), split and
    unsplit plans, windows and rows that see no key, with P rounded to bf16
    and P kept f32-accurate, against the plain version on the same bf16
    inputs at the same P dtype; two calls give the same bits."""
    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda, torch.bfloat16)
    q, k, v = t((b, hq, sq, d)), t((b, hkv, sk, d)), t((b, hkv, sk, d))
    off = (None if offsets is None
           else torch.tensor(offsets, dtype=torch.int32, device=cuda))
    kw = dict(causal=causal, window=window, q_offset=off,
              p_dtype=getattr(torch, p_dtype))
    before = dict(fa.flash_attention.launches_by_dtype)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_by_dtype["bfloat16"]
            == before.get("bfloat16", 0) + 1)
    assert got.dtype == torch.bfloat16
    assert_flash_bf16_close(got, ref.flash_attention(q, k, v, **kw),
                            p_dtype == "bfloat16")
    assert torch.equal(got, flash_attention(q, k, v, **kw))
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.float(), v, **kw)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 256])
@pytest.mark.parametrize("k,n", [(1024, 2048), (1001, 65)])
def test_blockscale_kernel_bf16_input(cuda, rng, bits, m, k, n):
    """B3 at bf16 x (both loops): bf16 x is exact in TF32 and the plain
    version widens the same values, so it holds the f32 tolerance."""
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    packed, scales = _wire(rng, n, k, bits, cuda)
    before = dict(qmatmul_f32_blockscale.launches_by_dtype)
    got = qmatmul_f32_blockscale(x, packed, scales, bits=bits, k_orig=k)
    torch.cuda.synchronize()
    assert (qmatmul_f32_blockscale.launches_by_dtype["bfloat16"]
            == before.get("bfloat16", 0) + 1)
    expect = ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                        k_orig=k)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("e,c,k,n", [(60, 8, 2048, 1408), (60, 24, 1408, 2048),
                                     (5, 17, 1001, 65)])
def test_grouped_blockscale_kernel_bf16_input(cuda, rng, bits, e, c, k, n):
    """The grouped B3 at bf16 x, qwen2-moe-a2.7b's expert shapes among
    them."""
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    packed, scales = _wire(rng, e * n, k, bits, cuda)
    packed, scales = packed.reshape(e, n, -1), scales.reshape(e, n, -1)
    got = qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                         k_orig=k)
    expect = ref.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                                k_orig=k)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


def test_bf16_engine_prefills_and_decodes_on_the_card(cuda):
    """The bf16 qwen3-0.6b smoke engine and serve steps on the card: the
    prefill and decode logits against the CPU's plain path on the same
    weights, and an engine serve through the kernels' bf16 routes."""
    cfg = get_config("qwen3-0.6b").smoke().replace(dtype="bfloat16")
    packed = freeze_for_serving(tfm.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda),
        bits=8, device=cuda)
    def to_cpu(tree):
        return ({k: to_cpu(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.cpu())
    packed_cpu = to_cpu(packed)
    from repro_torch.launch import steps
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    logits = {}
    for dev, tree in ((cuda, packed), (torch.device("cpu"), packed_cpu)):
        cache = tfm.init_serve_cache(cfg, 2, 32, device=dev)
        pre, cache = steps.make_prefill_step(cfg)(tree, toks.to(dev), cache)
        nxt = pre[:, -1].argmax(-1, keepdim=True)
        dec, _ = steps.make_decode_step(cfg)(tree, nxt.cpu().to(dev), cache,
                                             12)
        logits[dev.type] = (pre.float().cpu(), dec.float().cpu(), nxt.cpu())
    (gp, gd, gn), (cp, cd, cn) = logits["cuda"], logits["cpu"]
    assert torch.isfinite(gp).all() and torch.isfinite(gd).all()
    # bf16 activations through 2 layers, card vs CPU order: a few ulps
    torch.testing.assert_close(gp, cp, rtol=0, atol=2 ** -4)
    if torch.equal(gn, cn):
        torch.testing.assert_close(gd, cd, rtol=0, atol=2 ** -4)
    before = {name: dict(w.launches_by_dtype) for name, w in (
        ("flash", fa.flash_attention), ("qmm", qmatmul_f32))}
    eng = ServingEngine(cfg, packed, batch_slots=2, max_len=48, device=cuda)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=np.arange(5 + uid,
                                                     dtype=np.int32),
                           max_new_tokens=6))
    done = []
    while eng.pending:
        done += eng.step()
    torch.cuda.synchronize()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 6 and all(0 <= t < cfg.vocab_size
                                             for t in r.generated)
               for r in done)
    for name, w in (("flash", fa.flash_attention), ("qmm", qmatmul_f32)):
        assert (w.launches_by_dtype.get("bfloat16", 0)
                > before[name].get("bfloat16", 0)), name


@pytest.mark.parametrize("attn_dtype", ["float32", "bfloat16"])
def test_bf16_model_attention_matches_chunked_attention(cuda, monkeypatch,
                                                        attn_dtype):
    """The bf16 qwen3-0.6b smoke model's prefill on the card, its attention
    computed in ``attn_dtype``: every call of the flash kernel's bf16 route
    against ``models/attention.chunked_attention`` (the reference's, held
    to JAX on the CPU) on the same inputs at that compute dtype, to
    ``flash_bf16_bound``: at f32 the kernel keeps P f32-accurate as the
    reference keeps p, at bf16 it rounds P as the reference rounds it."""
    from repro_torch.launch import steps
    from repro_torch.models import attention
    cfg = get_config("qwen3-0.6b").smoke().replace(dtype="bfloat16",
                                                   attn_dtype=attn_dtype)
    packed = freeze_for_serving(tfm.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda),
        bits=8, device=cuda)
    real, seen = ops.attention, []

    def held(q, k, v, *, causal, window, q_offset, compute_dtype):
        got = real(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   compute_dtype=compute_dtype)
        off = (q_offset.cpu() if isinstance(q_offset, torch.Tensor)
               else q_offset)
        expect = attention.chunked_attention(
            q.cpu(), k.cpu(), v.cpu(), causal=causal, window=window,
            q_offset=off, compute_dtype=compute_dtype)
        assert got.dtype == expect.dtype == torch.bfloat16
        assert_flash_bf16_close(got.cpu(), expect,
                                compute_dtype == torch.bfloat16)
        seen.append(tuple(q.shape))
        return got

    monkeypatch.setattr(tfm.kops, "attention", held)
    before = fa.flash_attention.launches_by_dtype.get("bfloat16", 0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12))).to(cuda)
    cache = tfm.init_serve_cache(cfg, 2, 32, device=cuda)
    logits, cache = steps.make_prefill_step(cfg)(packed, toks[:, :8], cache)
    # a second chunk at per-row offsets over the cache
    logits, _ = tfm.step(packed, toks[:, 8:], cache,
                         torch.tensor([8, 5], dtype=torch.int32,
                                      device=cuda), cfg, add_prefix=False)
    torch.cuda.synchronize()
    assert len(seen) == 2 * cfg.n_layers
    assert (fa.flash_attention.launches_by_dtype["bfloat16"]
            == before + len(seen))
    assert torch.isfinite(logits.float()).all()


def _wire(rng, n, k, bits, dev):
    """The page codec's wire form of an (n, k) weight at the model's init
    scale: packed levels and per-32 scales."""
    w = (rng.normal(size=(n, k)) * k ** -0.5).astype(np.float32)
    levels, scales = quantize.quantize_blockwise(w, bits)
    packed = packing.pack(torch.from_numpy(levels), bits)
    return packed.to(dev), torch.from_numpy(scales).to(dev)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 256])
@pytest.mark.parametrize("k,n", [(1024, 2048), (2048, 1024), (69, 9),
                                 (70, 130), (1001, 65)])
def test_blockscale_kernel_matches_plain(cuda, rng, bits, m, k, n):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda)
    packed, scales = _wire(rng, n, k, bits, cuda)
    before = qmatmul_f32_blockscale.launches
    got = qmatmul_f32_blockscale(x, packed, scales, bits=bits, k_orig=k)
    torch.cuda.synchronize()
    assert qmatmul_f32_blockscale.launches == before + 1
    expect = ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                        k_orig=k)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("e,c,k,n", [(60, 8, 2048, 1408), (60, 24, 1408, 2048),
                                     (5, 17, 1001, 65), (1, 4, 70, 130)])
def test_grouped_blockscale_kernel_matches_plain(cuda, rng, bits, e, c, k, n):
    """B3 over a stack of experts' wire-form pages (qwen2-moe-a2.7b's expert
    linears at decode and prefill capacity, a ragged K and C on each route,
    one expert), within 1e-4 of the plain version; an expert with no rows
    gives zeros, and two calls give the same bits."""
    x = torch.from_numpy(rng.normal(size=(e, c, k)).astype(np.float32)).to(
        cuda)
    x[::3] = 0.0
    packed, scales = _wire(rng, e * n, k, bits, cuda)
    packed, scales = packed.reshape(e, n, -1), scales.reshape(e, n, -1)
    before = qmatmul_f32_blockscale_grouped.launches
    got = qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                         k_orig=k)
    again = qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                           k_orig=k)
    torch.cuda.synchronize()
    assert qmatmul_f32_blockscale_grouped.launches == before + 2
    expect = ref.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                                k_orig=k)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)
    assert not got[::3].any()
    assert torch.equal(ops.quant_matmul_blockscale(x, packed, scales,
                                                   bits=bits, k_orig=k), got)


@pytest.mark.parametrize("e,m", [(0, 4), (3, 0), (1, 0)])
def test_empty_qmatmul_calls_launch_nothing(cuda, e, m):
    """An empty problem (no experts or no rows) gives zeros of its shape and
    adds nothing to any B1 / B3 wrapper's count."""
    k, n, bits = 96, 40, 4
    x = torch.zeros((e, m, k), device=cuda)
    packed = wpacked = torch.full((e, n, k // 2), 0x77, dtype=torch.uint8,
                                  device=cuda)
    scale = torch.ones((e, n), device=cuda)
    scales = torch.ones((e, n, k // 32), device=cuda)
    wrappers = (qmatmul_f32, qmatmul_f32_grouped, qmatmul_f32_blockscale,
                qmatmul_f32_blockscale_grouped)
    before = [w.launches for w in wrappers]
    outs = [qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k),
            qmatmul_f32_blockscale_grouped(x, wpacked, scales, bits=bits,
                                           k_orig=k)]
    if e == 1:
        outs += [qmatmul_f32(x[0], packed[0], scale[0], bits=bits,
                             k_orig=k)[None],
                 qmatmul_f32_blockscale(x[0], wpacked[0], scales[0],
                                        bits=bits, k_orig=k)[None]]
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before
    for out in outs:
        assert tuple(out.shape) == (e, m, n) and not out.any()


def test_blockscale_kernel_refuses_what_it_does_not_take(cuda, rng):
    x = torch.zeros((4, 64), device=cuda)
    packed, scales = _wire(rng, 8, 64, 8, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        qmatmul_f32_blockscale(x, packed.cpu(), scales, bits=8, k_orig=64)
    with pytest.raises(ValueError, match="block=32"):
        qmatmul_f32_blockscale(x, packed, scales, bits=8, k_orig=64,
                               block=16)
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul_f32_blockscale(x, torch.cat([packed, packed], 1)[:, ::2],
                               scales, bits=8, k_orig=64)


def test_pinned_page_stream_matches_the_sync_pass(cuda, rng):
    """The side-stream copies of an overlapped pass give the pages a sync
    pass gives, on the card, at every encoding the store serves."""
    w = {f"layer{i:02d}": dict(w=rng.normal(size=(96, 70)).astype(
        np.float32)) for i in range(6)}
    store = ws.freeze(w, ws.uniform_policy(4, min_size=16))
    plan = placement.PlacementPlan(
        default=placement.Placement("l1mram", 4, "paged", 8),
        rules=(("layer00/w", placement.Placement("l1mram", 4, "paged")),
               ("layer01/w", placement.Placement("l1mram", 4, "paged", 2))),
        wire_serve=True)
    sync = paging.HostPagedStore(store, 96 * 35 * 2, device=cuda, plan=plan)
    want = {}
    for _page, dev in sync.stream():
        want.update(dev)
    pager = paging.HostPagedStore(store, 96 * 35 * 2, device=cuda, plan=plan)
    got = pager.begin_pass().fence()
    assert set(got) == set(want) == set(store.params)
    for name, p in got.items():
        assert p.packed.device.type == "cuda"
        assert torch.equal(p.packed, want[name].packed)
        assert torch.equal(p.scale, want[name].scale)
    assert pager.wire_served == {f"layer{i:02d}/w" for i in range(2, 6)}
    wired = got["layer02/w"]
    assert wired.scale.shape == (96, 3)         # per-32 scales of K = 70
    sync.close()
    pager.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_block_writeback_fetch_scatter_on_the_card(cuda, dtype):
    """A KV block written back from the card's cache, fetched through the
    pool on the side stream and scattered by the engine comes back bit for
    bit (also the padded last block), first swapped, then a pool hit."""
    cfg = get_config("qwen3-0.6b").smoke().replace(dtype=dtype)
    packed = freeze_for_serving(tfm.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda),
        bits=8, device=cuda)
    eng = ServingEngine(cfg, packed, batch_slots=3, max_len=44, device=cuda)
    pool = paging.SharedPagePool(1 << 30)
    eng.attach_kv_paging(8, pool=pool)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for c in eng.cache["kv"].values():
        c.copy_(torch.randn(c.shape, generator=gen, device=cuda).to(c.dtype))
    want = {n: c.clone() for n, c in eng.cache["kv"].items()}
    full = {0: 6, 2: 3}                        # 44 rows: 5 blocks of 8 + 4
    for slot, n in full.items():
        eng.assign(Request(uid=slot, prompt=np.arange(4, dtype=np.int32)),
                   slot)
        eng.kv_table.writeback(slot, 0, n, eng.cache["kv"])
        eng._kv_synced[slot] = n
    for swaps, hits in ((9, 0), (9, 9)):
        for c in eng.cache["kv"].values():
            c.zero_()
        eng.fence_tick_params()                # demand pass: fetch, scatter
        torch.cuda.synchronize()
        assert (eng.kv_table.swap_count, eng.kv_table.pool_hits) == (swaps,
                                                                     hits)
        for name, c in eng.cache["kv"].items():
            for slot, n in full.items():
                rows = min(n * 8, 44)
                assert torch.equal(c[:, slot, :, :rows],
                                   want[name][:, slot, :, :rows])
                assert not c[:, slot, :, rows:].any()
            assert not c[:, 1].any()           # slot 1 is empty
    pool.close()


def _one_page_store(cuda, pool, name, seed):
    w = {name: dict(w=np.random.default_rng(seed).normal(
        size=(512, 1024)).astype(np.float32))}
    store = ws.freeze(w, ws.uniform_policy(8, min_size=16))
    return store, paging.HostPagedStore(store, 512 * 1024, device=cuda,
                                        pool=pool, name=name)


@pytest.mark.parametrize("evict", [False, True])
def test_pooled_page_evicted_while_a_kernel_reads_it(cuda, evict):
    """A pooled weight page that a co-tenant's fetch evicts while a kernel
    queued on the compute stream still reads it: its memory must not go to
    the next allocation on its store's copy stream before the kernel has
    run, so the output equals the one without eviction."""
    pool = paging.SharedPagePool(512 * 1024)   # room for one page
    store_a, a = _one_page_store(cuda, pool, "a", 0)
    _store_b, b = _one_page_store(cuda, pool, "b", 1)
    expect = int(store_a.params["a/w"].packed.to(torch.int64).sum())
    dev = a.begin_pass().fence()
    torch.cuda._sleep(200_000_000)             # ~0.1 s on the compute stream
    out = dev["a/w"].packed.to(torch.int64).sum()
    shape = dev["a/w"].packed.shape
    del dev                                    # the pool holds the page now
    if evict:
        b.begin_pass().fence()                 # evicts a's page
        assert pool.counters["a"]["evicted"] == 1
    with torch.cuda.stream(a._copy_stream):
        junk = torch.full(shape, 255, dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()
    assert int(out) == expect
    del junk
    pool.close()


def test_paged_wire_serve_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("qwen3-0.6b").smoke()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, int(rng.integers(5, 40))).astype(np.int32)
               for _ in range(6)]
    out = {}
    for dev in ("cpu", "cuda"):
        packed = freeze_for_serving(params, bits=4, device=dev)
        sizes = placement.packed_sizes(packed)
        plan = placement.plan_for_budget(
            sizes, sum(sizes.values()) // 2, sizes_bits=4,
            hot=placement.Placement("l1mram", 4, "resident"),
            cold=placement.Placement("l1mram", 4, "paged", 8))
        eng = ServingEngine(cfg, packed, batch_slots=4, max_len=128,
                            plan=plan, device=dev, prefill_chunk=16)
        eng.attach_paging(wire_serve=True)
        before = qmatmul_f32_blockscale.launches
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out[dev] = {r.uid: r.generated for r in eng.run_until_done()}
        if dev == "cuda":
            assert qmatmul_f32_blockscale.launches > before
        eng.pager.close()
    assert out["cuda"] == out["cpu"]


# The two tensor-core loops of both f32 kernels, csrc/qmm_decode.cuh (M <=
# 16) and csrc/qmm_tc.cuh (M > 16): the serves' decode and prefill shapes,
# both sides of the decode threshold, K = 0, and the same bits on every call
# (bf16 x at M = 256 is in test_qmatmul_kernel_bf16_input).  Tolerance 1e-4,
# as everywhere for these kernels.

def _f32_inputs(kernel, rng, m, k, n, bits, dev):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    if kernel == "qmatmul_f32":
        packed, scale = _packed(rng, n, k, bits, dev)
        return (lambda xx: qmatmul_f32(xx, packed, scale, bits=bits,
                                       k_orig=k),
                lambda xx: ref.qmatmul_f32(xx, packed, scale, bits=bits,
                                           k_orig=k), x)
    packed, scales = _wire(rng, n, k, bits, dev)
    return (lambda xx: qmatmul_f32_blockscale(xx, packed, scales, bits=bits,
                                              k_orig=k),
            lambda xx: ref.qmatmul_f32_blockscale(xx, packed, scales,
                                                  bits=bits, k_orig=k), x)


F32_KERNELS = ["qmatmul_f32", "qmatmul_f32_blockscale"]
COUNTERS = {"qmatmul_f32": qmatmul_f32,
            "qmatmul_f32_blockscale": qmatmul_f32_blockscale}


@pytest.mark.parametrize("kernel", F32_KERNELS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n", [(8192, 288),     # falcon-mamba x_proj
                                 (256, 8192),     # falcon-mamba dt_proj
                                 (100, 3200)])    # hymba dt_proj
def test_tc_path_at_the_serve_shapes(cuda, rng, kernel, bits, k, n):
    fn, plain, x = _f32_inputs(kernel, rng, 256, k, n, bits, cuda)
    before = COUNTERS[kernel].launches
    got = fn(x)
    torch.cuda.synchronize()
    assert COUNTERS[kernel].launches == before + 1
    torch.testing.assert_close(got, plain(x), rtol=1e-4, atol=1e-4)


# (K, N) of every packed linear the serves call at decode (M = 4):
# qwen3-0.6b's seven, falcon-mamba-7b's four (x_proj N = 288) and
# hymba-1.5b's, whose dt_proj rows (K = 100) are not 16 B aligned
DECODE_SHAPES = sorted({
    (1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024),
    (4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
    (1600, 1600), (1600, 320), (1600, 5504), (5504, 1600), (1600, 6400),
    (3200, 132), (100, 3200), (3200, 1600)})


@pytest.mark.parametrize("kernel", F32_KERNELS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_decode_path_at_the_serve_shapes(cuda, rng, kernel, bits, k, n):
    fn, plain, x = _f32_inputs(kernel, rng, 4, k, n, bits, cuda)
    before = COUNTERS[kernel].launches
    got = fn(x)
    torch.cuda.synchronize()
    assert COUNTERS[kernel].launches == before + 1
    torch.testing.assert_close(got, plain(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n", [(1024, 2048), (100, 3200), (8192, 288)])
def test_decode_path_bf16_input(cuda, rng, bits, m, k, n):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    packed, scale = _packed(rng, n, k, bits, cuda)
    xb = x.to(cuda, torch.bfloat16)
    got = qmatmul_f32(xb, packed, scale, bits=bits, k_orig=k)
    expect = ref.qmatmul_f32(xb, packed, scale, bits=bits, k_orig=k)
    torch.testing.assert_close(got, expect, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kernel", F32_KERNELS)
@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 64, 1157])
@pytest.mark.parametrize("k,n", [(1024, 1024), (1001, 515)])
def test_tc_path_around_the_decode_threshold(cuda, rng, kernel, m, k, n):
    fn, plain, x = _f32_inputs(kernel, rng, m, k, n, 4, cuda)
    got = fn(x)
    torch.testing.assert_close(got, plain(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", F32_KERNELS)
@pytest.mark.parametrize("m", [4, 17])
def test_f32_kernels_take_an_empty_k(cuda, rng, kernel, m):
    # K = 0: packed (N, 0) and, for the blockscale kernel, scales (N, 0);
    # both sides of the decode threshold give zeros, as the plain versions do
    x = torch.zeros((m, 0), device=cuda)
    packed = torch.zeros((64, 0), dtype=torch.uint8, device=cuda)
    if kernel == "qmatmul_f32":
        scale = torch.from_numpy(rng.random(64).astype(np.float32)).to(cuda)
        got = qmatmul_f32(x, packed, scale, bits=8, k_orig=0)
        expect = ref.qmatmul_f32(x, packed, scale, bits=8, k_orig=0)
    else:
        scales = torch.zeros((64, 0), device=cuda)
        got = qmatmul_f32_blockscale(x, packed, scales, bits=8, k_orig=0)
        expect = ref.qmatmul_f32_blockscale(x, packed, scales, bits=8,
                                            k_orig=0)
    assert got.shape == (m, 64)
    assert torch.equal(got, expect)
    assert not got.any()


@pytest.mark.parametrize("kernel", F32_KERNELS)
@pytest.mark.parametrize("m,k,n", [(256, 8192, 288),    # K split 22 ways
                                   (256, 1024, 2048),   # split 4 ways
                                   (256, 256, 8192),    # not split
                                   (4, 1024, 1024),     # decode, split 8 ways
                                   (4, 8192, 288),      # decode, 32 ways
                                   (4, 4096, 16384),    # decode, 4 ways
                                   (16, 8192, 4096),    # decode M = 16
                                   (4, 256, 8192)])     # decode, 2 ways
def test_f32_kernels_give_the_same_bits_every_call(cuda, rng, kernel, m, k,
                                                   n):
    fn, _, x = _f32_inputs(kernel, rng, m, k, n, 8, cuda)
    first = fn(x)
    assert torch.equal(fn(x), first)


# --- qmatmul_f32 grouped over MoE experts -----------------------------------

def _experts(rng, e, c, k, n, bits, dev, empty=()):
    """x (E, C, K) with the experts in ``empty`` given no rows (zero x, as
    dispatch leaves an unrouted expert), packed (E, N, Kp), scale (E, N)."""
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    x[list(empty)] = 0.0
    w = torch.from_numpy(rng.normal(size=(e * n, k)).astype(np.float32))
    packed, scale = ops.prep_linear(w * k ** -0.5, bits)
    return (torch.from_numpy(x).to(dev), packed.reshape(e, n, -1).to(dev),
            scale.reshape(e, n).to(dev))


# (E, C, K, N): qwen2-moe-a2.7b's expert linears at decode (C 8) and
# prefill (C 16, 24), one expert, and ragged shapes on both routes
GROUPED_SHAPES = [(60, 8, 2048, 1408), (60, 8, 1408, 2048),
                  (60, 16, 2048, 1408), (60, 24, 2048, 1408),
                  (60, 24, 1408, 2048), (1, 8, 2048, 1408),
                  (1, 24, 1408, 2048), (5, 13, 1001, 515), (3, 40, 129, 65)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("e,c,k,n", GROUPED_SHAPES)
def test_grouped_qmatmul_kernel_matches_plain(cuda, rng, bits, e, c, k, n):
    x, packed, scale = _experts(rng, e, c, k, n, bits, cuda,
                                empty=range(1, e, 3))
    before, plain_before = qmatmul_f32_grouped.launches, qmatmul_f32.launches
    got = qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
    torch.cuda.synchronize()
    assert qmatmul_f32_grouped.launches == before + 1
    assert qmatmul_f32.launches == plain_before
    expect = ref.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)
    assert not got[1::3].any()                  # empty experts give zeros
    assert torch.equal(qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                           k_orig=k), got)


@pytest.mark.parametrize("c", [4, 24])
def test_grouped_qmatmul_equals_the_plain_kernel_per_expert(cuda, rng, c):
    # the grouped launch computes each expert as the 2-D launch does
    x, packed, scale = _experts(rng, 6, c, 1024, 640, 4, cuda)
    got = qmatmul_f32_grouped(x, packed, scale, bits=4, k_orig=1024)
    for i in range(6):
        one = qmatmul_f32(x[i], packed[i], scale[i], bits=4, k_orig=1024)
        torch.testing.assert_close(got[i], one, rtol=1e-5, atol=1e-5)


def test_grouped_qmatmul_refuses_what_it_does_not_take(cuda, rng):
    x, packed, scale = _experts(rng, 3, 8, 64, 32, 8, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        qmatmul_f32_grouped(x, packed.cpu(), scale, bits=8, k_orig=64)
    with pytest.raises(ValueError, match="shape mismatch"):
        qmatmul_f32_grouped(x[:2], packed, scale, bits=8, k_orig=64)
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        qmatmul_f32_grouped(x[0], packed, scale, bits=8, k_orig=64)
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul_f32_grouped(torch.cat([x, x], 2)[:, :, ::2], packed, scale,
                            bits=8, k_orig=64)


# --- qmatmul_int8 and conv3x3_dense on the int8 tensor cores ---------------

def _mnv2_pw_shapes():
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    return list(dict.fromkeys((j.h * j.w, j.cin, j.cout)
                              for j in mobilenet_v2_jobs(8, 224)
                              if j.op_kind == "pw1x1"))


def _split_edges(m, n, odd=False, sms=132, most=3):
    # (m, k, n) on each side of the first K values where the plan changes its
    # number of K splits, on a card of `sms` SMs: K multiples of 32 (the
    # direct route), or one more (odd K: the staged route)
    ks = [k + int(odd) for k in range(32, 2049, 32)]
    out, prev = [], int8_plan(m, ks[0], n, sms).splits
    for lo, k in zip(ks, ks[1:]):
        splits = int8_plan(m, k, n, sms).splits
        if splits != prev and len(out) < 2 * most:
            out += [(m, lo, n), (m, k, n)]
        prev = splits
    return out


def _int8_case(rng, m, k, n, bits, dev, x=None):
    if x is None:
        x = _u8(rng, (m, k), dev)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    packed = ops.prep_linear(w, bits)[0].to(dev)
    # mult spreads the sums over ~40 LSB, as freeze_packed does
    mult = torch.full((n,), 40.0 / (128.0 * 40.0 * k ** 0.5),
                      dtype=torch.float32, device=dev)
    bias = torch.from_numpy(rng.integers(96, 160, n).astype(np.int32)).to(dev)
    return x, packed, mult, bias


def _int8_equal_twice(x, packed, mult, bias, bits):
    k = x.shape[1]
    before = qmatmul_int8.launches
    first = qmatmul_int8(x, packed, mult, bias, bits=bits, k_orig=k)
    torch.cuda.synchronize()
    assert qmatmul_int8.launches == before + 1
    assert torch.equal(first, ref.qmatmul_int8(x, packed, mult, bias,
                                               bits=bits, k_orig=k))
    assert torch.equal(qmatmul_int8(x, packed, mult, bias, bits=bits,
                                    k_orig=k), first)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m,k,n", _mnv2_pw_shapes())
def test_qmatmul_int8_at_the_mobilenet_shapes(cuda, rng, bits, m, k, n):
    _int8_equal_twice(*_int8_case(rng, m, k, n, bits, cuda), bits)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m,k,n", [(m, k, n) for k in (16, 24, 33, 130)
                                   for m, n in ((1, 1000), (49, 160),
                                                (784, 32))]
                         + [(1, 8, 3), (5, 4, 1)])
def test_qmatmul_int8_ragged_k(cuda, rng, bits, m, k, n):
    _int8_equal_twice(*_int8_case(rng, m, k, n, bits, cuda), bits)


@pytest.mark.parametrize("bits", [8, 2])
@pytest.mark.parametrize("m,k,n", [e for mn in ((49, 160), (1, 1000),
                                                (196, 96), (49, 1280))
                                   for odd in (False, True)
                                   for e in _split_edges(*mn, odd)])
def test_qmatmul_int8_around_the_split_thresholds(cuda, rng, bits, m, k, n):
    _int8_equal_twice(*_int8_case(rng, m, k, n, bits, cuda), bits)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("m,k,n", [(49, 320, 1280), (196, 64, 384),
                                   (1, 1280, 1000), (40, 130, 50)])
def test_qmatmul_int8_x_at_a_byte_offset(cuda, rng, bits, m, k, n):
    # x starts one byte into its buffer: the kernel takes byte loads for x
    buf = _u8(rng, (m * k + 1,), cuda)
    x = buf[1:].view(m, k)
    assert x.data_ptr() % 2 == 1 and x.is_contiguous()
    _int8_equal_twice(*_int8_case(rng, m, k, n, bits, cuda, x=x), bits)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w,cin,cout", [(13, 9, 3, 32), (11, 7, 24, 16),
                                          (9, 11, 40, 8), (7, 13, 64, 40),
                                          (225, 223, 3, 32)])
def test_conv3x3_dense_kernel_at_cin(cuda, rng, bits, stride, h, w, cin,
                                     cout):
    x = _u8(rng, (h, w, cin), cuda)
    wf = torch.from_numpy(rng.normal(size=(cout, 3, 3, cin)).astype(
        np.float32))
    packed = ops.prep_conv3x3(wf, bits)[0].to(cuda)
    mult = torch.full((cout,), 40.0 / (128.0 * 40.0 * (9 * cin) ** 0.5),
                      dtype=torch.float32, device=cuda)
    bias = torch.from_numpy(rng.integers(96, 160, cout).astype(np.int32)
                            ).to(cuda)
    before = nkc.conv3x3_dense.launches
    got = nkc.conv3x3_dense(x, packed, mult, bias, bits=bits, cin=cin,
                            stride=stride)
    torch.cuda.synchronize()
    assert nkc.conv3x3_dense.launches == before + 1
    assert torch.equal(got, ref.conv3x3_dense(x, packed, mult, bias,
                                              bits=bits, cin=cin,
                                              stride=stride))
    assert torch.equal(nkc.conv3x3_dense(x, packed, mult, bias, bits=bits,
                                         cin=cin, stride=stride), got)


# --- flash attention on the TF32 tensor cores: tiles, splits, GQA, C1 ---

def _flash_case(rng, dev, b, hq, hkv, sq, sk, d, offsets):
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)
    off = (None if offsets is None
           else torch.tensor(offsets, dtype=torch.int32, device=dev))
    return t(b, hq, sq, d), t(b, hkv, sk, d), t(b, hkv, sk, d), off


def _flash_plans(q, k):
    """The default split, unsplit, and split one kv tile a slice."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = fa.flash_plan(b, hq, hkv, sq, sk, d, sms)
    return sorted({base, fa.flash_plan(b, hq, hkv, sq, sk, d, sms,
                                       split_tiles=1),
                   fa.flash_plan(b, hq, hkv, sq, sk, d, sms,
                                 split_tiles=base.kv_tiles)})


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 5])
def test_flash_kernel_heads_and_groups_at_every_plan(cuda, rng, d, group):
    q, k, v, off = _flash_case(rng, cuda, 2, 2 * group, 2, 45, 200, d,
                               (30, 155))
    expect = ref.flash_attention(q, k, v, window=64, q_offset=off)
    for plan in _flash_plans(q, k):
        got = flash_attention(q, k, v, window=64, q_offset=off, plan=plan)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, expect, rtol=3e-5, atol=3e-5,
                                   msg=str(plan))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,offsets,causal", [
    (2, 4, 2, 100, 24, 64, None, None, True),      # Sq > Sk: whole blocks
    (2, 8, 8, 32, 64, 32, 16, (0, 70), True),      # a window past the keys
    (1, 2, 2, 64, 280, 16, 40, (256,), False),     # an empty row, 2 slices
    (1, 10, 2, 300, 256, 128, None, None, True),   # Sk = 256, GQA 5
    (3, 1, 1, 40, 24, 16, None, None, True),       # the folded form's case
])
def test_flash_kernel_rows_that_see_no_key(cuda, rng, b, hq, hkv, sq, sk, d,
                                           window, offsets, causal):
    """C1: a row that sees no key gets the plain version's mean of v, at
    every plan, whether its block walks tiles or none."""
    q, k, v, off = _flash_case(rng, cuda, b, hq, hkv, sq, sk, d, offsets)
    kw = dict(causal=causal, window=window, q_offset=off)
    expect = ref.flash_attention(q, k, v, **kw)
    for plan in _flash_plans(q, k):
        got = flash_attention(q, k, v, plan=plan, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, expect, rtol=3e-5, atol=3e-5,
                                   msg=str(plan))
    if offsets is None and causal:
        empty = sq - sk
        torch.testing.assert_close(
            got[:, :, :empty], v.mean(2, keepdim=True).repeat_interleave(
                hq // hkv, 1).expand(-1, -1, empty, -1), rtol=3e-5,
            atol=3e-5)


@pytest.mark.parametrize("window", [1024, 1 << 30])
def test_flash_kernel_hymba_long_prompt(cuda, rng, window):
    """hymba-1.5b's longest prompt as the engine sends it: 4 rows alike at
    offset 0, 25 / 5 heads, 1,163 queries over a 2,048-key span, a local
    window and a global layer's; twice, bit-equal."""
    q, k, v, off = _flash_case(rng, cuda, 4, 25, 5, 1163, 2048, 64,
                               (0, 0, 0, 0))
    got = flash_attention(q, k, v, window=window, q_offset=off)
    again = flash_attention(q, k, v, window=window, q_offset=off)
    expect = ref.flash_attention(q, k, v, window=window, q_offset=off)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, expect, rtol=3e-5, atol=3e-5)
    assert torch.equal(got, again)


def test_flash_kernel_split_gives_the_same_bits_every_call(cuda, rng):
    q, k, v, off = _flash_case(rng, cuda, 4, 16, 8, 64, 512, 128,
                               (0, 64, 192, 448))
    plan = fa.flash_plan(4, 16, 8, 64, 512, 128, 132, split_tiles=1)
    assert plan.splits > 1
    outs = [flash_attention(q, k, v, q_offset=off, plan=plan)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_flash_kernel_takes_more_than_65535_row_tiles(cuda, rng):
    """64 heads x 1,025 row tiles: more (batch row, kv head, row tile)
    tiles than a grid's y dimension holds."""
    q, k, v, _ = _flash_case(rng, cuda, 1, 64, 64, 65600, 32, 16, None)
    plan = fa.flash_plan(1, 64, 64, 65600, 32, 16, 132)
    assert 64 * plan.row_tiles > 65535
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention(q, k, v,
                                                        causal=False),
                               rtol=3e-5, atol=3e-5)


def test_launches_are_split_where_they_launch(cuda, rng):
    """Each launch adds one to its wrapper's count and one to its shape
    (flash) or route (scan)."""
    q, k, v, off = _flash_case(rng, cuda, 2, 4, 2, 45, 200, 64, (30, 155))
    before = flash_attention.launches, dict(flash_attention.launches_by_shape)
    flash_attention(q, k, v, q_offset=off)
    expect = dict(before[1])
    expect["Sq=45 Sk=200"] = expect.get("Sq=45 Sk=200", 0) + 1
    assert flash_attention.launches == before[0] + 1
    assert flash_attention.launches_by_shape == expect
    for s, route in ((1, "step"), (37, "chunked")):
        args = _scan_inputs(rng, 3, s, 256, 16, cuda, True)
        before = selective_scan.launches, dict(
            selective_scan.launches_by_route)
        selective_scan(*args)
        expect = dict(before[1])
        expect[route] = expect.get(route, 0) + 1
        assert selective_scan.launches == before[0] + 1
        assert selective_scan.launches_by_route == expect


# --- the scan's two routes ---

def _scan_plans(s, n):
    """The default plan and each route at each lanes count it takes."""
    plans = {ssm_scan.scan_plan(s, n)}
    for lanes in (1, 2, 4, 8):
        if 1 <= n // lanes <= ssm_scan.MAX_STATES:
            plans.add(ssm_scan.ScanPlan("step", lanes, 128, 0))
            plans.add(ssm_scan.ScanPlan("chunked", lanes,
                                        min(32, 256 // lanes), 8))
    return sorted(plans)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("s", [1, 2, 37])
def test_selective_scan_both_routes(cuda, rng, n, s):
    """Each route and lanes count at N 4-32, a ragged Di (4 B copies) and a
    Di of 16 B rows, with h_out = h0 in place bit-equal to a fresh output."""
    for di in (1001, 256):
        args = _scan_inputs(rng, 3, s, di, n, cuda, True)
        y_ref, h_ref = ref.selective_scan(*args)
        for plan in _scan_plans(s, n):
            y, h = selective_scan(*args, plan=plan)
            cache = args[-1].clone()
            y_ip, h_ip = selective_scan(*args[:-1], cache, h_out=cache,
                                        plan=plan)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, y_ref, rtol=5e-4, atol=5e-4,
                                       msg=str(plan))
            torch.testing.assert_close(h, h_ref, rtol=5e-4, atol=5e-4,
                                       msg=str(plan))
            assert torch.equal(y_ip, y) and torch.equal(h_ip, h)


@pytest.mark.parametrize("n", [4, 16, 32])
def test_selective_scan_pads_are_no_ops_on_each_route(cuda, rng, n):
    """dt = 0 pads leave h_last's bits as the real steps left them, on each
    route: all pads (h_last = h0) and pads after real steps."""
    x, dt, A, B, C, D, h0 = _scan_inputs(rng, 4, 40, 512, n, cuda)
    for plan in _scan_plans(40, n):
        for real in (0, 1, 23):
            dt_pad = dt.clone()
            dt_pad[:, real:] = 0
            _, h_pad = selective_scan(x, dt_pad, A, B, C, D, h0, plan=plan)
            h_real = h0 if real == 0 else selective_scan(
                x[:, :real].contiguous(), dt[:, :real].contiguous(), A,
                B[:, :real], C[:, :real], D, h0, plan=plan)[1]
            torch.cuda.synchronize()
            assert torch.equal(h_pad, h_real), (plan, real)


def _forward_only_calls(rng, dev):
    """{wrapper: (call, the float input that is made to require grad)} at
    small shapes, for C9."""
    f32 = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(dev)
    q, k = f32(1, 2, 8, 16), f32(1, 1, 8, 16)
    x = f32(4, 64)
    packed, scale = _packed(rng, 32, 64, 8, dev)
    xg, gpacked, gscale = _experts(rng, 2, 4, 64, 32, 8, dev)
    wpacked, wscales = _wire(rng, 32, 64, 8, dev)
    xq, ipacked, mult, bias = _int8_case(rng, 4, 64, 32, 8, dev)
    scan = list(_scan_inputs(rng, 1, 4, 64, 16, dev))
    img = _u8(rng, (8, 8, 16), dev)
    dpacked = ops.prep_conv3x3(torch.from_numpy(rng.normal(
        size=(16, 3, 3, 16)).astype(np.float32)), 8)[0].to(dev)
    dwpacked = ops.prep_dw3x3(torch.from_numpy(rng.normal(
        size=(16, 3, 3)).astype(np.float32)), 8)[0].to(dev)
    cmult, cbias = _requant(rng, 16, dev)
    return {
        "flash_attention": (lambda t: flash_attention(t, k, k), q),
        "qmatmul_f32": (lambda t: qmatmul_f32(t, packed, scale, bits=8,
                                              k_orig=64), x),
        "qmatmul_f32_grouped": (lambda t: qmatmul_f32_grouped(
            t, gpacked, gscale, bits=8, k_orig=64), xg),
        "qmatmul_f32_blockscale": (lambda t: qmatmul_f32_blockscale(
            t, wpacked, wscales, bits=8, k_orig=64), x),
        "qmatmul_int8": (lambda t: qmatmul_int8(xq, ipacked, t, bias, bits=8,
                                                k_orig=64), mult),
        "selective_scan": (lambda t: selective_scan(t, *scan[1:]), scan[0]),
        "conv3x3_dense": (lambda t: nkc.conv3x3_dense(
            img, dpacked, t, cbias, bits=8, cin=16), cmult),
        "conv3x3_dw": (lambda t: nkc.conv3x3_dw(img, dwpacked, t, cbias,
                                                bits=8), cmult),
        "conv1x1": (lambda t: nkc.conv1x1(img, ipacked[:, :16].contiguous(),
                                          t, bias, bits=8, cin=16), mult),
    }


@pytest.mark.parametrize("name", ["flash_attention", "qmatmul_f32",
                                  "qmatmul_f32_grouped",
                                  "qmatmul_f32_blockscale", "qmatmul_int8",
                                  "selective_scan", "conv3x3_dense",
                                  "conv3x3_dw", "conv1x1"])
def test_kernels_refuse_inputs_that_require_grad(cuda, rng, name):
    """C9: a launch's output has no grad_fn, so a wrapper given an input
    that requires grad under grad mode raises instead of cutting the
    gradient; under no_grad it launches."""
    call, t = _forward_only_calls(rng, cuda)[name]
    t.requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        call(t)
    with torch.no_grad():
        call(t)
    torch.cuda.synchronize()


def test_train_step_gradients_on_the_card_match_the_cpu(cuda):
    """One train step of the qwen3-0.6b smoke config on the card against
    the CPU from the same weights and batch: every gradient leaf present,
    finite and non-zero, within 1e-5 of the CPU's largest element; the
    loss within 1e-6, the updated params within 1e-4 (AdamW at lr 1e-3:
    see tests/test_torch_train.py)."""
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = get_config("qwen3-0.6b").smoke()
    cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = T.tree_map(lambda t: t.to(cuda), cpu)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMDataset(cfg.vocab_size, 64, 4, seed=0).batch(0).items()}
    lc, gc = steps.loss_and_grads(cpu, batch, cfg)
    lg, gg = steps.loss_and_grads(
        gpu, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-6, atol=0)
    for (path, a), b in zip(T.flatten_with_paths(gg), T.leaves(gc)):
        assert torch.isfinite(a).all() and a.abs().max() > 0, path
        assert (a.cpu() - b).abs().max() <= 1e-5 * b.abs().max(), path
    opt = adamw()
    step = steps.make_train_step(cfg, opt, lr=1e-3)
    pc, _, mc = step(cpu, opt.init(cpu), batch)
    pg, _, mg = step(gpu, opt.init(gpu),
                     {k: v.to(cuda) for k, v in batch.items()})
    torch.testing.assert_close(mg["grad_norm"].cpu(), mc["grad_norm"],
                               rtol=1e-5, atol=0)
    for a, b in zip(T.leaves(pg), T.leaves(pc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4)


def test_training_scan_on_the_card_matches_the_cpu(cuda, rng):
    """The training scan (``models/ssm.selective_scan``, differentiable
    torch ops) at falcon-mamba-7b's width, (2, 64, 8,192, 16) with the
    reference's chunk of 256, on the card against the CPU: y, h_last and
    every input's gradient within 1e-5 of the CPU's largest element, and
    the Hopper scan kernel never launched."""
    from repro_torch.models import ssm

    b, s, di, n = 2, 64, 8192, 16
    args = [rng.normal(size=(b, s, di)),
            np.abs(rng.normal(size=(b, s, di))) * 0.1,
            -np.exp(rng.normal(size=(di, n))), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n)), rng.normal(size=(di,)),
            rng.normal(size=(b, di, n))]
    ry, rh = rng.normal(size=(b, s, di)), rng.normal(size=(b, di, n))
    launches = selective_scan.launches
    out = {}
    for dev in ("cpu", cuda):
        xs = [torch.tensor(a, dtype=torch.float32, device=dev,
                           requires_grad=True) for a in args]
        y, h = ssm.selective_scan(*xs)
        (torch.sum(y * torch.tensor(ry, dtype=torch.float32, device=dev))
         + torch.sum(h * torch.tensor(rh, dtype=torch.float32, device=dev))
         ).backward()
        out[str(dev)] = [t.detach().cpu() for t in [y, h]] + [
            t.grad.cpu() for t in xs]
    torch.cuda.synchronize()
    assert selective_scan.launches == launches
    for i, (a, b_) in enumerate(zip(out["cuda"], out["cpu"])):
        assert torch.isfinite(a).all(), i
        assert (a - b_).abs().max() <= 1e-5 * b_.abs().max(), i
