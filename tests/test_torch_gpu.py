"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips, from inside the ``cuda`` fixture, unless a
CUDA device of compute capability 9.0 is present.  On a machine with one:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_f32  # noqa: E402
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


def test_qmatmul_kernel_bf16_input(cuda, rng):
    x = torch.from_numpy(rng.normal(size=(24, 80)).astype(np.float32))
    packed, scale = _packed(rng, 40, 80, 4, cuda)
    xb = x.to(cuda, torch.bfloat16)
    got = qmatmul_f32(xb, packed, scale, bits=4, k_orig=80)
    expect = ref.qmatmul_f32(xb, packed, scale, bits=4, k_orig=80)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window,offsets", [
    (4, 16, 8, 64, 512, 128, None, (0, 64, 192, 448)),
    (4, 16, 8, 64, 256, 128, 48, (0, 64, 100, 192)),
    (2, 4, 2, 37, 37, 16, None, None),
    (3, 1, 1, 17, 80, 64, None, None),
    (1, 2, 1, 1, 64, 32, 16, None),
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


def test_serving_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("qwen3-0.6b").smoke()
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
