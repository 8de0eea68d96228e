"""Port parity: the plain ``qmatmul_f32`` against the reference Pallas kernel
(interpret mode) and its jnp oracle, over the sweep of ``test_kernels.py``.

Tolerances are the reference test's: 1e-4 for f32 x, 2e-2 for bf16 x.  On
CPU tensors the wrapper computes the plain version; the Hopper kernel
itself is held against it on the card by ``test_torch_gpu.py`` and
``chip_smoke.py``."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.qmatmul import qmatmul_f32 as jqmatmul  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_f32  # noqa: E402

BITS = (2, 4, 8)


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
