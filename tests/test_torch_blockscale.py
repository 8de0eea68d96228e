"""Port parity: the page wire codec and the blockscale matmul (B3).

``quantize_blockwise`` / ``dequantize_blockwise`` and ``encoded_wire_bytes``
give the reference's bytes; the plain ``qmatmul_f32_blockscale`` matches
the JAX Pallas kernel in interpret mode within the JAX test's tolerance
(``tests/test_encoded_pages.py:102-118``); the wrapper's device rule and
the wire-serve dispatch of ``linear`` are checked on the CPU."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import memsys as jmemsys  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro.core.placement import PlacementPlan as JPlan  # noqa: E402
from repro.kernels.qmatmul import qmatmul_f32_blockscale as jblockscale  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch.core import memsys, packing, quantize  # noqa: E402
from repro_torch.core.placement import Placement, PlacementPlan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_f32_blockscale  # noqa: E402
from repro_torch.models import layers  # noqa: E402

BLOCK = quantize.PAGE_SCALE_BLOCK
TOL = dict(rtol=1e-5, atol=1e-5)          # the JAX kernel test's


def _wire(rng, n, k, bits):
    """(x-free) wire form of an (n, k) weight: packed levels + scales."""
    w = rng.normal(size=(n, k)).astype(np.float32)
    levels, scales = jquantize.quantize_blockwise(w, bits)
    return np.array(jpacking.pack(levels, bits)), scales


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k", [31, 33, 69, 70, 2 * BLOCK + 5])
def test_blockwise_codec_equals_reference(rng, bits, k):
    w = rng.normal(size=(9, k)).astype(np.float32)
    levels, scales = quantize.quantize_blockwise(w, bits)
    jlevels, jscales = jquantize.quantize_blockwise(w, bits)
    assert levels.dtype == np.int8 and scales.dtype == np.float32
    assert levels.tobytes() == np.asarray(jlevels).tobytes()
    assert scales.tobytes() == np.asarray(jscales).tobytes()
    deq = quantize.dequantize_blockwise(levels, scales)
    assert deq.tobytes() == np.asarray(
        jquantize.dequantize_blockwise(jlevels, jscales)).tobytes()


def test_blockwise_codec_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="block"):
        quantize.quantize_blockwise(np.zeros((2, 4), np.float32), 8, block=0)
    with pytest.raises(ValueError, match="2-D"):
        quantize.quantize_blockwise(np.zeros((2, 2, 4), np.float32), 8)


def test_encoded_wire_bytes_equals_reference():
    for rows, k, page_bits, block in [(6, 64, 4, 32), (5, 33, 2, 32),
                                      (9, 70, 8, 32), (1, 1, 8, 1),
                                      (28 * 2048, 1024, 8, 32)]:
        assert (memsys.encoded_wire_bytes(rows, k, page_bits, block)
                == jmemsys.encoded_wire_bytes(rows, k, page_bits, block))
    with pytest.raises(ValueError):
        memsys.encoded_wire_bytes(-1, 4, 8)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k", [64, 69, 70])
def test_plain_blockscale_matches_pallas_interpret(rng, bits, k):
    m, n = 4, 9
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed, scales = _wire(rng, n, k, bits)
    got = ref.qmatmul_f32_blockscale(torch.from_numpy(x),
                                     torch.from_numpy(packed),
                                     torch.from_numpy(scales), bits=bits,
                                     k_orig=k)
    expect = jblockscale(jnp.asarray(x), jnp.asarray(packed),
                         jnp.asarray(scales), bits=bits, k_orig=k,
                         block=BLOCK, bm=16, bn=16, bk=2 * BLOCK,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    # the codec's decoded form, as the JAX test holds its kernel against
    deq = quantize.dequantize_blockwise(
        packing.unpack(torch.from_numpy(packed), bits, k).numpy(), scales)
    np.testing.assert_allclose(got.numpy(), x @ deq.T, **TOL)


def test_wrapper_on_cpu_tensors_is_the_plain_version(rng):
    x = rng.normal(size=(2, 3, 70)).astype(np.float32)
    packed, scales = _wire(rng, 11, 70, 8)
    before = qmatmul_f32_blockscale.launches
    got = ops.quant_matmul_blockscale(torch.from_numpy(x),
                                      torch.from_numpy(packed),
                                      torch.from_numpy(scales), bits=8,
                                      k_orig=70)
    assert got.shape == (2, 3, 11)
    assert qmatmul_f32_blockscale.launches == before      # no kernel
    expect = ref.qmatmul_f32_blockscale(torch.from_numpy(x.reshape(6, 70)),
                                        torch.from_numpy(packed),
                                        torch.from_numpy(scales), bits=8,
                                        k_orig=70)
    assert torch.equal(got.reshape(6, 11), expect)


def test_wrapper_refuses_mixed_devices(rng):
    """A CPU weight beside a tensor on another device raises: nothing falls
    back to the plain version (on the card, a host template leaf)."""
    packed, scales = _wire(rng, 5, 64, 8)
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        qmatmul_f32_blockscale(x, torch.from_numpy(packed),
                               torch.from_numpy(scales), bits=8, k_orig=64)


@pytest.mark.parametrize("page_bits,weight_bits,wired", [
    (8, 4, True), (8, 8, False), (4, 8, False), (None, 4, False)])
def test_linear_dispatches_wire_served_params(rng, page_bits, weight_bits,
                                              wired):
    """``linear`` sends a param to the blockscale path exactly when the
    placement predicate says it is wire-served, and agrees with the JAX
    ``linear`` (mode xla) on it."""
    k, n = 64, 12
    x = rng.normal(size=(2, 5, k)).astype(np.float32)
    path = "layers/attn/wq"
    cold = dict(scenario="l1mram", weight_bits=weight_bits,
                residency="paged", page_bits=page_bits)
    plan = PlacementPlan(default=Placement(**cold), wire_serve=True)
    jplan = JPlan(default=JPlacement(**cold), wire_serve=True)
    if wired:
        packed, scales = _wire(rng, n, k, page_bits)
    else:
        w = rng.normal(size=(n, k)).astype(np.float32)
        qt = jquantize.quantize_weights(w, weight_bits)
        packed = np.array(jpacking.pack(qt.values, weight_bits))
        scales = np.array(qt.scale)
    w_t = dict(packed=torch.from_numpy(packed),
               scale=torch.from_numpy(scales))
    w_j = dict(packed=jnp.asarray(packed), scale=jnp.asarray(scales))
    got = layers.linear(torch.from_numpy(x), w_t, engine=plan, path=path)
    expect = jlayers.linear(jnp.asarray(x), w_j, engine=jplan, path=path)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    if wired:
        want = ops.quant_matmul_blockscale(torch.from_numpy(x),
                                           w_t["packed"], w_t["scale"],
                                           bits=8, k_orig=k)
        assert torch.equal(got, want)
