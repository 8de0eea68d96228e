"""Port parity: packing, weight quantization and serving-tree freezing
(``repro_torch.core`` / ``repro_torch.parallel.sharding`` against ``repro``).
Integer carriers and f32 scales must be byte-identical."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import packing as jpacking, quantize as jquantize  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro.core.placement import PlacementPlan as JPlan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import packing, quantize  # noqa: E402
from repro_torch.core.placement import Placement, PlacementPlan  # noqa: E402
from repro_torch.core.weight_store import PackedParam  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402

BITS = (2, 4, 8)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(5, 64), (3, 37), (2, 1), (4, 130),
                                   (2, 3, 33)])
def test_pack_unpack_byte_identical(rng, bits, shape):
    qmin, qmax = jquantize.weight_qrange(bits)
    levels = rng.integers(qmin, qmax + 1, shape).astype(np.int8)
    expect = np.asarray(jpacking.pack(jnp.asarray(levels), bits))
    got = packing.pack(torch.from_numpy(levels), bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), expect)
    assert got.shape[-1] == packing.packed_last_dim(shape[-1], bits)
    back = packing.unpack(got, bits, shape[-1])
    np.testing.assert_array_equal(back.numpy(), levels)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(16, 64), (7, 33), (3, 4, 10)])
def test_quantize_weights_bit_identical(rng, bits, shape):
    w = rng.normal(size=shape).astype(np.float32)
    w[0] = 0.0                               # an all-zero channel: scale 1
    jq = jquantize.quantize_weights(jnp.asarray(w), bits)
    tq = quantize.quantize_weights(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.scale[0].item() == 1.0
    assert quantize.weight_qrange(bits) == jquantize.weight_qrange(bits)


@pytest.mark.parametrize("bits", BITS)
def test_prep_linear_and_packed_param(rng, bits):
    w = rng.normal(size=(24, 37)).astype(np.float32)
    jp, js = jops.prep_linear(jnp.asarray(w), bits)
    tp, ts = ops.prep_linear(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    p = PackedParam(packed=tp, scale=ts, bits=bits, orig_shape=(24, 37))
    deq = jquantize.quantize_weights(jnp.asarray(w), bits).dequantize()
    np.testing.assert_array_equal(p.dequantize().numpy(), np.asarray(deq))


def _smoke_params():
    cfg = get_config("qwen3-0.6b").smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _assert_trees_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


@pytest.mark.parametrize("bits", BITS)
def test_freeze_for_serving_byte_identical(bits):
    cfg, params, np_params = _smoke_params()
    tparams = interop.params_from_numpy(np_params, tget(cfg.name).smoke(),
                                        device="cpu")
    expect = jax.tree_util.tree_map(np.asarray, jfreeze(params, bits=bits))
    got = freeze_for_serving(tparams, bits=bits, device="cpu")
    _assert_trees_equal(expect, got)
    # d_model = 64 rows of K = 64 (wq) and K = d_ff = 128 (w_down) pack
    # to K / f bytes
    assert got["layers"]["mlp"]["w_down"]["packed"].shape[-1] == 128 // (8 // bits)


def test_freeze_for_serving_follows_plan():
    cfg, params, np_params = _smoke_params()
    tparams = interop.params_from_numpy(np_params, tget(cfg.name).smoke(),
                                        device="cpu")
    jplan = JPlan().with_rule("mlp/*", JPlacement("l1mram", 4))
    tplan = PlacementPlan().with_rule("mlp/*", Placement("l1mram", 4))
    expect = jax.tree_util.tree_map(np.asarray, jfreeze(params, plan=jplan))
    got = freeze_for_serving(tparams, plan=tplan, device="cpu")
    _assert_trees_equal(expect, got)
    assert got["layers"]["mlp"]["w_up"]["packed"].shape[-1] == 64 // 2
