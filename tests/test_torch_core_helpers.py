"""Port parity: the numeric core's capacity, bit-plane, activation-quant and
accounting helpers (``core/packing``, ``core/quantize``, ``core/memsys``,
``core/weight_store``, ``core/placement``) against the reference package.

Integers (byte counts, MRAM rows, planes, levels, int32 sums, uint8
activations, zero points) must be equal.  Floats: the analytical rates are
the same Python arithmetic and must be equal, and so must the activation
scale (both packages' percentiles interpolate linearly between the two
nearest order statistics, the port in the f32 steps of the reference's
jitted ``jnp.percentile``); the dequant
matmul at the reference fake-quant test's rtol 1e-5 / atol 1e-6."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import memsys as jmemsys  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402

from repro_torch.core import memsys, packing, placement, quantize  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402

SHAPES = [(7,), (3, 5), (4, 33), (2, 3, 130), (1, 1), (64, 256)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_capacity_counts_equal_reference(shape, bits):
    assert packing.packed_nbytes(shape, bits) == jpacking.packed_nbytes(
        shape, bits)
    assert packing.mram_rows(shape, bits) == jpacking.mram_rows(shape, bits)
    assert packing.MRAM_ROW_BITS == jpacking.MRAM_ROW_BITS
    # the count is the carrier's: what pack() really allocates
    levels = torch.zeros(shape, dtype=torch.int8)
    assert packing.pack(levels, bits).numel() == packing.packed_nbytes(
        shape, bits)


def _levels(rng, shape, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    return rng.integers(lo, hi, shape).astype(np.int8)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(9,), (4, 17), (2, 3, 8)])
def test_bitplanes_equal_reference_and_round_trip(shape, bits):
    lv = _levels(np.random.default_rng(bits), shape, bits)
    planes = packing.to_bitplanes(torch.from_numpy(lv), bits)
    expect = np.asarray(jpacking.to_bitplanes(jnp.asarray(lv), bits))
    assert planes.dtype == torch.uint8
    assert planes.shape == (bits,) + shape
    np.testing.assert_array_equal(planes.numpy(), expect)
    assert set(np.unique(planes.numpy())) <= {0, 1}
    back = packing.from_bitplanes(planes, bits)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), lv)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jpacking.from_bitplanes(jnp.asarray(expect), bits)))


@pytest.mark.parametrize("n", [1000, 7, 1771])
@pytest.mark.parametrize("percentile", [100.0, 99.9, 99.0, 90.0, 50.0])
def test_activation_quant_equals_reference(percentile, n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * 3 + 2).astype(np.float32)
    scale, zp = quantize.calibrate_activation_scale(torch.from_numpy(x),
                                                    percentile)
    jscale, jzp = jquantize.calibrate_activation_scale(jnp.asarray(x),
                                                       percentile)
    assert scale.dtype == torch.float32 and zp.dtype == torch.int32
    assert float(scale) == float(jscale)
    assert int(zp) == int(jzp)
    # the same scale and zero point quantize to the same uint8 codes: the
    # port divides by a tensor, an f32 division like the reference's
    q = quantize.quantize_activations(torch.from_numpy(x),
                                      torch.tensor(float(jscale)), int(jzp))
    jq = jquantize.quantize_activations(jnp.asarray(x), jscale, jzp)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # the reference test's bound: reconstruction within one step
    deq = (q.to(torch.float32) - zp) * scale
    lo, hi = (0 - zp) * scale, (255 - zp) * scale
    err = (deq - torch.clamp(torch.from_numpy(x), float(lo), float(hi)))
    assert float(err.abs().max()) <= float(scale) * 0.51 + 1e-6


def test_quantile_is_linear_interpolation():
    """``torch.quantile``'s default interpolation is ``jnp.percentile``'s
    default ``method="linear"``: between the order statistics at floor and
    ceil of q * (n - 1)."""
    x = np.array([4.0, 1.0, 3.0, 10.0, 2.0], np.float32)
    for q in (0.0, 0.1, 0.37, 0.5, 0.9, 1.0):
        got = float(torch.quantile(torch.from_numpy(x), q))
        want = float(jnp.percentile(jnp.asarray(x), q * 100.0))
        assert got == pytest.approx(want, rel=1e-6)
        assert float(quantize._percentile(torch.from_numpy(x),
                                          q * 100.0)) == want
        s = np.sort(x)
        pos = q * (len(x) - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        assert got == pytest.approx(s[lo] + (s[hi] - s[lo]) * (pos - lo),
                                    rel=1e-6)


def test_quantize_activations_given_scale_and_clip():
    x = np.array([-5.0, -0.26, 0.0, 0.24, 0.25, 0.75, 63.0, 1e4],
                 np.float32)
    for scale, zp in ((0.5, 3), (0.25, 0), (1.0 / 3.0, 128)):
        got = quantize.quantize_activations(torch.from_numpy(x), scale, zp)
        want = jquantize.quantize_activations(
            jnp.asarray(x), jnp.float32(scale), zp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(3, 5, 4), (16, 130, 9), (1, 1024, 3)])
def test_int8_matmul_reference_equals(m, k, n):
    rng = np.random.default_rng(m + k)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = quantize.int8_matmul_reference(torch.from_numpy(xq),
                                         torch.from_numpy(wq))
    want = jquantize.int8_matmul_reference(jnp.asarray(xq), jnp.asarray(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequant_matmul_reference_close(bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(12, 40)).astype(np.float32)
    x = rng.normal(size=(5, 40)).astype(np.float32)
    qt = quantize.quantize_weights(torch.from_numpy(w), bits)
    jqt = jquantize.quantize_weights(jnp.asarray(w), bits)
    assert qt.shape == tuple(jqt.shape)
    np.testing.assert_array_equal(qt.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))
    got = quantize.dequant_matmul_reference(torch.from_numpy(x), qt)
    want = jquantize.dequant_matmul_reference(jnp.asarray(x), jqt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("point", ["NOMINAL", "LOW_POWER", "TABLE_I"])
def test_memsys_rates_equal_reference(point):
    ops = getattr(memsys, point)
    jops = getattr(jmemsys, point)
    for op, jop in zip(ops if isinstance(ops, list) else [ops],
                       jops if isinstance(jops, list) else [jops]):
        assert memsys.l1_neureka_Bps(op) == jmemsys.l1_neureka_Bps(jop)
        assert memsys.l1_total_Bps(op) == jmemsys.l1_total_Bps(jop)
    # the reference test's anchor: 184 Gbit/s of L1 at nominal
    assert memsys.l1_total_Bps(memsys.NOMINAL) * 8 == pytest.approx(
        184e9, rel=0.01)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("op", ["dense3x3", "pw1x1", "dw3x3"])
def test_neureka_ideal_gops_equals_reference(op, bits):
    assert memsys.neureka_ideal_gops(op, bits) == \
        jmemsys.neureka_ideal_gops(op, bits)
    assert memsys.neureka_ideal_gops(op, bits) >= memsys.neureka_gops(
        op, bits)


def _params(rng, n_layers=3, d=64):
    return {f"layer{i}": dict(w=rng.normal(size=(d, d)).astype(np.float32),
                              b=rng.normal(size=(d,)).astype(np.float32))
            for i in range(n_layers)}


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_store_accounting_equals_reference(bits):
    params = _params(np.random.default_rng(bits))
    store = ws.freeze(params, ws.uniform_policy(bits, min_size=16))
    jstore = jws.freeze(params, jws.uniform_policy(bits, min_size=16))
    for attr in ("packed_bytes", "passthrough_bytes",
                 "dense_equivalent_bytes"):
        assert getattr(store, attr) == getattr(jstore, attr), attr
    assert store.density_gain() == jstore.density_gain()
    for budget in (store.packed_bytes - 1, store.packed_bytes,
                   ws.SIRACUSA_MRAM_BYTES):
        assert store.fits(budget) == jstore.fits(budget)
    assert store.fits() == jstore.fits()
    for name, p in store.params.items():
        assert p.nbytes_dense_bf16 == jstore.params[name].nbytes_dense_bf16
    deq = store.dequantized_params()
    jdeq = jstore.dequantized_params()
    assert sorted(deq) == sorted(jdeq)
    for name in deq:
        np.testing.assert_array_equal(np.asarray(deq[name]),
                                      np.asarray(jdeq[name]))
    assert store.density_gain() > 1


def test_dequantized_params_dtype():
    store = ws.freeze(_params(np.random.default_rng(0), 1),
                      ws.uniform_policy(8, min_size=16))
    deq = store.dequantized_params(torch.bfloat16)
    assert deq["layer0/w"].dtype == torch.bfloat16
    assert deq["layer0/b"].dtype == torch.float32       # passthrough


def _plans(pl):
    hot = pl.Placement("l1mram", 8, "resident")
    return [
        pl.PlacementPlan.uniform("l2mram"),
        pl.PlacementPlan.uniform(),
        pl.PlacementPlan.uniform().with_rule("a/*", pl.Placement("l3mram")),
        pl.PlacementPlan(default=pl.Placement("l3flash", 8, "paged"))
        .with_rule("x", hot).with_rule("y", pl.Placement("l2mram")),
        pl.plan_for_budget({"a": 100, "b": 50, "c": 10}, 60),
        pl.plan_for_budget({"a": 100, "b": 50, "c": 10}, 1000),
    ]


def test_plan_uniform_and_scenarios_equal_reference():
    got = [(p.is_uniform, p.scenarios_used()) for p in _plans(placement)]
    want = [(p.is_uniform, p.scenarios_used()) for p in _plans(jplacement)]
    assert got == want
    assert got[0] == (True, ("l2mram",))
    assert got[3] == (False, ("l3flash", "l2mram", "l1mram"))
