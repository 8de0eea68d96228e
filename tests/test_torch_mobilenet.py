"""Port parity: int8 MobileNet-V2 on the N-EUREKA path
(``repro_torch.models.mobilenet_v2``) and its analytical model
(``core.memsys``, ``core.perf_model``, ``core.placement.plan_for_budget``)
against the reference package.

The job list, the scenario tables and the budget plans are equal.
``freeze_packed`` on the same float weights gives equal packed bytes and
biases, and ``mult`` within 1e-6 relative (the f32 rms sums in another
order).  ``apply`` on a JAX-frozen tree carried across equals the
reference's ``mode="xla"`` output bit for bit.

The reference freezes eagerly, once, at 8 bits (~30 s on one CPU core: one
compile per primitive and shape); a jitted freeze would be quicker but is
not the reference's arithmetic: inside ``jit`` XLA turns the quantizer's
``absmax / qmax`` into a multiply by the reciprocal (here one fc level in
1.28 M differs).  The reference's
``apply`` is jitted, which agrees with its eager form bit for bit.  Bits 4
and 2 are held at the operator level (``test_torch_neureka.py``)."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import memsys as jmemsys  # noqa: E402
from repro.core import perf_model as jperf  # noqa: E402
from repro.models import mobilenet_v2 as jmnv2  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import memsys, perf_model  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.models import mobilenet_v2 as mnv2  # noqa: E402

# 96 -> a 3 x 3 last map, so the average pool divides by 9
IMG = 96


@pytest.fixture(scope="module")
def float_weights():
    """One float weight tree from a numpy seed, handed to both packages."""
    rng = np.random.default_rng(0)
    params = {}
    for job in jperf.mobilenet_v2_jobs(8, IMG):
        shape = mnv2._weight_shape(job)
        w = rng.normal(size=shape) * float(np.prod(shape[1:])) ** -0.5
        params[job.name] = dict(w=w.astype(np.float32),
                                bias=rng.normal(scale=3.0, size=shape[0])
                                .astype(np.float32))
    return params


@pytest.fixture(scope="module")
def jax_frozen(float_weights):
    """The reference's 8-bit frozen tree of ``float_weights``, as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jmnv2.freeze_packed(float_weights, weight_bits=8,
                                        img=IMG))


def _jobs_tuple(jobs):
    return [dataclasses.astuple(j) for j in jobs]


@pytest.mark.parametrize("bits,img", [(8, 224), (4, 96), (2, 32)])
def test_job_list_equals_reference(bits, img):
    jobs = perf_model.mobilenet_v2_jobs(bits, img)
    assert _jobs_tuple(jobs) == _jobs_tuple(jperf.mobilenet_v2_jobs(bits, img))
    assert _jobs_tuple(mnv2.job_list(bits, img)) == _jobs_tuple(jobs)
    assert [j.macs for j in jobs] == [j.macs for j in
                                      jperf.mobilenet_v2_jobs(bits, img)]
    kinds = [j.op_kind for j in jobs]
    assert (kinds.count("dense3x3"), kinds.count("dw3x3"),
            kinds.count("pw1x1")) == (1, 17, 35)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("point", ["NOMINAL", "LOW_POWER"])
def test_scenario_table_equals_reference(bits, point):
    got = perf_model.mnv2_scenario_table(getattr(memsys, point), bits)
    expect = jperf.mnv2_scenario_table(getattr(jmemsys, point), bits)
    assert list(got) == list(expect) == list(memsys.SCENARIOS)
    for s in got:
        lat, energy, timings = got[s]
        assert (lat, energy) == expect[s][:2]
        assert ([dataclasses.astuple(t) for t in timings]
                == [dataclasses.astuple(t) for t in expect[s][2]])
    assert perf_model.mnv2_total_macs() == jperf.mnv2_total_macs()
    assert (perf_model.mnv2_weight_bytes(bits)
            == jperf.mnv2_weight_bytes(bits))


def _plan_tuple(plan):
    def pl(p):
        return (p.scenario, p.weight_bits, p.residency, p.page_bits)
    return (pl(plan.default), [(n, pl(p)) for n, p in plan.rules])


@pytest.mark.parametrize("budget", [256 * 1024, 2 * 1024 * 1024,
                                    4 * 1024 * 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_budget_plan_equals_reference(budget, bits):
    plan = perf_model.mnv2_budget_plan(budget, bits)
    expect = jperf.mnv2_budget_plan(budget, bits)
    assert _plan_tuple(plan) == _plan_tuple(expect)
    lat, energy, timings = perf_model.mnv2_plan_walk(plan, weight_bits=bits)
    jlat, jenergy, jtimings = jperf.mnv2_plan_walk(expect, weight_bits=bits)
    assert (lat, energy) == (jlat, jenergy)
    assert [t.regime for t in timings] == [t.regime for t in jtimings]


def test_budget_plan_options_equal_reference():
    from repro.core import placement as jplacement
    from repro_torch.core import placement

    sizes = {j.name: j.weight_bytes for j in jperf.mobilenet_v2_jobs(4)}
    got = placement.plan_for_budget(
        sizes, 1024 * 1024, hot=Placement("l1mram", 4, "resident"),
        cold=Placement("l3mram", 8, "paged", page_bits=2), sizes_bits=4)
    expect = jplacement.plan_for_budget(
        sizes, 1024 * 1024, hot=jplacement.Placement("l1mram", 4, "resident"),
        cold=jplacement.Placement("l3mram", 8, "paged", page_bits=2),
        sizes_bits=4)
    assert _plan_tuple(got) == _plan_tuple(expect)
    assert _plan_tuple(placement.plan_for_budget(sizes)) == _plan_tuple(
        jplacement.plan_for_budget(sizes))


def test_memsys_model_equals_reference():
    for kind in ("dense3x3", "dw3x3", "pw1x1"):
        for bits in (2, 4, 8):
            for op in ("NOMINAL", "LOW_POWER"):
                assert memsys.neureka_gops(kind, bits, getattr(memsys, op)) \
                    == jmemsys.neureka_gops(kind, bits, getattr(jmemsys, op))
    for a, b in zip(memsys.TABLE_I, jmemsys.TABLE_I):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert ({k: dataclasses.astuple(v)
                 for k, v in memsys.scenario_costs(a).items()}
                == {k: dataclasses.astuple(v)
                    for k, v in jmemsys.scenario_costs(b).items()})
    for swap, compute in ((0.0, 1.0), (2e-3, 1e-3), (1e-3, 5e-3), (-1, 2)):
        assert (memsys.overlap_stall(swap, compute)
                == jmemsys.overlap_stall(swap, compute))
    jobs = perf_model.mobilenet_v2_jobs(4)
    mixed = [memsys.SCENARIOS[i % 4] for i in range(len(jobs))]
    got = memsys.network_walk(jobs, mixed, memsys.LOW_POWER)
    expect = jmemsys.network_walk(jperf.mobilenet_v2_jobs(4), mixed,
                                  jmemsys.LOW_POWER)
    assert got[:2] == expect[:2]
    with pytest.raises(ValueError):
        memsys.network_walk(jobs, mixed[:-1])


def test_freeze_packed_matches_reference(float_weights, jax_frozen):
    expect = jax_frozen
    got = mnv2.freeze_packed(interop.mobilenet_from_numpy(float_weights,
                                                          device="cpu"),
                             weight_bits=8, img=IMG)
    assert sorted(got) == sorted(expect)
    for name, leaf in got.items():
        np.testing.assert_array_equal(leaf["packed"].numpy(),
                                      expect[name]["packed"])
        np.testing.assert_array_equal(leaf["bias"].numpy(),
                                      expect[name]["bias"])
        assert leaf["mult"].dtype == torch.float32
        np.testing.assert_allclose(leaf["mult"].numpy(),
                                   expect[name]["mult"], rtol=1e-6, atol=0)


def test_apply_matches_reference_bit_for_bit(jax_frozen):
    frozen = jax_frozen
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    japply = jax.jit(functools.partial(jmnv2.apply, weight_bits=8,
                                       mode="xla", img=IMG))
    tree = interop.mobilenet_from_numpy(frozen, device="cpu")
    for img in images:
        expect = np.asarray(japply(frozen, jnp.asarray(img)))
        got = mnv2.apply(tree, torch.from_numpy(img), weight_bits=8, img=IMG)
        assert got.dtype == torch.uint8 and got.shape == (1000,)
        np.testing.assert_array_equal(got.numpy(), expect)
        assert int(expect.max()) > int(expect.min())     # not collapsed


@pytest.mark.parametrize("hw", [(7, 7), (3, 3), (5, 2)])
def test_avg_pool_equals_reference_mean(rng, hw):
    h, w = hw
    # exact multiples of H*W (every column constant) are where a pool that
    # multiplies by a rounded reciprocal truncates one too low
    flat = np.concatenate([np.full((h, w, 256), np.arange(256)),
                           rng.integers(0, 256, (h, w, 512))], axis=-1)
    x = flat.astype(np.uint8)
    expect = jnp.mean(jnp.asarray(x).astype(jnp.float32), axis=(0, 1),
                      keepdims=True).astype(jnp.uint8)
    got = mnv2.avg_pool(torch.from_numpy(x))
    assert got.shape == (1, 1, 768)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("bits", [8, 2])
def test_own_weights_run_end_to_end(bits):
    params = mnv2.init_params(torch.Generator().manual_seed(0),
                              weight_bits=bits, img=32, device="cpu")
    assert all(leaf["w"].dtype == torch.float32 for leaf in params.values())
    frozen = mnv2.freeze_packed(params, weight_bits=bits, img=32)
    image = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (32, 32, 3)).astype(np.uint8))
    logits = mnv2.apply(frozen, image, weight_bits=bits, img=32)
    assert logits.shape == (1000,) and logits.dtype == torch.uint8
    assert int(logits.max()) > int(logits.min())
    again = mnv2.apply(mnv2.freeze_packed(mnv2.init_params(
        torch.Generator().manual_seed(0), weight_bits=bits, img=32,
        device="cpu"), weight_bits=bits, img=32), image, weight_bits=bits,
        img=32)
    assert torch.equal(logits, again)


def test_interop_checks_the_tree(float_weights):
    tree = interop.mobilenet_from_numpy(float_weights, device="cpu")
    assert set(tree["conv0"]) == {"w", "bias"}
    assert tree["conv0"]["w"].shape == (32, 3, 3, 3)
    missing = {k: v for k, v in float_weights.items() if k != "fc"}
    with pytest.raises(ValueError, match="MobileNet-V2 tree"):
        interop.mobilenet_from_numpy(missing, device="cpu")
    mixed = dict(float_weights, fc=dict(packed=np.zeros((1000, 1280),
                                                        np.uint8)))
    with pytest.raises(ValueError, match="job entries"):
        interop.mobilenet_from_numpy(mixed, device="cpu")
    image = torch.zeros((IMG, IMG, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="weights on cpu"):
        mnv2.apply(mnv2.freeze_packed(tree, img=IMG), image, img=IMG)
