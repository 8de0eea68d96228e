"""Port parity: ``core/engine.py`` (``EngineConfig``, ``DSP``, ``NEUREKA``,
``linear``), ``core/scenarios.py`` (``plan_apply``, ``weight_path_bytes``),
``placement.as_plan`` / ``linear_dispatch`` on an ``EngineConfig``, and
``examples/quickstart_torch.py --device cpu``.  The JAX side runs
``mode="xla"``; the same numpy weights are packed by both packages."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import scenarios as jscenarios  # noqa: E402
from repro.core.weight_store import pack_param as jpack  # noqa: E402

from repro_torch.core import engine, placement, scenarios  # noqa: E402
from repro_torch.core.weight_store import PackedParam  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)          # tests/test_placement.py:200


def _param(jp):
    """The JAX PackedParam's bytes as the port's."""
    return PackedParam(packed=torch.from_numpy(np.array(jp.packed)),
                       scale=torch.from_numpy(np.array(jp.scale)),
                       bits=jp.bits, orig_shape=tuple(jp.orig_shape))


def _plans():
    port = (placement.PlacementPlan.uniform("l1mram")
            .with_rule("cold/*", placement.Placement("l3mram")))
    ref = (jplacement.PlacementPlan.uniform("l1mram")
           .with_rule("cold/*", jplacement.Placement("l3mram")))
    return port, ref


def test_engine_config_fields_and_scenarios_equal_jax():
    plan, jplan = _plans()
    cfg = engine.EngineConfig.from_plan(plan)
    jcfg = jengine.EngineConfig.from_plan(jplan)
    assert cfg.plan is plan and cfg.mode == "xla"
    for f in ("engine", "scenario", "mode", "weight_bits"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    for path in ("cold/w", "hot/w", None):
        assert cfg.scenario_for(path) == jcfg.scenario_for(path)
    assert cfg.scenario_for("cold/w") == "l3mram"
    for ours, ref in ((engine.DSP, jengine.DSP),
                      (engine.NEUREKA, jengine.NEUREKA)):
        assert (ours.engine, ours.scenario, ours.weight_bits, ours.plan) == \
            (ref.engine, ref.scenario, ref.weight_bits, ref.plan)
    assert cfg.replace(scenario="l2mram").scenario == "l2mram"


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_linear_and_plan_apply_match_jax(rng, bits):
    """``tests/test_placement.py:185-200`` on both packages: the typed front
    end and ``plan_apply`` resolve each path's scenario as ``linear``
    does, and give JAX's numbers."""
    x = rng.normal(size=(3, 32)).astype(np.float32)
    jp = jpack(jnp.asarray(rng.normal(size=(16, 32)), jnp.float32), bits)
    p = _param(jp)
    plan, jplan = _plans()
    cfg = engine.EngineConfig.from_plan(plan)
    jcfg = jengine.EngineConfig.from_plan(jplan)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ref = np.asarray(jscenarios.linear_apply(xj, jp, scenario="l1mram"))
    for path in ("hot/w", "cold/w"):
        got = engine.linear(xt, p, cfg, path=path).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jengine.linear(xj, jp, jcfg, path=path)), **TOL)
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(
            scenarios.plan_apply(xt, p, plan, path).numpy(),
            np.asarray(jscenarios.plan_apply(xj, jp, jplan, path)), **TOL)
    out = engine.linear(xt, p, cfg, path="cold/w", out_dtype=torch.float64)
    assert out.dtype == torch.float64


def test_dense_linear_and_the_neureka_refusal(rng):
    x = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    np.testing.assert_allclose(engine.linear(x, w, engine.DSP).numpy(),
                               (x @ w.T).numpy())
    with pytest.raises(TypeError, match="packed weights"):
        engine.linear(x, w, engine.NEUREKA)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_weight_path_bytes_equal_jax(bits):
    jp = jpack(jnp.ones((16, 32), jnp.float32), bits)
    p = _param(jp)
    for sc in placement.SCENARIOS:
        b = scenarios.weight_path_bytes(p, sc)
        assert type(b) is int
        assert b == jscenarios.weight_path_bytes(jp, sc)
    with pytest.raises(ValueError):
        scenarios.weight_path_bytes(p, "l4")


def test_as_plan_and_linear_dispatch_take_an_engine_config():
    """An EngineConfig with a plan gives that plan; one without gives the
    uniform plan of its scenario and bits; the dispatch answers per path,
    as the reference's ``as_plan`` does."""
    plan, jplan = _plans()
    cfg = engine.EngineConfig.from_plan(plan)
    assert placement.as_plan(cfg) is plan
    bare = engine.EngineConfig(engine="neureka", scenario="l2mram",
                               weight_bits=4)
    jbare = jengine.EngineConfig(engine="neureka", scenario="l2mram",
                                 weight_bits=4)
    got, ref = placement.as_plan(bare), jplacement.as_plan(jbare)
    assert (got.default.scenario, got.default.weight_bits, got.rules) == \
        (ref.default.scenario, ref.default.weight_bits, ref.rules)
    for path in ("cold/w", "hot/w", None):
        assert placement.linear_dispatch(cfg, path) == \
            jplacement.linear_dispatch(jengine.EngineConfig.from_plan(jplan),
                                       path)
    assert placement.linear_dispatch(bare, "x") == ("l2mram", "xla", 4)
    with pytest.raises(TypeError):
        placement.as_plan(object())


def test_quickstart_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "quickstart_torch.py"),
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "quickstart OK"
    assert any("served 6 requests (48 tokens)" in ln for ln in lines)
    assert any("drift: 0.00e+00" in ln for ln in lines)
