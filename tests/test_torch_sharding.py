"""Port parity: the sharding rules (``repro_torch.parallel.sharding``), the
``meta`` spec trees of ``repro_torch.launch.steps`` and ``shard_factors`` of
``core/placement``, against the JAX package.

``_param_pspec``, ``shard_axis`` and ``batch_pspec`` read only a mesh's
``shape`` and ``axis_names``: both packages' are called in process on one
stand-in mesh.  ``param_shardings``, ``opt_state_shardings`` and
``cache_shardings`` build ``NamedSharding`` s, which need as many devices
as the mesh: the JAX side runs once, in one module-scoped subprocess with 8
forced host devices, and dumps every spec and every leaf shape as JSON.
All ten archs at full width (shapes only), on the meshes (1, 1), (1, 4),
(2, 2), (2, 4) and (4, 2)."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import placement as jplacement  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import placement, tree as T  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 1), (1, 4), (2, 2), (2, 4), (4, 2))
AXES = ("data", "model")
CACHE_BATCHES = (8, 6)           # divisible by every dp size, and not
CACHE_LEN = 64


class StandIn:
    """The two attributes of a mesh that the JAX rules read."""

    def __init__(self, shape, axes=AXES):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _norm(spec):
    """A partition spec as JSON: per dim None, an axis or a list of axes;
    a one-axis tuple is its axis, as ``NamedSharding.spec`` gives it."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple)
            else e for e in spec]


def _flat_specs(tree, specs):
    """[(path, spec)] of a spec tree laid over its tensor tree (a spec is
    a tuple, which the tree walk would take apart)."""
    flat = []

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, (tt, ss) in enumerate(zip(t, s)):
                walk(tt, ss, path + (str(i),))
        else:
            flat.append(("/".join(path), _norm(s)))

    walk(tree, specs, ())
    return flat


def _trees(arch):
    """The port's meta trees of ``arch`` at full width."""
    cfg = get_config(arch)
    dense = steps.param_specs(cfg)
    return dict(dense=dense, packed=steps.serve_param_specs(cfg, 8),
                adamw=adamw().init(dense), adafactor=adafactor().init(dense),
                **{f"cache{b}": steps.cache_specs(cfg, b, CACHE_LEN)
                   for b in CACHE_BATCHES})


_DUMP = """
    import json, sys
    import jax
    from repro.configs import ARCHS
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import cache_specs, param_specs, serve_param_specs
    from repro.optim import adafactor, adamw
    from repro.parallel import sharding as shd

    def norm(spec):
        return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple)
                else e for e in spec]

    def keyed(tree, shards=None):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path) for path, _ in flat]
        if shards is None:
            return [[k, list(leaf.shape), str(leaf.dtype)]
                    for k, (_, leaf) in zip(keys, flat)]
        return [[k, norm(s.spec)]
                for k, s in zip(keys, jax.tree_util.tree_leaves(shards))]

    meshes = {MESHES}
    out = {{}}
    for name, cfg in ARCHS.items():
        dense = param_specs(cfg)
        trees = dict(dense=dense, packed=serve_param_specs(cfg, 8),
                     adamw=jax.eval_shape(adamw().init, dense),
                     adafactor=jax.eval_shape(adafactor().init, dense))
        for b in {BATCHES}:
            trees[f"cache{{b}}"] = cache_specs(cfg, b, {LEN})
        doc = dict(shapes={{k: keyed(t) for k, t in trees.items()}})
        for shape in meshes:
            mesh = make_test_mesh(shape, ("data", "model"))
            specs = dict(
                dense=keyed(dense, shd.param_shardings(dense, mesh)),
                packed=keyed(trees["packed"],
                             shd.param_shardings(trees["packed"], mesh)))
            for opt in ("adamw", "adafactor"):
                specs[opt] = keyed(trees[opt], shd.opt_state_shardings(
                    trees[opt], mesh, dense))
            for b in {BATCHES}:
                c = trees[f"cache{{b}}"]
                specs[f"cache{{b}}"] = keyed(
                    c, shd.cache_shardings(c, mesh, b))
            doc["x".join(map(str, shape))] = specs
        out[name] = doc
    json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def jax_specs():
    """Every spec the JAX package's NamedSharding functions give, and every
    leaf shape of its spec trees, from one subprocess of 8 host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_DUMP).format(MESHES=list(MESHES),
                                         BATCHES=CACHE_BATCHES,
                                         LEN=CACHE_LEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_spec_trees_match_the_reference_shapes(jax_specs, arch):
    """The port's meta trees have JAX's paths, shapes and dtypes leaf for
    leaf, and allocate nothing."""
    for kind, tree in _trees(arch).items():
        got = [["/".join(p), list(leaf.shape),
                str(leaf.dtype).replace("torch.", "")]
               for p, leaf in T.flatten_with_paths(tree)]
        assert got == jax_specs[arch]["shapes"][kind], (arch, kind)
        assert all(leaf.device.type == "meta" for leaf in T.leaves(tree))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tree_shardings_equal_the_reference(jax_specs, arch):
    """param_shardings (dense and packed), opt_state_shardings (AdamW and
    Adafactor) and cache_shardings (a batch each dp size divides, and one
    it does not) equal JAX's NamedSharding specs on the five meshes."""
    trees = _trees(arch)
    for shape in MESHES:
        mesh = tmesh.make_test_mesh(shape, AXES, device="cpu")
        want = jax_specs[arch]["x".join(map(str, shape))]
        got = {kind: _flat_specs(trees[kind], shd.param_shardings(
            trees[kind], mesh)) for kind in ("dense", "packed")}
        for opt in ("adamw", "adafactor"):
            got[opt] = _flat_specs(trees[opt], shd.opt_state_shardings(
                trees[opt], mesh, trees["dense"]))
        for b in CACHE_BATCHES:
            c = trees[f"cache{b}"]
            got[f"cache{b}"] = _flat_specs(c, shd.cache_shardings(c, mesh, b))
        for kind, specs in got.items():
            assert [list(x) for x in specs] == want[kind], (arch, shape,
                                                             kind)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_leaf_rules_equal_the_reference_in_process(arch):
    """_param_pspec and shard_axis at every leaf of the dense and packed
    trees, and batch_pspec, against JAX's on one stand-in mesh."""
    trees = _trees(arch)
    for shape in MESHES:
        jm = StandIn(shape)
        tm = tmesh.make_test_mesh(shape, AXES, device="cpu")
        for kind in ("dense", "packed"):
            for path, leaf in T.flatten_with_paths(trees[kind]):
                shp = tuple(leaf.shape)
                assert _norm(shd._param_pspec(path, shp, tm)) == _norm(
                    jshd._param_pspec(path, shp, jm)), (arch, path, shape)
                assert shd.shard_axis(path, shp, tm) == jshd.shard_axis(
                    path, shp, jm), (arch, path, shape)
        for batch in (1, 2, 6, 8):
            for extra in (0, 1, 2):
                assert _norm(shd.batch_pspec(batch, tm, extra)) == _norm(
                    jshd.batch_pspec(batch, jm, extra))
        assert shd.dp_axes(tm) == jshd.dp_axes(jm)
        assert shd.dp_size(tm) == jshd.dp_size(jm)
    pod = ("pod", "data", "model")
    for shape in ((2, 2, 2), (2, 1, 4)):
        jm, tm = StandIn(shape, pod), tmesh.make_test_mesh(shape, pod, "cpu")
        assert shd.dp_axes(tm) == jshd.dp_axes(jm) == ("pod", "data")
        for batch in (2, 4, 6):
            assert _norm(shd.batch_pspec(batch, tm)) == _norm(
                jshd.batch_pspec(batch, jm))


def test_opt_state_shardings_keyed_by_path_not_shape():
    """Two same-shape params with different specs keep their own specs
    through the optimizer-state mirror (``tests/test_multidevice.py:
    223-242``)."""
    mesh = tmesh.make_test_mesh((1, 1), AXES, device="cpu")
    params = dict(conv_w=torch.zeros((8, 8)), wq=torch.zeros((8, 8)))
    assert (shd._param_pspec(("conv_w",), (8, 8), mesh)
            != shd._param_pspec(("wq",), (8, 8), mesh))
    out = shd.opt_state_shardings(dict(mu=params, nu=params), mesh, params)
    for moment in ("mu", "nu"):
        assert out[moment]["conv_w"] == shd.P("model", None)
        assert out[moment]["wq"] == shd.P("model", "data")


def test_make_test_mesh_never_clamps():
    """The reference clamps a mesh to ``jax.device_count()``; the port
    builds the shape asked for, every link on the one device."""
    mesh = tmesh.make_test_mesh((4, 8), AXES, device="cpu")
    assert mesh.shape == {"data": 4, "model": 8}
    assert mesh.devices.shape == (4, 8)
    assert [link.index for link in mesh.links] == list(range(32))
    assert {link.device for link in mesh.links} == {torch.device("cpu")}
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_test_mesh((0, 2), AXES, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_test_mesh((1, 2))


def test_plan_for_budget_charges_sharded_params_per_device():
    """``tests/test_multidevice.py:258-276``, and the port's plans equal
    JAX's under shard_factors."""
    sizes = {"a": 1000, "b": 1000}
    kw = [dict(hot=m.Placement("l1mram", 8, "resident"),
               cold=m.Placement("l3flash", 8, "paged"))
          for m in (placement, jplacement)]
    flat = placement.plan_for_budget(sizes, 500, **kw[0])
    assert flat.placement_for("a").residency == "paged"
    assert flat.placement_for("b").residency == "paged"
    plan = placement.plan_for_budget(sizes, 500, shard_factors={"a": 4},
                                     **kw[0])
    assert plan.placement_for("a").residency == "resident"  # 250 B a link
    assert plan.placement_for("b").residency == "paged"     # 1000 > 250

    def rules(p):
        return [(n, (pl.scenario, pl.weight_bits, pl.residency))
                for n, pl in p.rules]

    many = {f"l{i}": 1000 + 137 * i for i in range(8)}
    for factors in ({"l0": 4, "l3": 2}, {n: 4 for n in many},
                    {"l7": 3, "x": 2}):
        for budget in (0, 600, 2_500, 10_000):
            for bits in (8, 4):
                hot = [m.Placement("l1mram", bits, "resident")
                       for m in (placement, jplacement)]
                assert rules(placement.plan_for_budget(
                    many, budget, hot=hot[0], sizes_bits=8,
                    shard_factors=factors)) == rules(
                    jplacement.plan_for_budget(
                        many, budget, hot=hot[1], sizes_bits=8,
                        shard_factors=factors)), (factors, budget, bits)


def test_packed_sizes_shard_factors_divide():
    """``tests/test_multidevice.py:279-287``, against JAX's sizes."""
    import numpy as np
    tree = {"wq": {"packed": np.zeros((8, 16), np.uint8),
                   "scale": np.zeros((8, 1), np.float32)},
            "wk": {"packed": np.zeros((6, 5), np.uint8),
                   "scale": np.zeros((6,), np.float32)}}
    ttree = T.tree_map(torch.from_numpy, tree)
    whole = placement.packed_sizes(ttree)
    assert whole == jplacement.packed_sizes(tree)
    assert whole["wq"] == 128
    for factors in ({"wq": 4}, {"wq": 3, "wk": 4}, {"wk": 1, "zz": 2}):
        per = placement.packed_sizes(ttree, shard_factors=factors)
        assert per == jplacement.packed_sizes(tree, shard_factors=factors)
    assert placement.packed_sizes(ttree, {"wq": 4})["wq"] == -(-128 // 4)
