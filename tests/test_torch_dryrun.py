"""Port parity: the dry-run tooling (``repro_torch.launch.dryrun``,
``hlo_analysis``, ``report``, ``steps.build_cell`` and its spec trees,
``configs/shapes.py``, ``configs/siracusa_mnv2.py``) against the JAX
package, and the serve kernels' ``meta`` route.

The reference's dry-run imports set ``XLA_FLAGS`` to 512 host devices, so
its spec trees come from two subprocesses (one a production mesh), both
started by the first test that needs them; they run ``eval_shape`` only,
no compile.  The
fake process group of the port's production mesh is process-global, so
every port run that inits one is a subprocess too; the real ``gloo`` ranks
of the (2, 2) comparison are ``run_ranks`` processes."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs import siracusa_mnv2 as jmnv2  # noqa: E402
from repro.launch import report as jreport  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import shapes, siracusa_mnv2  # noqa: E402
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, qmatmul as qmm, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402
from repro_torch.launch import hlo_analysis, report  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4, "uint8": 1}
# the reference's record keys (``repro/launch/dryrun.py:run_cell``)
RECORD_KEYS = {"arch", "shape", "mesh", "multi_pod", "n_chips", "serve_bits",
               "kind", "status", "lower_s", "compile_s", "memory", "cost",
               "collectives", "roofline", "model_flops", "useful_flops_frac",
               "params_total", "params_active", "hlo_n_lines"}
CLI_ARCH = "whisper-tiny"          # every shape counts in ~10 s

_JAX_DUMP = """
    import json, sys
    from repro.launch import dryrun      # sets XLA_FLAGS before jax loads
    import jax
    from repro.configs import ARCHS
    from repro.configs.shapes import SHAPES, applicable
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_cell, serve_input_specs

    mesh = make_production_mesh(multi_pod=sys.argv[1] == "1")

    def norm(spec):
        return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple)
                else e for e in spec]

    def keyed(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return [["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                          for p in path), list(leaf.shape), str(leaf.dtype),
                 norm(leaf.sharding.spec),
                 list(leaf.sharding.shard_shape(leaf.shape))]
                for path, leaf in flat]

    out = {}
    for name, cfg in ARCHS.items():
        for shape, cell in SHAPES.items():
            if not applicable(name, shape):
                continue
            if cell.kind == "train":
                _, (p, o, b), _ = build_cell(cfg, cell, mesh)
                trees = dict(params=p, opt_state=o, batch=b)
            else:
                trees = serve_input_specs(cfg.replace(dtype="bfloat16"), cell,
                                          mesh, bits=8)
            out[name + "/" + shape] = dict(
                model_flops=dryrun.model_flops(cfg, cell),
                trees={k: keyed(v) for k, v in trees.items()})
    json.dump(out, sys.stdout)
"""


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


class _Lazy:
    """A subprocess started now whose JSON stdout is read on first use."""

    def __init__(self, args):
        self.proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=_env(), cwd=REPO)
        self.out = None

    def result(self, timeout=900):
        if self.out is None:
            out, err = self.proc.communicate(timeout=timeout)
            assert self.proc.returncode == 0, err[-4000:]
            self.out = out
        return self.out


@pytest.fixture(scope="module")
def jax_cells():
    """{multi_pod: {"arch/shape": {model_flops, trees}}}, from one JAX
    subprocess a production mesh, both started at once."""
    code = textwrap.dedent(_JAX_DUMP)
    runs = {mp: _Lazy([sys.executable, "-c", code, str(int(mp))])
            for mp in MESHES}
    yield {mp: json.loads(run.result()) for mp, run in runs.items()}


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    """The port's CLI on every shape of CLI_ARCH on both production meshes:
    {cell name: record}."""
    out = tmp_path_factory.mktemp("dryrun")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         CLI_ARCH, "--both-meshes", "--dir", str(out)],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=REPO)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    return {p.stem: json.loads(p.read_text())
            for p in sorted(out.glob("*.json"))}


def _stand_in(multi_pod):
    """The port's Mesh of a production mesh's shape without a process
    group: all that the spec functions read."""
    shape, axes = MESHES[multi_pod]
    return tmesh.Mesh(np.empty(shape, dtype=object), axes)


def _norm(spec):
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple)
            else e for e in spec]


def _keyed(tree, mesh):
    return [["/".join(path), list(leaf.shape),
             str(leaf.dtype).removeprefix("torch."), _norm(leaf.spec),
             list(shd.shard_shape(leaf.shape, leaf.spec, mesh))]
            for path, leaf in T.flatten_with_paths(tree)]


# ---------------------------------------------------------------------------
# (a) the cells
# ---------------------------------------------------------------------------

def test_shapes_and_applicable_equal_the_reference():
    """Tolerance: exact."""
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    for arch in ARCHS:
        for shape in shapes.SHAPES:
            assert shapes.applicable(arch, shape) == \
                jshapes.applicable(arch, shape), (arch, shape)


def test_mnv2_config_equals_the_reference():
    assert dataclasses.asdict(siracusa_mnv2.CONFIG) == \
        dataclasses.asdict(jmnv2.CONFIG)


# ---------------------------------------------------------------------------
# (e) the kernels' meta route
# ---------------------------------------------------------------------------

class _Kernels:
    """Stands in for a cost counter: the kernel calls reported."""

    def __init__(self):
        self.calls = []

    def kernel(self, name, flops, nbytes):
        self.calls.append((name, flops, nbytes))


def _on_meta(*tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            if isinstance(t, torch.Tensor) else t for t in tensors]


def _meta_calls(fn, *args, **kw):
    from repro_torch.kernels import launch
    sink = _Kernels()
    launch.META_COUNTERS.append(sink)
    try:
        out = fn(*_on_meta(*args), **kw)
    finally:
        launch.META_COUNTERS.remove(sink)
    return out, sink.calls


@pytest.mark.parametrize("bits,grouped", [(8, False), (4, False), (2, True),
                                          (8, True)])
def test_qmatmul_meta_route(bits, grouped):
    """The meta output has the plain version's shape and dtype; the stated
    work is 2 E M N K FLOPs and x + packed + scale + out bytes."""
    g = torch.Generator().manual_seed(0)
    e, m, n, k = 3, 5, 24, 70
    kp = -(-k // (8 // bits))
    w = torch.randn((e, n, k), generator=g)
    packed, scale = zip(*(ops.prep_linear(w[i], bits) for i in range(e)))
    packed, scale = torch.stack(packed), torch.stack(scale)
    x = torch.randn((e, m, k), generator=g).to(torch.bfloat16)
    if grouped:
        plain = ref.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
        got, calls = _meta_calls(ops.quant_matmul, x, packed, scale,
                                 bits=bits, k_orig=k)
        name = "qmatmul_f32_grouped"
    else:
        e = 1
        plain = ops.quant_matmul(x[0], packed[0], scale[0], bits=bits,
                                 k_orig=k)
        got, calls = _meta_calls(ops.quant_matmul, x[0], packed[0], scale[0],
                                 bits=bits, k_orig=k)
        name = "qmatmul_f32"
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (plain.shape, plain.dtype)
    assert calls == [(name, 2 * e * m * n * k,
                      e * (m * k * 2 + n * kp + n * 4 + m * n * 4))]


@pytest.mark.parametrize("case", [
    dict(b=2, hq=4, hkv=2, sq=9, sk=9, d=16, causal=True, window=None,
         off=None, dtype=torch.float32),
    dict(b=1, hq=6, hkv=3, sq=5, sk=17, d=32, causal=True, window=6, off=3,
         dtype=torch.bfloat16),
    dict(b=2, hq=2, hkv=2, sq=7, sk=11, d=16, causal=False, window=None,
         off=None, dtype=torch.float32)])
def test_flash_meta_route(case):
    """The meta output has the plain version's shape and dtype; the stated
    FLOPs are 4 D a (query, key) pair the plain version's mask keeps."""
    c = case
    g = torch.Generator().manual_seed(1)
    q = torch.randn((c["b"], c["hq"], c["sq"], c["d"]), generator=g
                    ).to(c["dtype"])
    k = torch.randn((c["b"], c["hkv"], c["sk"], c["d"]), generator=g
                    ).to(c["dtype"])
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["off"])
    plain = ref.flash_attention(q, k, k, **kw)
    got, calls = _meta_calls(fa.flash_attention, q, k, k, **kw)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (plain.shape, plain.dtype)
    off = c["sk"] - c["sq"] if c["off"] is None else c["off"]
    qpos = off + np.arange(c["sq"])[:, None]
    kpos = np.arange(c["sk"])[None]
    keep = np.ones((c["sq"], c["sk"]), bool)
    if c["causal"]:
        keep &= kpos <= qpos
    if c["window"]:
        keep &= kpos > qpos - c["window"]
    flops = 4 * c["d"] * c["b"] * c["hq"] * int(keep.sum())
    assert [(n, f) for n, f, _ in calls] == [("flash_attention", flops)]


@pytest.mark.parametrize("h0", [False, True])
def test_scan_meta_route(h0):
    g = torch.Generator().manual_seed(2)
    bz, s, di, n = 2, 7, 12, 4
    x, dt = (torch.randn((bz, s, di), generator=g) for _ in range(2))
    A = -torch.rand((di, n), generator=g)
    B, C = (torch.randn((bz, s, n), generator=g) for _ in range(2))
    D = torch.randn((di,), generator=g)
    h = torch.randn((bz, di, n), generator=g) if h0 else None
    y, hl = ops.selective_scan(x, dt, A, B, C, D, h)
    (gy, gh), calls = _meta_calls(ops.selective_scan, x, dt, A, B, C, D, h)
    assert [(t.device.type, t.shape, t.dtype) for t in (gy, gh)] == \
        [("meta", t.shape, t.dtype) for t in (y, hl)]
    assert calls == [("selective_scan", 7 * bz * s * di * n + 3 * bz * s * di,
                      4 * (2 * bz * s * di + 2 * bz * s * n) + 4 * bz * s * di
                      + 4 * (di * n + di + (2 if h0 else 1) * bz * di * n))]


def test_meta_beside_cpu_raises_and_launches_nothing():
    before = (qmm.qmatmul_f32.launches, fa.flash_attention.launches,
              ssm.selective_scan.launches)
    meta = torch.empty((4, 64), device="meta")
    packed, scale = ops.prep_linear(torch.randn(8, 64), 8)
    with pytest.raises(ValueError, match="all on meta"):
        ops.quant_matmul(meta, packed, scale, bits=8, k_orig=64)
    q = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="all on meta"):
        ops.attention(q, torch.randn(1, 2, 4, 16), torch.randn(1, 2, 4, 16))
    with pytest.raises(ValueError, match="all on meta"):
        ops.selective_scan(torch.empty((1, 3, 8), device="meta"),
                           *[torch.randn(s) for s in ((1, 3, 8), (8, 4),
                                                      (1, 3, 4), (1, 3, 4),
                                                      (8,))])
    got = ops.quant_matmul(torch.empty((4, 64), device="meta"),
                           torch.empty((8, 64), dtype=torch.uint8,
                                       device="meta"),
                           torch.empty((8,), device="meta"), bits=8,
                           k_orig=64)
    assert got.shape == (4, 8)
    assert (qmm.qmatmul_f32.launches, fa.flash_attention.launches,
            ssm.selective_scan.launches) == before


def test_cost_counter_counts_traffic_and_kernels():
    """An op's bytes are its tensor inputs and outputs; views and empty
    move none; FLOPs are the flop counter's plus the kernels'."""
    x = torch.empty((8, 16), device="meta")
    w = torch.empty((32, 16), device="meta")
    with hlo_analysis.CostCounter() as cc:
        y = torch.matmul(x, w.T)             # a view, then mm
        y = y + 1.0
        torch.empty((1 << 20,), device="meta")
        ops.quant_matmul(x, torch.empty((32, 16), dtype=torch.uint8,
                                        device="meta"),
                         torch.empty((32,), device="meta"), bits=8, k_orig=16)
    mm = 4 * (8 * 16 + 16 * 32 + 8 * 32)
    add = 4 * 2 * 8 * 32
    qk = 8 * 16 * 4 + 32 * 16 + 32 * 4 + 8 * 32 * 4
    assert hlo_analysis.extract_cost(cc) == (2 * 8 * 16 * 32 * 2,
                                             mm + add + qk)
    assert cc.kernels == {"qmatmul_f32": dict(calls=1, flops=2 * 8 * 32 * 16,
                                              bytes=qk)}


# ---------------------------------------------------------------------------
# (d) the meta count against a real gloo rank
# ---------------------------------------------------------------------------

_META_COUNT = """
    import json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun, hlo_analysis, mesh, steps
    sys.path.insert(0, "tests")
    from torch_dist_ranks import ARCH, DRYRUN_CELL

    m = mesh.fake_rank_mesh((2, 2), ("data", "model"), device="meta")
    cell = ShapeCell(**DRYRUN_CELL)
    fn, args, _ = steps.build_cell(get_config(ARCH).smoke(), cell, m)
    with hlo_analysis.CostCounter() as cc:
        out = fn(*args)
    comm = {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in out[2]["comm"].items() if not k.endswith("_s")}
    rec = dryrun.count_cell(get_config(ARCH).smoke(), cell, m)
    json.dump(dict(comm=comm, flops=cc.flops, record=rec), sys.stdout)
"""


def test_meta_count_equals_a_gloo_rank():
    """The meta count of the (2, 2) train cell on a fake group of 4 gives
    rank 0's ``metrics["comm"]`` (bytes, calls, the compute split) and
    FLOPs as a real 4-rank gloo step on the CPU counts them.  Tolerance:
    exact."""
    from repro_torch.parallel import distributed as D
    from torch_dist_ranks import _ranks_dryrun

    meta = _Lazy([sys.executable, "-c", textwrap.dedent(_META_COUNT)])
    real = D.run_ranks(_ranks_dryrun, 4, device="cpu", timeout_s=300)
    got = json.loads(meta.result())
    comm, flops = real[0]
    assert got["comm"] == comm
    assert got["flops"] == flops > 0
    rec = got["record"]
    assert rec["collectives"]["bytes"] == {
        "all-gather": comm["gather_bytes"],
        "all-reduce": comm["reduce_bytes"],
        "model-axis": comm["act_bytes"]}
    assert rec["collectives"]["counts"] == {
        "all-gather": comm["gather_calls"],
        "all-reduce": comm["reduce_calls"],
        "model-axis": comm["act_calls"]}
    assert rec["cost"]["flops_per_chip"] == flops


_MESHES_AND_PROGRAMS = """
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import mesh, microbench as mb

    out = {}
    for mp, dev in ((False, "meta"), (True, "meta"), (False, "cpu")):
        m = mesh.make_production_mesh(multi_pod=mp, device=dev)
        out[f"{mp}/{dev}"] = dict(
            shape=list(m.devices.shape), axes=list(m.axis_names),
            world=dist.get_world_size(), backend=dist.get_backend(),
            positions=sorted({str(r.device) for r in m.devices.flat}),
            device_mesh=m.device_mesh.device_type,
            coordinate=list(m.coordinate().values()))
    cpu = torch.device("cpu")
    for name, cell in (("qwen3-0.6b", ShapeCell("t", "train", 32, 32)),
                       ("falcon-mamba-7b", ShapeCell("p", "prefill", 64, 32)),
                       ("hymba-1.5b", ShapeCell("d", "decode", 64, 1))):
        cfg = get_config(name).smoke()
        for d in mb.DEPTHS:
            gen = torch.Generator().manual_seed(0)
            cut = mb._depth(cfg, d)
            fn, args = (mb._train_program(cut, cfg, cell, m, gen, cpu)
                        if cell.kind == "train" else
                        mb._serve_program(cut, cell, m, 8, gen, cpu))
            res = fn(*args)
            out[f"{name}/{d}"] = list(res[0].shape) if cell.kind != "train" \
                else res[2]["comm"]["layer_gathers"]
    json.dump(out, sys.stdout)
"""


def test_production_meshes_and_measured_programs():
    """``make_production_mesh`` makes this process rank 0 of a fake group
    of 256 or 512 ranks (a group of the other size replaced), positions on
    ``meta`` with the DeviceMesh on the CPU; ``layer_cost``'s programs (the
    train step on real tensors under the fake group, the serve steps on
    the rank's rows) run at depth 1 and 2, here at smoke size on the CPU."""
    got = json.loads(_Lazy([sys.executable, "-c",
                            textwrap.dedent(_MESHES_AND_PROGRAMS)]).result())
    assert got["False/meta"] == dict(
        shape=[16, 16], axes=["data", "model"], world=256, backend="fake",
        positions=["meta"], device_mesh="cpu", coordinate=[0, 0])
    assert got["True/meta"] == dict(
        shape=[2, 16, 16], axes=["pod", "data", "model"], world=512,
        backend="fake", positions=["meta"], device_mesh="cpu",
        coordinate=[0, 0, 0])
    assert got["False/cpu"]["positions"] == ["cpu"]
    # one gather a layer (the smoke config has no remat to gather again)
    assert [got[f"qwen3-0.6b/{d}"] for d in (1, 2)] == [1, 2]
    falcon = get_config("falcon-mamba-7b").smoke()
    hymba = get_config("hymba-1.5b").smoke()
    for d in (1, 2):
        assert got[f"falcon-mamba-7b/{d}"] == [2, 64, falcon.vocab_size]
        assert got[f"hymba-1.5b/{d}"] == [1, 1, hymba.vocab_size]


# ---------------------------------------------------------------------------
# the CLI, (f) the report
# ---------------------------------------------------------------------------

def test_cli_writes_every_cell_with_the_reference_keys(cli_records):
    """One record a shape and mesh, the reference's keys, the rank's
    argument bytes, the roofline on H100 rates, and long_500k skipped as
    ``applicable`` says."""
    want = {dryrun_name(CLI_ARCH, s, mp) for s in shapes.SHAPES
            for mp in MESHES}
    assert set(cli_records) == want
    for name, rec in cli_records.items():
        if not shapes.applicable(CLI_ARCH, rec["shape"]):
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok" and RECORD_KEYS <= set(rec), name
        assert rec["n_chips"] == math.prod(MESHES[rec["multi_pod"]][0])
        assert rec["memory"]["argument_size_in_bytes"] > 0
        rf = rec["roofline"]
        assert rf["compute_s"] == rf["flops_per_chip"] / 989e12
        assert rf["memory_s"] == rf["hbm_bytes_per_chip"] / 3.35e12
        assert rf["collective_s"] == rf["collective_bytes_per_chip"] / 450e9
        assert (rf["collective_s"] > 0) == (rec["kind"] == "train")
        if rec["kind"] != "train":
            assert rec["split"] == "dp rows only"
            assert rec["collectives"]["counts"] == {}


def dryrun_name(arch, shape, mp):
    from repro_torch.launch import dryrun
    return dryrun.cell_name(arch, shape, mp, 8)


def _columns(table, drop):
    rows = [[c.strip() for c in line.strip("|").split("|")]
            for line in table.splitlines()]
    return [[c for i, c in enumerate(row) if i not in drop] for row in rows]


def test_report_tables_equal_the_reference(cli_records):
    """The port's tables equal the reference's on the same records column
    for column, but the compile column (the port's count seconds) and the
    port's measured-step column; a measured step shows."""
    recs = dict(cli_records)
    measured = dict(next(r for r in recs.values() if r["status"] == "ok"),
                    measured_step_s=0.25)
    recs["zz_measured_1pod"] = measured
    mine, theirs = report.dryrun_table(recs), jreport.dryrun_table(recs)
    assert _columns(mine, {3}) == _columns(theirs, {3})
    assert mine.splitlines()[0].split("|")[4].strip() == "count"
    for mp in (False, True):
        mine = report.roofline_table(recs, multi_pod=mp)
        theirs = jreport.roofline_table(recs, multi_pod=mp)
        assert _columns(mine, {8}) == _columns(theirs, set())
    assert report.roofline_table(recs).splitlines()[-1].split("|")[-2] \
        .strip() == "250.00ms"
    for x in (0, 3e-7, 2e-5, 0.5, 12.0):
        assert report.fmt_s(x) == jreport.fmt_s(x)
    for x in (12, 3e4, 5e7, 2e10, 7e12):
        assert report.fmt_b(x) == jreport.fmt_b(x)


# ---------------------------------------------------------------------------
# (b), (c) the cells' specs, bytes and model FLOPs against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_cell_specs_equal_the_reference(jax_cells, arch):
    """Every input leaf of every cell of ``arch`` on both production
    meshes: path, shape, dtype, PartitionSpec and one rank's block equal
    the reference's ``build_cell`` / ``serve_input_specs`` trees; the
    rank's argument bytes equal the sum of the reference's shard_shape
    bytes.  Tolerance: exact."""
    cfg = get_config(arch)
    for mp, cells in jax_cells.items():
        mesh = _stand_in(mp)
        for shape, cell in shapes.SHAPES.items():
            if not shapes.applicable(arch, shape):
                assert f"{arch}/{shape}" not in cells
                continue
            ref_trees = cells[f"{arch}/{shape}"]["trees"]
            specs = steps.cell_specs(cfg, cell, mesh)
            assert set(specs) == set(ref_trees), (arch, shape)
            for key, tree in specs.items():
                assert _keyed(tree, mesh) == ref_trees[key], \
                    (arch, shape, mp, key)
            ref_bytes = sum(math.prod(leaf[4]) * ITEMSIZE[leaf[2]]
                            for tree in ref_trees.values() for leaf in tree)
            assert shd.rank_bytes(specs, mesh) == ref_bytes, (arch, shape, mp)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(jax_cells, arch):
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    for shape, cell in shapes.SHAPES.items():
        if shapes.applicable(arch, shape):
            assert dryrun.model_flops(cfg, cell) == \
                jax_cells[False][f"{arch}/{shape}"]["model_flops"], shape


def test_build_cell_serve_is_the_rank_rows():
    """A serve cell's program runs on the rank's dp rows with the whole
    packed weights; a decode reads the cache's last row."""
    mesh = _stand_in(False)
    cfg = get_config("hymba-1.5b")
    fn, args, hint = steps.build_cell(cfg, shapes.SHAPES["prefill_32k"], mesh)
    params, tokens, cache = args
    assert hint == {}
    assert tokens.shape == (2, 32768 - cfg.n_meta_tokens)
    assert cache["kv"]["k"].shape[1:4] == (2, cfg.n_kv_heads, 32768)
    assert T.leaves(params)[0].device.type == "meta"
    _, args, _ = steps.build_cell(cfg, shapes.SHAPES["long_500k"], mesh)
    assert args[1].shape == (1, 1) and args[3] == 524287
    assert steps.rank_rows(128, mesh) == 8 and steps.rank_rows(1, mesh) == 1
    cell = ShapeCell("t", "train", 8, 4)
    assert steps.rank_rows(cell.global_batch, _stand_in(True)) == 4
