"""Port parity: mesh-sharded paged serving (``core/paging``'s
``ShardedPagedStore``, ``ShardedPoolLedger``, ``JoinedPageStream``;
``ServingEngine.attach_paging(mesh=)``; the launcher's ``--mesh``).

A port mesh's links all lie on one device (here the CPU): N fetch workers
and N page caches feeding one compute device.  The reference's store and
rules read only a mesh's ``axis_names``, ``shape`` and ``devices``, so its
store runs in process over a stand-in mesh of N positions on the one CPU
device.  The launcher's ``main`` builds its mesh with ``make_test_mesh``,
which needs N devices: the reference's ``main`` runs in one subprocess
with 4 forced host devices, started when the module's first test starts
and read by the last ones, and the port's ``main`` serves the same
JAX-drawn tree (its draw patched to it).  Tokens, ticks and every counter
of the ``mesh`` section must be equal; link names may differ."""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import paging, placement  # noqa: E402
from repro_torch.core.faults import PageFetchTimeout  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.serving import validate  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-0.6b"
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=256)             # tests/test_multidevice.py:356-358
LAUNCH = ["--smoke", "--budget-mb", "0.05", "--requests", "3", "--max-new",
          "4", "--metrics-json"]
LEGS = {"mesh4": ["--mesh", "4"],
        "mesh4-int8": ["--mesh", "4", "--page-bits", "8"],
        "mesh2x2": ["--mesh", "2x2"],
        "mesh4-faults": ["--mesh", "4", "--fault-seed", "1"]}


class StandIn:
    """A mesh for the reference's store: ``shape`` over ("data", "model"),
    every position the one CPU device."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = np.asarray([jax.devices("cpu")[0]] * int(
            np.prod(shape)), dtype=object).reshape(shape)


_REFERENCE_MAIN = """
    import contextlib, json, sys
    from repro.launch import serve

    out = {{}}
    for name, argv in {legs}.items():
        path = f"{tmp}/{{name}}.json"
        with contextlib.redirect_stdout(sys.stderr):
            done = serve.main({launch} + [path] + argv)
        out[name] = dict(tokens={{r.uid: [int(t) for t in r.generated]
                                  for r in done}}, doc=json.load(open(path)))
    json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference_main(tmp_path_factory):
    """The reference's ``main`` on every leg of LEGS, in one subprocess of
    4 host devices, started at once (it runs while the module's other tests
    do) and read when a test first asks for its result."""
    tmp = tmp_path_factory.mktemp("mesh_reference")
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               # the four serves of a main compile the same programs
               JAX_COMPILATION_CACHE_DIR=str(tmp / "xla_cache"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    code = textwrap.dedent(_REFERENCE_MAIN).format(
        legs=repr(LEGS), launch=repr(LAUNCH), tmp=str(tmp))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            result.update(json.loads(out))
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference_main):
    """Start the reference's subprocess before the first test."""


@pytest.fixture(scope="module")
def small():
    """(JAX packed tree, port packed tree, port cfg) of the small qwen3
    config at 8 and at 4 bits."""
    jcfg = jget(ARCH).smoke().replace(**SMALL)
    tcfg = get_config(ARCH).smoke().replace(**SMALL)
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    out = {"tcfg": tcfg}
    for bits in (8, 4):
        jtree = jfreeze(params, bits=bits)
        out[bits] = (jtree, interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtree), tcfg, device="cpu"))
    return out


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.mark.parametrize("bits,page_bits", [(8, None), (8, 8), (4, 8),
                                            (8, 4)],
                         ids=["fp", "int8-identity", "int8-wire", "int4"])
def test_shard_then_encode_equals_encode_then_shard(small, bits, page_bits):
    """Every sharded param of the store on a (1, 4) mesh: the wire image
    of a shard (payload, scales, the wire-served form, the decoded device
    form) is the slice of the whole param's, and equals the reference's
    shard_packed_param + encode_host_param byte for byte."""
    jtree, ttree = small[bits]
    store = paging.packed_tree_store(ttree, None)
    jstore = jpaging.packed_tree_store(jtree, None)
    mesh = make_test_mesh((1, 4), device="cpu")
    axes = paging.store_shard_axes(store, None, mesh)
    assert axes == jpaging.store_shard_axes(jstore, None, StandIn((1, 4)))
    assert axes, "the small net must shard something"
    for name, (ax, n) in axes.items():
        p = store.params[name]
        whole = paging.encode_host_param(p, page_bits)
        lead = whole.packed_shape[:-1]
        w_payload = whole.payload.reshape(*lead, -1)
        w_scales = whole.scales.reshape(*lead, -1)
        dec_packed, dec_scale = whole.decode()
        for i in range(n):
            sh = paging.shard_packed_param(p, ax, n, i)
            jsh = jpaging.shard_packed_param(jstore.params[name], ax, n, i)
            assert sh.orig_shape == tuple(jsh.orig_shape)
            part = paging.encode_host_param(sh, page_bits)
            jpart = jpaging.encode_host_param(jsh, page_bits)
            assert part.crc32 == jpart.crc32
            np.testing.assert_array_equal(part.payload, jpart.payload)
            np.testing.assert_array_equal(part.scales, jpart.scales)
            step = p.orig_shape[ax] // n
            sl = (slice(None),) * ax + (slice(step * i, step * (i + 1)),)
            np.testing.assert_array_equal(
                part.payload.reshape(*part.packed_shape[:-1], -1),
                w_payload[sl])
            np.testing.assert_array_equal(
                part.scales.reshape(*part.packed_shape[:-1], -1),
                w_scales[sl])
            packed, scale = part.decode()
            np.testing.assert_array_equal(packed, dec_packed[sl])
            np.testing.assert_array_equal(scale, dec_scale[sl])
    with pytest.raises(ValueError, match="last axis"):
        paging.shard_packed_param(p, len(p.orig_shape) - 1, 2, 0)


def _ledger_counts(summary):
    keys = ("n_pages", "swap_count", "miss_count", "bytes_streamed_wire",
            "bytes_streamed_raw", "budget_bytes", "live_bytes",
            "cached_pages")
    rows = [{k: d[k] for k in keys if k in d}
            for d in summary["per_device"]]
    return {k: v for k, v in summary.items()
            if k not in ("per_device", "stalls")}, rows


def test_sharded_store_join_and_no_orphaned_pass(small):
    """``tests/test_multidevice.py:343-407`` on the port: a byte-exact
    join, predict() equal to the counters, no pass orphaned by an early
    close, fence after close raising; and the ledger equal to the
    reference store's, pass for pass."""
    jtree, ttree = small[8]
    store = paging.packed_tree_store(ttree, None)        # all paged
    jstore = jpaging.packed_tree_store(jtree, None)
    page_bytes = max(p.nbytes_packed for p in store.params.values())
    sps = paging.ShardedPagedStore(store, page_bytes,
                                   make_test_mesh((1, 4), device="cpu"),
                                   budget_bytes=1 << 22)
    jsps = jpaging.ShardedPagedStore(jstore, page_bytes, StandIn((1, 4)),
                                     budget_bytes=1 << 22)
    assert sps.shard_axes == jsps.shard_axes and sps.shard_axes
    assert [str(link) for link in sps.devices] == [
        f"cpu/link{i}" for i in range(4)]

    with sps.begin_pass() as ps1:
        dev = ps1.fence()
    with jsps.begin_pass() as jps1:
        jps1.fence()
    for name in sps.shard_axes:
        np.testing.assert_array_equal(_np(dev[name].packed),
                                      _np(store.params[name].packed))
        np.testing.assert_array_equal(_np(dev[name].scale),
                                      _np(store.params[name].scale))
        assert dev[name].orig_shape == store.params[name].orig_shape
    assert set(dev) == set(store.params)

    pred = sps.predict()
    assert pred == jsps.predict()
    assert sps.swap_count == pred["swaps"] > 0
    assert sps.bytes_streamed_wire == pred["bytes_wire"]
    assert _ledger_counts(sps.ledger.summary()) == _ledger_counts(
        jsps.ledger.summary())

    ps = sps.begin_pass()
    ps.close()
    for pool in sps.ledger.pools:
        assert not pool._active_fetch, pool._active_fetch
    with pytest.raises(RuntimeError, match="after close"):
        ps.fence()

    with sps.begin_pass() as ps3:
        dev3 = ps3.fence()
    assert set(dev3) == set(dev)
    # the second full pass hits every link's pool
    assert sps.predict()["pool_hits"] > 0
    assert sps.predict()["swaps"] == sps.swap_count
    sps.close()
    jsps.close()


def test_fence_timeout_on_a_stalled_link(small):
    """One link stalls (its first page stuck): fence(timeout_s=) raises
    PageFetchTimeout with every link resumable, and the re-fence completes
    with the full join."""
    _jtree, ttree = small[8]
    store = paging.packed_tree_store(ttree, None)
    page_bytes = max(p.nbytes_packed for p in store.params.values())
    gate = threading.Event()
    sps = paging.ShardedPagedStore(store, page_bytes,
                                   make_test_mesh((1, 4), device="cpu"))
    stalled = sps.stores[2]
    fetch = stalled._fetch_page

    def slow_fetch(idx):
        if idx == 0:
            gate.wait(10)
        return fetch(idx)

    stalled._fetch_page = slow_fetch
    ps = sps.begin_pass()
    with pytest.raises(PageFetchTimeout):
        ps.fence(timeout_s=0.05)
    assert not ps.done
    assert sps.fault_counters["fetch_timeouts"] == 1
    gate.set()
    dev = ps.fence()
    assert ps.done and set(dev) == set(store.params)
    for name in sps.shard_axes:
        np.testing.assert_array_equal(_np(dev[name].packed),
                                      _np(store.params[name].packed))
    assert ps.fence() is dev
    assert sps.swap_count == sps.predict()["swaps"]
    sps.close()


def _serve(tcfg, tree, plan, mesh=None, budget=None, wire=False):
    eng = ServingEngine(tcfg, tree, batch_slots=4, max_len=64, plan=plan,
                        device="cpu")
    eng.attach_paging(mesh=mesh, shard_budget_bytes=budget,
                      wire_serve=wire)
    rng = np.random.default_rng(0)
    for uid in range(4):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, tcfg.vocab_size, 6 + uid).astype(np.int32),
            max_new_tokens=4))
    ticks = 0
    while eng.pending:
        eng.step()
        ticks += 1
    tokens = {r.uid: list(r.generated) for r in eng.finished}
    return tokens, ticks, eng


@pytest.mark.parametrize("budget", [None, 1 << 16], ids=["pool-less",
                                                           "budget"])
@pytest.mark.parametrize("pages", ["fp", "int8", "wire"])
def test_engine_on_four_links_equals_one_link(small, pages, budget):
    """The engine's tokens and ticks on a (1, 4) mesh equal its single-link
    run, with fp pages, int8 pages and wire-served int8 pages (B3's plain
    version on the CPU), with and without a per-link budget; the ledger
    equals its prediction, the global wire bytes the single link's, each
    link fewer; ``paging.devices`` lists the links."""
    bits = 4 if pages == "wire" else 8
    _jtree, ttree = small[bits]
    tcfg = small["tcfg"]
    sizes = placement.packed_sizes(ttree)
    page_bits = None if pages == "fp" else 8
    plan = placement.plan_for_budget(
        sizes, sum(sizes.values()) // 3, sizes_bits=bits,
        hot=placement.Placement("l1mram", bits, "resident"),
        cold=placement.Placement("l1mram", bits, "paged", page_bits))
    wire = pages == "wire"
    one, one_ticks, e1 = _serve(tcfg, ttree, plan, wire=wire)
    mesh = make_test_mesh((1, 4), device="cpu")
    four, four_ticks, e4 = _serve(tcfg, ttree, plan, mesh, budget, wire)
    assert four == one and four_ticks == one_ticks
    pager = e4.pager
    assert isinstance(pager, paging.ShardedPagedStore)
    if wire:
        assert pager.wire_served and pager.wire_served == e1.pager.wire_served
        assert pager.decode_skipped_bytes > 0
        assert pager.decode_s == 0.0
        if budget is None:
            assert pager.decode_skipped_bytes == e1.pager.decode_skipped_bytes
    pred = pager.predict()
    summ = e4.paging_summary()
    assert (summ["swap_count"], summ["miss_count"]) == (pred["swaps"],
                                                        pred["misses"])
    assert summ["bytes_streamed_wire"] == pred["bytes_wire"]
    assert summ["bytes_streamed_raw"] == pred["bytes_raw"]
    rows = summ["devices"]
    assert [r["device"] for r in rows] == [f"cpu/link{i}" for i in range(4)]
    assert rows == pager.ledger.summary()["per_device"]
    assert summ["crc_s"] == pytest.approx(sum(r["crc_s"] for r in rows))
    if budget is None:
        assert summ["bytes_streamed_wire"] == e1.pager.bytes_streamed_wire
        assert max(r["bytes_streamed_wire"] for r in rows) < \
            e1.pager.bytes_streamed_wire
    else:
        assert all(r["budget_bytes"] == budget // 4 for r in rows)
        assert pred["pool_hits"] + pred["swaps"] > 0
    assert e1.paging_summary()["devices"] == []
    e1.pager.close()
    pager.close()


def test_attach_paging_mesh_rules(small):
    """A model axis of one link takes the single-link path; mesh= with
    pool= and a mesh of links on another device are refused."""
    _jtree, ttree = small[8]
    tcfg = small["tcfg"]
    sizes = placement.packed_sizes(ttree)
    plan = placement.plan_for_budget(sizes, sum(sizes.values()) // 2)
    eng = ServingEngine(tcfg, ttree, plan=plan, device="cpu")
    eng.attach_paging(mesh=make_test_mesh((4, 1), device="cpu"))
    assert isinstance(eng.pager, paging.HostPagedStore)
    eng.pager.close()
    eng = ServingEngine(tcfg, ttree, plan=plan, device="cpu")
    pool = paging.SharedPagePool(1 << 20)
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.attach_paging(mesh=make_test_mesh((1, 2), device="cpu"),
                          pool=pool)
    with pytest.raises(ValueError, match="streams? to"):
        eng.attach_paging(mesh=make_test_mesh((1, 2), device="meta"))
    pool.close()
    assert eng.pager is None


def _port_main(monkeypatch, tmp_path, name, argv):
    """The port's ``main`` on ``argv`` over the JAX-drawn tree that the
    reference's ``main`` draws (PRNGKey(0), ``--bits`` 8)."""
    def init_packed(cfg, seed, args):
        jcfg = jget(args.arch).smoke().replace(
            n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            d_ff=cfg.d_ff)
        packed = jfreeze(jtfm.init_params(jcfg, jax.random.PRNGKey(seed)),
                         bits=args.bits)
        return interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, packed), cfg, device="cpu")

    monkeypatch.setattr(serve, "_init_packed", init_packed)
    path = tmp_path / f"{name}.json"
    done = serve.main(["--device", "cpu"] + LAUNCH + [str(path)] + argv)
    return ({r.uid: [int(t) for t in r.generated] for r in done},
            validate(json.loads(path.read_text())))


def _mesh_counters(mesh):
    """The ``mesh`` section without link names and host seconds."""
    out = dict(mesh)
    out["ledger"] = dict(mesh["ledger"])
    out["ledger"]["per_device"] = [
        {k: v for k, v in d.items() if k not in ("device", "crc_s",
                                                  "copy_s")}
        for d in mesh["ledger"]["per_device"]]
    out["ledger"].pop("stalls")
    return out


@pytest.mark.parametrize("leg", list(LEGS))
def test_launcher_mesh_equals_the_reference(reference_main, monkeypatch,
                                            tmp_path, capsys, leg):
    """``serve.main(["--smoke", "--device", "cpu", "--budget-mb", "0.05",
    "--requests", "3", "--max-new", "4", "--mesh", ...])``: every verify
    line BIT-EXACT and the ledger MATCHES; tokens, ticks, the ``mesh``
    section's counters (ledger per link, predicted, single_device,
    sharded_params, per_link_max_wire) and the fault counters equal the
    reference's ``main`` on the same argv; ``paging.devices`` is the
    ledger's rows."""
    tokens, doc = _port_main(monkeypatch, tmp_path, leg, LEGS[leg])
    out = capsys.readouterr().out
    for line in ("verify: paged tokens BIT-EXACT vs resident plan",
                 "verify: async tokens BIT-EXACT vs sync streaming",
                 "verify: mesh tokens BIT-EXACT vs single-device paged run, "
                 "byte ledger obeys the sharding algebra",
                 "global ledger MATCHES the static kv_pass_counters "
                 "prediction"):
        assert line in out, (line, out[-2000:])
    ref = reference_main()[leg]
    assert tokens == {int(u): t for u, t in ref["tokens"].items()}
    mesh, jmesh = doc["mesh"], ref["doc"]["mesh"]
    assert mesh["n_devices"] == (2 if leg == "mesh2x2" else 4)
    assert mesh["sharded_params"] > 0
    assert mesh["bit_exact"] and mesh["ledger_ok"] and mesh["predicted_ok"]
    assert _mesh_counters(mesh) == _mesh_counters(jmesh)
    assert doc["paging"]["devices"] == mesh["ledger"]["per_device"]
    assert doc["ticks"]["count"] == ref["doc"]["ticks"]["count"]
    assert doc["faults"] == ref["doc"]["faults"]
    if leg == "mesh4-faults":
        assert doc["faults"]["injected"] > 0
