"""Port parity: weight paging with faults and wire-serve.

The port's host wire images, pages, CRCs, plans, schedules and fault
decisions are byte-equal to the JAX package's; its ``HostPagedStore``
fetches the same bytes with the same counters, synchronously and
overlapped; and qwen3-0.6b ``.smoke()`` served paged by the port on
``device="cpu"`` gives the JAX engine's tokens and counters, with and
without faults, on the wire-serve and the decode path.  The JAX side
freezes once and exports its packed tree through ``interop``."""

import time

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import faults, paging, placement  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.memsys import overlap_stall  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ARCH = "qwen3-0.6b"
FAST = dict(backoff_s=1e-5, backoff_cap_s=1e-4)     # tests/test_faults.py:32
CHAOS = dict(seed=3, fail_rate=0.2, bitflip_rate=0.2, **FAST)
SUMMARY_KEYS = ("swap_count", "miss_count", "n_pages", "bytes_streamed_wire",
                "bytes_streamed_raw", "decode_skipped_bytes")


def _export(tree, tcfg=None):
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if tcfg is None:
        return {k: {kk: torch.from_numpy(np.array(v)) for kk, v in d.items()}
                for k, d in tree.items()}
    return interop.params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def served():
    """qwen3-0.6b smoke, frozen at 4 and at 8 bits on the JAX side, and the
    same packed trees in the port."""
    cfg, tcfg = get_config(ARCH).smoke(), tget(ARCH).smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    out = dict(cfg=cfg, tcfg=tcfg)
    for bits in (4, 8):
        packed = jfreeze(params, bits=bits)
        out[bits] = (packed, _export(packed, tcfg))
    return out


def _wire_plans():
    """(port plan, JAX plan) of ``benchmarks/serving_load.py --wire-serve``
    at budget 0.5 over a 4-bit tree: int4 resident, int8-paged cold."""
    def make(pl, sizes):
        return pl.plan_for_budget(
            sizes, sum(sizes.values()) // 2, sizes_bits=4,
            hot=pl.Placement("l1mram", 4, "resident"),
            cold=pl.Placement("l1mram", 4, "paged", 8))
    return make


def _plan_tuple(plan):
    def pl(p):
        return (p.scenario, p.weight_bits, p.residency, p.page_bits)
    return (pl(plan.default), [(n, pl(p)) for n, p in plan.rules],
            plan.mode, plan.wire_serve)


def _same_pages(pages, jpages):
    assert len(pages) == len(jpages) > 0
    for p, q in zip(pages, jpages):
        assert (p.index, p.param_names, p.nbytes, p.wire_nbytes,
                p.raw_nbytes, p.encoding, p.crc32) == (
            q.index, q.param_names, q.nbytes, q.wire_nbytes, q.raw_nbytes,
            q.encoding, q.crc32)


# ---------------------------------------------------------------------------
# host images, pages and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_bits", [None, 8, 4, 2])
@pytest.mark.parametrize("rows,k", [(9, 70), (6, 33), (5, 64)])
def test_host_images_byte_equal(rng, page_bits, rows, k):
    w = rng.normal(size=(rows, k)).astype(np.float32)
    p = ws.freeze({"p": dict(w=w)}, ws.uniform_policy(8, min_size=1)
                  ).params["p/w"]
    jp = jws.freeze({"p": dict(w=w)}, jws.uniform_policy(8, min_size=1)
                    ).params["p/w"]
    hp = paging.encode_host_param(p, page_bits)
    jhp = jpaging.encode_host_param(jp, page_bits)
    assert hp.payload.tobytes() == np.asarray(jhp.payload).tobytes()
    assert hp.scales.tobytes() == np.asarray(jhp.scales).tobytes()
    assert hp.crc32 == jhp.crc32 and hp.wire_nbytes == jhp.wire_nbytes
    rt = paging.page_roundtrip_param(p, page_bits)
    jrt = jpaging.page_roundtrip_param(jp, page_bits)
    assert rt.packed.numpy().tobytes() == np.asarray(jrt.packed).tobytes()
    assert rt.scale.numpy().tobytes() == np.asarray(jrt.scale).tobytes()


@pytest.mark.parametrize("bits,page_bits", [(4, 8), (8, 4), (8, 2), (4, None)])
def test_stacked_serve_params_encode_byte_equal(served, bits, page_bits):
    """The serve tree's stacked (L, N, K) groups flatten to (L*N, K) rows
    before the blockwise quantization, as in the reference."""
    jstore = jpaging.packed_tree_store(served[bits][0])
    store = paging.packed_tree_store(served[bits][1])
    assert list(store.params) == list(jstore.params)
    assert list(store.passthrough) == list(jstore.passthrough)
    for name, p in store.params.items():
        jp = jstore.params[name]
        assert p.orig_shape == jp.orig_shape
        hp = paging.encode_host_param(p, page_bits)
        jhp = jpaging.encode_host_param(jp, page_bits)
        assert hp.payload.tobytes() == np.asarray(jhp.payload).tobytes()
        assert hp.scales.tobytes() == np.asarray(jhp.scales).tobytes()
        assert hp.crc32 == jhp.crc32
        packed, scale = hp.decode()
        jpacked, jscale = jhp.decode()
        assert packed.tobytes() == np.asarray(jpacked).tobytes()
        assert scale.tobytes() == np.asarray(jscale).tobytes()


def test_packed_sizes_and_plans_equal(served):
    tree, ttree = served[4]
    sizes = jplacement.packed_sizes(tree)
    assert placement.packed_sizes(ttree) == sizes
    make = _wire_plans()
    plan, jplan = make(placement, sizes), make(jplacement, sizes)
    assert _plan_tuple(plan) == _plan_tuple(jplan)
    assert plan.summary(sizes) == jplan.summary(sizes)
    assert plan.split_names(sorted(sizes)) == jplan.split_names(sorted(sizes))
    assert plan.fits(sizes, 10_000) == jplan.fits(sizes, 10_000)
    for pb in (None, 2, 8):
        assert (_plan_tuple(plan.with_page_bits(pb))
                == _plan_tuple(jplan.with_page_bits(pb)))
    uses = {n: 1.0 + (i % 3) for i, n in enumerate(sorted(sizes))}
    for budget in (0, 5_000, sum(sizes.values()) // 3):
        assert _plan_tuple(placement.plan_for_budget(
            sizes, budget, uses=uses)) == _plan_tuple(
            jplacement.plan_for_budget(sizes, budget, uses=uses))
    # the WeightStore form takes each param's own bits
    w = {f"l{i}": dict(w=np.random.default_rng(i).normal(
        size=(8 * (i + 1), 40)).astype(np.float32)) for i in range(4)}
    pol, jpol = (ws.uniform_policy(4, min_size=1),
                 jws.uniform_policy(4, min_size=1))
    store, jstore = ws.freeze(w, pol), jws.freeze(w, jpol)
    assert store.packed_bytes == jstore.packed_bytes
    for budget in (100, 400, 10_000):
        assert _plan_tuple(placement.plan_for_budget(store, budget)) == \
            _plan_tuple(jplacement.plan_for_budget(jstore, budget))
    fp = placement.freeze_policy(plan)
    jfp = jplacement.freeze_policy(jplan)
    leaf = np.zeros((64, 64), np.float32)
    for name in sizes:
        assert fp(name, torch.from_numpy(leaf)) == jfp(name, leaf)
    # shard_factors (a mesh's per-link charge) plan as the reference's do
    factors = {n: 2 + i % 3 for i, n in enumerate(sorted(sizes))}
    for budget in (0, 5_000, sum(sizes.values()) // 3):
        assert _plan_tuple(placement.plan_for_budget(
            sizes, budget, shard_factors=factors)) == _plan_tuple(
            jplacement.plan_for_budget(sizes, budget,
                                       shard_factors=factors))


@pytest.mark.parametrize("bits,wire", [(4, True), (8, False)])
def test_build_pages_equal_on_smoke_tree(served, bits, wire):
    tree, ttree = served[bits]
    sizes = jplacement.packed_sizes(tree)
    if wire:
        plans = [_wire_plans()(m, sizes) for m in (placement, jplacement)]
    else:
        plans = [m.plan_for_budget(sizes, sum(sizes.values()) // 2)
                 .with_page_bits(4) for m in (placement, jplacement)]
    store = paging.packed_tree_store(ttree, plans[0])
    jstore = jpaging.packed_tree_store(tree, plans[1])
    host = {n: paging.encode_host_param(
        p, plans[0].placement_for(n).page_bits) for n, p in
        store.params.items() if plans[0].placement_for(n).paged}
    jhost = {n: jpaging.encode_host_param(
        p, plans[1].placement_for(n).page_bits) for n, p in
        jstore.params.items() if plans[1].placement_for(n).paged}
    for page_bytes in (max(p.nbytes_packed for p in store.params.values()),
                       10 ** 9):
        _same_pages(paging.build_pages(store, page_bytes, plan=plans[0],
                                       host=host),
                    jpaging.build_pages(jstore, page_bytes, plan=plans[1],
                                        host=jhost))
        assert paging.page_sizes(paging.build_pages(store, page_bytes)) == \
            jpaging.page_sizes(jpaging.build_pages(jstore, page_bytes))
    with pytest.raises(ValueError, match="exceeds page size"):
        paging.build_pages(store, 8, plan=plans[0])


def test_schedules_and_pass_counters_equal():
    for n in range(0, 7):
        for slots in (1, 2, 3):
            assert paging.pass_counters(n, slots) == \
                jpaging.pass_counters(n, slots)
            sched = paging.make_schedule(n, slots)
            jsched = jpaging.make_schedule(n, slots)
            assert [(e.page, e.prefetch_next, e.evicts) for e in sched] == \
                [(e.page, e.prefetch_next, e.evicts) for e in jsched]
            paging.validate_schedule(sched, slots)
    with pytest.raises(faults.ScheduleError):
        paging.validate_schedule([paging.PageScheduleEntry(0, None, 0)])
    with pytest.raises(ValueError):
        paging.make_schedule(3, 0)
    pages = [paging.Page(i, (f"p{i}",), 1000 * (i + 1)) for i in range(4)]
    jpages = [jpaging.Page(i, (f"p{i}",), 1000 * (i + 1)) for i in range(4)]
    times = [1e-6, 3e-6, 0.0, 2e-6]
    assert paging.StallModel(1e9).run(pages, times) == \
        jpaging.StallModel(1e9).run(jpages, times)


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def test_fault_decisions_equal_reference():
    buf = bytes(range(97))
    for seed in (0, 3, 11):
        plan = faults.FaultPlan(seed=seed, fail_rate=0.3, bitflip_rate=0.4,
                                spike_rate=0.2, spike_s=0.0, **FAST)
        jplan = jfaults.FaultPlan(seed=seed, fail_rate=0.3, bitflip_rate=0.4,
                                  spike_rate=0.2, spike_s=0.0, **FAST)
        inj, jinj = faults.FaultInjector(plan), jfaults.FaultInjector(jplan)
        for model in ("default", "tenant-b"):
            for page in range(6):
                for attempt in range(plan.max_attempts):
                    assert inj.corrupt(model, page, attempt, buf) == \
                        jinj.corrupt(model, page, attempt, buf)
                    outcome = []
                    for i in (inj, jinj):
                        try:
                            outcome.append(i.pre_fetch(model, page, attempt))
                        except (faults.TransientFetchFault,
                                jfaults.TransientFetchFault) as e:
                            outcome.append(("fail", e.page, e.attempt))
                    assert outcome[0] == outcome[1]
        for attempt in range(1, 8):
            assert plan.backoff(attempt) == jplan.backoff(attempt)
    assert faults.merge_fault_counters([{"injected": 2}, {"retries": 1}]) == \
        jfaults.merge_fault_counters([{"injected": 2}, {"retries": 1}])
    with pytest.raises(ValueError, match="max_faulty_attempts"):
        faults.FaultPlan(max_faulty_attempts=4, max_attempts=4)


class _StubStore:
    def __init__(self, plan):
        self.name = "stub"
        self.faults = faults.as_injector(plan)
        self.fault_counters = faults.new_fault_counters()


def test_retry_exhaustion_raises_typed_error():
    store = _StubStore(faults.FaultPlan(max_attempts=3,
                                        max_faulty_attempts=2, **FAST))

    def attempt(a):
        raise faults.TransientFetchFault(model="stub", page=7, attempt=a)

    with pytest.raises(faults.PageFetchError) as ei:
        paging.retry_fetch(store, 7, attempt)
    err = ei.value
    assert isinstance(err, faults.PagingError)
    assert (err.model, err.page, err.attempts) == ("stub", 7, 3)
    assert store.fault_counters["injected"] == 3
    assert store.fault_counters["retries"] == 2


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _flat_stores(rng, n=6, d=32):
    w = {f"layer{i:02d}": dict(w=rng.normal(size=(d, d)).astype(np.float32))
         for i in range(n)}
    pol, jpol = (ws.uniform_policy(8, min_size=16),
                 jws.uniform_policy(8, min_size=16))
    return ws.freeze(w, pol), jws.freeze(w, jpol)


def _fetched(store):
    return {n: (np.asarray(p.packed).tobytes(), np.asarray(p.scale).tobytes())
            for n, p in store.items()}


@pytest.mark.parametrize("page_bits", [None, 8, 4])
@pytest.mark.parametrize("slots", [1, 2])
def test_store_stream_equals_reference(rng, page_bits, slots):
    store, jstore = _flat_stores(rng)
    plans = [m.PlacementPlan.uniform("l3flash", bits=8, residency="paged")
             .with_page_bits(page_bits) for m in (placement, jplacement)]
    fp = dict(seed=5, fail_rate=0.3, bitflip_rate=0.3, **FAST)
    t = paging.HostPagedStore(store, 2 * 32 * 32, device="cpu",
                              plan=plans[0], faults=faults.FaultPlan(**fp))
    j = jpaging.HostPagedStore(jstore, 2 * 32 * 32, plan=plans[1],
                               faults=jfaults.FaultPlan(**fp))
    _same_pages(t.pages, j.pages)
    for _ in range(2):
        got, want = list(t.stream(slots)), list(j.stream(slots))
        assert [p.index for p, _ in got] == [p.index for p, _ in want]
        for (_p, dev), (_q, jdev) in zip(got, want):
            assert _fetched(dev) == _fetched(jdev)
    assert (t.swap_count, t.miss_count) == (j.swap_count, j.miss_count)
    n = len(t.pages)
    counts = paging.pass_counters(n, slots)
    assert (t.swap_count, t.miss_count) == (2 * counts["swaps"],
                                            2 * counts["misses"])
    assert t.fault_counters == j.fault_counters
    assert t.fault_counters["checksum_failures"] == \
        t.fault_counters["refetches"]
    assert (t.bytes_streamed_wire, t.bytes_streamed_raw) == (
        j.bytes_streamed_wire, j.bytes_streamed_raw)
    t.close()
    j.close()


def test_begin_pass_gives_the_sync_pages(rng):
    store, _ = _flat_stores(rng)
    sync = paging.HostPagedStore(store, 2 * 32 * 32, device="cpu")
    pages = {}
    with sync.stream() as s:
        for _page, dev in s:
            pages.update(dev)
    paged = paging.HostPagedStore(store, 2 * 32 * 32, device="cpu")
    ps = paged.begin_pass()
    time.sleep(0.02)                    # a compute window to hide in
    dev = ps.fence()
    assert _fetched(dev) == _fetched(pages)
    assert _fetched(dev) == _fetched(store.params)
    assert (paged.swap_count, paged.miss_count) == (sync.swap_count,
                                                    sync.miss_count)
    # the stream's wall splits into hidden and exposed, and the compute
    # window hid some of it (memsys.overlap_stall's terms)
    assert ps.swap_s == pytest.approx(ps.exposed_s + ps.hidden_s)
    assert 0.0 < ps.hidden_s <= ps.window_s
    pred = overlap_stall(ps.swap_s, ps.window_s)
    assert pred["hidden_s"] >= ps.hidden_s
    assert ps.fence() is dev            # idempotent: no re-wait
    ps.close()                          # a no-op on a fenced pass
    closed = paged.begin_pass()
    closed.close()
    with pytest.raises(RuntimeError, match="close"):
        closed.fence()
    sync.close()
    paged.close()


def test_store_raises_where_the_port_stops(rng, monkeypatch):
    store, _ = _flat_stores(rng, n=2)
    pool = paging.SharedPagePool(1 << 20)
    joined = paging.HostPagedStore(store, 4096, device="cpu", pool=pool,
                                   name="m")
    assert pool.members["m"] is joined and joined._fetch_exec is pool._exec
    with pytest.raises(ValueError, match="already joined"):
        paging.HostPagedStore(store, 4096, device="cpu", pool=pool, name="m")
    pool.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paging.HostPagedStore(store, 4096)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(n=4, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length).astype(np.int32) for _ in range(n)]


def _serve_jax(served, bits, plan, **attach):
    eng = JEngine(served["cfg"], served[bits][0], batch_slots=2, max_len=64,
                  plan=plan)
    eng.attach_paging(**attach)
    for uid, p in enumerate(_prompts()):
        eng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=5))
    toks = {r.uid: r.generated for r in eng.run_until_done()}
    out = (toks, eng.paging_summary(), eng.faults_summary(),
           eng.pager.decode_s)
    eng.pager.close()
    return out


def _serve_port(served, bits, plan, tree=None, **attach):
    eng = ServingEngine(served["tcfg"], tree if tree is not None
                        else served[bits][1], batch_slots=2, max_len=64,
                        plan=plan, device="cpu")
    if tree is None:
        eng.attach_paging(**attach)
    for uid, p in enumerate(_prompts()):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=5))
    toks = {r.uid: r.generated for r in eng.run_until_done()}
    out = (toks, eng.paging_summary(), eng.faults_summary(), eng)
    if eng.pager is not None:
        eng.pager.close()
    return out


@pytest.mark.parametrize("chaos", [False, True])
def test_wire_serve_matches_jax(served, chaos):
    sizes = jplacement.packed_sizes(served[4][0])
    make = _wire_plans()
    jplan, plan = make(jplacement, sizes), make(placement, sizes)
    fj = jfaults.FaultPlan(**CHAOS) if chaos else None
    ft = faults.FaultPlan(**CHAOS) if chaos else None
    jtoks, jpg, jfs, jdec = _serve_jax(served, 4, jplan, wire_serve=True,
                                       faults=fj)
    toks, pg, fs, eng = _serve_port(served, 4, plan, wire_serve=True,
                                    faults=ft)
    assert toks == jtoks
    assert all(len(t) == 5 for t in toks.values())
    assert {k: pg[k] for k in SUMMARY_KEYS} == {k: jpg[k]
                                                 for k in SUMMARY_KEYS}
    assert pg["decode_skipped_bytes"] > 0
    assert pg["decode_s"] == 0.0 == jdec     # no fetch decode ran
    assert eng.pager.wire_served == {
        n for n in eng.pager._host
        if placement.wire_served_bits(eng.plan, n) is not None}
    assert eng.pager.wire_served      # the cold groups, all int8 re-encoded
    assert fs == jfs
    if chaos:
        assert fs["injected"] > 0
        assert fs["checksum_failures"] == fs["refetches"]
    else:
        assert all(v == 0 for v in fs.values())


def test_wire_serve_equals_a_resident_engine_on_the_wire_tree(served):
    """The pager changes where the bytes come from, not what is computed:
    a resident engine holding the cold groups already in wire form, under
    the same plan, gives the same tokens bit for bit."""
    sizes = placement.packed_sizes(served[4][1])
    plan = _wire_plans()(placement, sizes)
    toks, pg, _fs, eng = _serve_port(served, 4, plan, wire_serve=True)
    ticks = pg["swap_count"] // paging.pass_counters(pg["n_pages"])["swaps"]
    assert pg["swap_count"] == ticks * paging.pass_counters(
        pg["n_pages"])["swaps"]
    assert pg["miss_count"] == ticks * paging.pass_counters(
        pg["n_pages"])["misses"]
    # the template leaves of the cold groups stayed on the host
    assert eng.params["layers"]["attn"]["wq"]["scale"].ndim == 3
    wire_tree = paging.thread_packed(served[4][1], {
        **eng.pager.resident, **eng.pager.template_view()})
    resident, rpg, _, _ = _serve_port(served, 4, plan.replace(
        wire_serve=True), tree=wire_tree)
    assert resident == toks
    assert rpg["swap_count"] == 0


@pytest.mark.parametrize("page_bits", [None, 4])
def test_decode_path_matches_jax(served, page_bits):
    """An 8-bit store with its cold half decoded on the host at fetch:
    verbatim (page_bits None) and the lossy int4 re-encode."""
    sizes = jplacement.packed_sizes(served[8][0])
    jplan, plan = (m.plan_for_budget(sizes, sum(sizes.values()) // 2)
                   .with_page_bits(page_bits)
                   for m in (jplacement, placement))
    jtoks, jpg, jfs, _ = _serve_jax(served, 8, jplan)
    toks, pg, fs, _ = _serve_port(served, 8, plan)
    assert toks == jtoks
    assert {k: pg[k] for k in SUMMARY_KEYS} == {k: jpg[k]
                                                 for k in SUMMARY_KEYS}
    assert pg["decode_skipped_bytes"] == 0
    assert fs == jfs


def test_attach_paging_raises_where_the_port_stops(served):
    sizes = placement.packed_sizes(served[4][1])
    plan = _wire_plans()(placement, sizes)
    eng = ServingEngine(served["tcfg"], served[4][1], plan=plan,
                        device="cpu")
    from repro_torch.launch.mesh import make_test_mesh
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.attach_paging(mesh=make_test_mesh((1, 2), device="cpu"),
                          pool=paging.SharedPagePool(1 << 20))
    meshed = ServingEngine(served["tcfg"], served[4][1], plan=plan,
                           device="cpu")
    meshed.attach_paging(mesh=make_test_mesh((1, 2), device="cpu"))
    assert isinstance(meshed.pager, paging.ShardedPagedStore)
    assert meshed.pager.n_shards == 2 and meshed.pager.shard_axes
    meshed.pager.close()
    pooled = ServingEngine(served["tcfg"], served[4][1], plan=plan,
                           device="cpu")
    pool = paging.SharedPagePool(1 << 30)
    pooled.attach_paging(pool=pool, name="q")
    assert pool.members["q"] is pooled.pager and pooled.pager.pool is pool
    pool.close()
    with pytest.raises(ValueError, match="no paged parameters"):
        ServingEngine(served["tcfg"], served[4][1],
                      device="cpu").attach_paging()
    eng.attach_paging(wire_serve=True)
    with pytest.raises(ValueError, match="already attached"):
        eng.attach_paging()
    eng.pager.close()
