"""Port parity: KV-cache paging through the shared page pool.

The port's ``KVPageTable`` / ``KVPageStream`` / ``kv_pass_counters`` and
the engine's KV half are held against the JAX package's on identical
inputs: the same numpy caches for the table's mechanics, and for serving
the tiny dense config of ``tests/test_kv_paging.py`` with weights
initialised in JAX and carried across with ``interop`` (temperature 0,
JAX on ``mode="xla"``, the port on ``device="cpu"``).  Tokens must be
bit-exact against the unpaged run and against JAX's KV-paged run; the
pool's event log must equal JAX's event for event, and every member's
counters the ``kv_pass_counters`` replay.  The overlap timings are held
only to what holds by construction (``swap_s == hidden_s + exposed_s``,
``0 <= hidden_s <= window_s``)."""

import json

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import memsys as jmemsys  # noqa: E402
from repro.core import paging as jpaging  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import MultiScheduler as JMultiScheduler  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import paging, placement  # noqa: E402
from repro_torch.core.memsys import kv_stream_bytes  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402
from repro_torch.serving import (MetricsRecorder, MultiScheduler,  # noqa: E402
                                 Request, Scheduler, ServingEngine,
                                 validate)

TINY = dict(name="tinykv", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, remat=False)
COUNTERS = ("swaps", "misses", "pool_hits", "evicted")
# the traffic of the bit-exactness cases (tests/test_kv_paging.py)
CANON = [np.random.default_rng(7).integers(0, 256, 3 + 7 * u)
         .astype(np.int32) for u in range(4)]


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX packed tree, port cfg, port packed tree)."""
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    packed = jfreeze(jtfm.init_params(jcfg, jax.random.PRNGKey(0)), bits=8)
    tpacked = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, packed), tcfg, device="cpu")
    return jcfg, packed, tcfg, tpacked


def _half_paged(pl, tree):
    sizes = pl.packed_sizes(tree)
    plan = pl.plan_for_budget(sizes, sum(sizes.values()) // 2)
    assert plan.paged_bytes(sizes) > 0
    return plan


def _budget(kind, pl, tree):
    cold = _half_paged(pl, tree).paged_bytes(pl.packed_sizes(tree))
    return (1 << 30) if kind == "roomy" else max(cold // 2, 1)


def _serve(side, models, prompts, *, paged=False, kv=False, pool=None,
           async_io=True, kv_block=4, max_new=6, slots=2, max_len=64):
    """One Scheduler run of ``side`` ("jax" or "port"): (tokens, scheduler,
    engine).  ``pool`` is a budget kind ("roomy", "tight") or None."""
    jcfg, jtree, tcfg, ttree = models
    port = side == "port"
    cfg, tree = (tcfg, ttree) if port else (jcfg, jtree)
    pl = placement if port else jplacement
    kw = dict(batch_slots=slots, max_len=max_len)
    if port:
        kw["device"] = "cpu"
    if paged:
        kw["plan"] = _half_paged(pl, tree)
    eng = (ServingEngine if port else JEngine)(cfg, tree, **kw)
    shared = None
    if pool is not None:
        shared = (paging if port else jpaging).SharedPagePool(
            _budget(pool, pl, tree))
    if paged:
        eng.attach_paging(pool=shared, name="m")
    if kv:
        eng.attach_kv_paging(kv_block, pool=shared, name="m/kv")
    s = (Scheduler if port else JScheduler)(eng, prefill_chunk=8,
                                            async_io=async_io)
    for uid, p in enumerate(prompts):
        s.submit((Request if port else JRequest)(uid=uid, prompt=p,
                                                 max_new_tokens=max_new))
    done = s.run_until_done()
    return {r.uid: r.generated for r in done}, s, eng


def _close(eng):
    for part in (eng.pager, eng.kv_table):
        if part is not None:
            (part.pool or part).close()


_RUNS = {}


def _run(side, models, prompts_key, **kw):
    """A run kept for the module: each JAX serve compiles its programs."""
    key = (side, prompts_key, tuple(sorted(kw.items())))
    if key not in _RUNS:
        prompts = {"canon": CANON,
                   "reuse": [np.random.default_rng(0).integers(0, 256, n)
                             .astype(np.int32) for n in (4, 10, 16)],
                   "long": [np.random.default_rng(1).integers(0, 256, n)
                            .astype(np.int32) for n in (6, 14, 22, 30)],
                   "trunc": [np.random.default_rng(2).integers(0, 256, 8)
                             .astype(np.int32)]}[prompts_key]
        _RUNS[key] = _serve(side, models, prompts, **kw)
    return _RUNS[key]


def _events(pool_or_table):
    """An event log as plain tuples, comparable across the packages."""
    return [tuple((kind, m, tuple(tuple(x) if isinstance(x, tuple) else x
                                  for x in rest[0])) if rest else
                  (kind, m)) for kind, m, *rest in pool_or_table.events]


def _fake_cache(rng, n_layers=2, slots=2, heads=2, max_len=16, hd=4):
    shape = (n_layers, slots, heads, max_len, hd)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return (dict(k=torch.from_numpy(k), v=torch.from_numpy(v)),
            dict(k=jnp.asarray(k), v=jnp.asarray(v)))


# ---------------------------------------------------------------------------
# KVPageTable mechanics, against the reference's table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,slots,heads,max_len,hd,block",
                         [(3, 2, 2, 20, 4, 8), (2, 4, 1, 16, 8, 4),
                          (1, 1, 3, 7, 2, 16)])
def test_kv_geometry_and_stream_bytes(rng, n_layers, slots, heads, max_len,
                                      hd, block):
    cache, jcache = _fake_cache(rng, n_layers, slots, heads, max_len, hd)
    t = paging.KVPageTable(cache, block_rows=block, device="cpu")
    jt = jpaging.KVPageTable(jcache, block_rows=block)
    assert (t.n_blocks, len(t.pages), t.row_nbytes, t.page_nbytes) == (
        jt.n_blocks, len(jt.pages), jt.row_nbytes, jt.page_nbytes)
    assert t.row_nbytes == 2 * n_layers * heads * hd * 4
    for valid in range(0, max_len + 1, 3):
        assert kv_stream_bytes(valid, block, t.row_nbytes) == \
            jmemsys.kv_stream_bytes(valid, block, jt.row_nbytes)
    for bad in ((4, 0, 100), (-1, 4, 100), (4, 4, -1)):
        with pytest.raises(ValueError):
            kv_stream_bytes(*bad)
    t.close()
    jt.close()


@pytest.mark.parametrize("max_len,block", [(16, 4), (14, 4)])
def test_kv_writeback_fetch_roundtrip(rng, max_len, block):
    """Rows written back come back bit-identical from a begin / fence
    pass, as the reference's do (also the padded last block of a max_len
    that the block does not divide)."""
    cache, jcache = _fake_cache(rng, max_len=max_len)
    t = paging.KVPageTable(cache, block_rows=block, device="cpu")
    jt = jpaging.KVPageTable(jcache, block_rows=block)
    n = -(-max_len // block)
    for table, c in ((t, cache), (jt, jcache)):
        table.writeback(0, 0, n, c)
    blocks = t.begin_pass({0: n}).fence({0: n})
    jblocks = jt.begin_pass({0: n}).fence({0: n})
    assert sorted(blocks) == sorted(jblocks) == list(range(n))
    for blk in range(n):
        a, b = blk * block, min((blk + 1) * block, max_len)
        for part in ("k", "v"):
            got = blocks[blk][part].numpy()
            assert got.tobytes() == np.asarray(
                jblocks[blk][part]).tobytes()
            assert torch.equal(blocks[blk][part], cache[part][:, 0, :, a:b])
    assert (t.swap_count, t.miss_count, t.writebacks,
            t.bytes_streamed_wire) == (jt.swap_count, jt.miss_count,
                                       jt.writebacks, jt.bytes_streamed_wire)
    assert _events(t) == _events(jt)
    t.close()
    jt.close()


def test_kv_pool_hit_skips_swap(rng):
    cache, jcache = _fake_cache(rng)
    out = []
    for pkg, c, kw in ((paging, cache, dict(device="cpu")),
                       (jpaging, jcache, {})):
        pool = pkg.SharedPagePool(1 << 20)
        t = pkg.KVPageTable(c, block_rows=4, pool=pool, name="m/kv", **kw)
        t.writeback(0, 0, 2, c)
        t.begin_pass({0: 2}).fence({0: 2})
        first = (t.swap_count, t.pool_hits)
        t.begin_pass({0: 2}).fence({0: 2})      # second pass: all pooled
        out.append((first, t.swap_count, t.pool_hits,
                    pool.counters["m/kv"]["pool_hits"], _events(pool),
                    pool.summary()["live_bytes"]))
        pool.close()
    assert out[0] == out[1]
    assert out[0][:4] == ((2, 0), 2, 2, 2)


def test_kv_fence_idempotent_and_close_releases_the_guard(rng):
    cache, _ = _fake_cache(rng)
    t = paging.KVPageTable(cache, block_rows=4, device="cpu")
    t.writeback(0, 0, 2, cache)
    ps = t.begin_pass({0: 2})
    first = ps.fence({0: 2})
    assert ps.fence({0: 2}) is first and ps.done
    swaps = t.swap_count
    ps.close()                                 # a no-op on a fenced pass
    assert t.swap_count == swaps
    ps2 = t.begin_pass({0: 2})
    ps2.close()
    with pytest.raises(RuntimeError, match="close"):
        ps2.fence({0: 2})
    t.close()
    pool = paging.SharedPagePool(1 << 20)
    t = paging.KVPageTable(cache, block_rows=4, pool=pool, name="m/kv",
                           device="cpu")
    t.writeback(0, 0, 2, cache)
    t.begin_pass({0: 2}).close()
    assert not pool._active_fetch              # released, not leaked
    assert sorted(t.begin_pass({0: 2}).fence({0: 2})) == [0, 1]
    pool.close()


def test_kv_drop_invalidates_and_zeroes(rng):
    """flush_drops removes the slot's pooled pages (dropped, not evicted),
    zeroes its host rows, and rides the event log as JAX's does."""
    cache, jcache = _fake_cache(rng)
    logs = []
    for pkg, c, kw in ((paging, cache, dict(device="cpu")),
                       (jpaging, jcache, {})):
        pool = pkg.SharedPagePool(1 << 20)
        t = pkg.KVPageTable(c, block_rows=4, pool=pool, name="m/kv", **kw)
        t.writeback(0, 0, 2, c)
        t.begin_pass({0: 2}).fence({0: 2})
        t.queue_drop(0)
        t.flush_drops()
        assert t.dropped == 2 and pool.counters["m/kv"]["evicted"] == 0
        assert pool.lookup("m/kv", 0) is None
        swaps = t.swap_count
        t.begin_pass({0: 1}).fence({0: 1})     # a re-fetch swaps again
        assert t.swap_count == swaps + 1
        pred = pkg.kv_pass_counters({}, pool.budget_bytes, pool.events)
        assert (pred["m/kv"]["dropped"], pred["m/kv"]["swaps"]) == (
            2, t.swap_count)
        logs.append(_events(pool))
        if pkg is paging:
            assert not t.host["k"][0].any() and not t.host["v"][0].any()
            assert t.host["k"][1].any()        # the other slot is kept
        pool.close()
    assert logs[0] == logs[1]


def test_kv_fetch_bytes_follow_the_closed_form(rng):
    cache, _ = _fake_cache(rng, slots=2, max_len=16)
    t = paging.KVPageTable(cache, block_rows=4, device="cpu")
    t.writeback(0, 0, 3, cache)
    t.writeback(1, 0, 1, cache)
    spans = {0: 13, 1: 6}                      # valid rows a slot
    full = {s: v // 4 for s, v in spans.items()}
    t.begin_pass(full).fence(full)
    want = sum(kv_stream_bytes(v, 4, t.row_nbytes) for v in spans.values())
    assert t.swap_count * t.page_nbytes == want == t.bytes_streamed_wire
    t.close()


def test_kv_pass_counters_equal_the_reference_replay():
    """The replay itself, on a mixed weight / KV / drop log."""
    sizes = {"w": [(100, 60, 400), (100, 60, 400), (80, 50, 320)]}
    events = [("pass", "w"), ("kv", "w/kv", ((0, 64), (1, 64))),
              ("pass", "w"), ("kvdrop", "w/kv", (0,)),
              ("kv", "w/kv", ((0, 64), (2, 64))), ("pass", "w")]
    for budget in (None, 50, 250, 400, 10_000):
        assert paging.kv_pass_counters(sizes, budget, events) == \
            jpaging.kv_pass_counters(sizes, budget, events)
    with pytest.raises(ValueError, match="unknown"):
        paging.kv_pass_counters({}, 10, [("bogus", "m")])


# ---------------------------------------------------------------------------
# serving: tokens, counters and the event log against JAX
# ---------------------------------------------------------------------------

def test_kv_paged_decode_bit_exact_dense(models):
    ref, _s, _e = _run("port", models, "canon")
    got, _s, eng = _run("port", models, "canon", kv=True)
    jgot, _js, jeng = _run("jax", models, "canon", kv=True)
    assert got == ref == jgot
    assert eng.kv_table.swap_count == jeng.kv_table.swap_count > 0
    assert eng.kv_table.writebacks == jeng.kv_table.writebacks > 0
    assert _events(eng.kv_table) == _events(jeng.kv_table)


@pytest.mark.parametrize("budget", ["roomy", "tight"])
def test_kv_paged_shared_pool_equals_jax(models, budget):
    """Weights and KV blocks contend for one pool budget: tokens stay
    bit-exact; the pool's log and counters equal JAX's and the replay."""
    ref, _s, _e = _run("port", models, "canon")
    got, _s, eng = _run("port", models, "canon", paged=True, kv=True,
                        pool=budget)
    jgot, _js, jeng = _run("jax", models, "canon", paged=True, kv=True,
                           pool=budget)
    assert got == ref == jgot
    pool, jpool = eng.pager.pool, jeng.pager.pool
    assert _events(pool) == _events(jpool)
    summ, jsumm = pool.summary(), jpool.summary()
    assert set(summ["models"]) == {"m", "m/kv"}
    pred = paging.kv_pass_counters({"m": paging.page_sizes(eng.pager.pages)},
                                   pool.budget_bytes, pool.events)
    for m in ("m", "m/kv"):
        got_c = {k: summ["models"][m][k] for k in COUNTERS}
        assert got_c == {k: jsumm["models"][m][k] for k in COUNTERS}
        assert got_c == {k: pred[m][k] for k in COUNTERS}, m
        assert summ["models"][m]["bytes_streamed_wire"] == \
            pred[m]["bytes_wire"]
        assert summ["models"][m]["bytes_streamed_raw"] == pred[m]["bytes_raw"]
    if budget == "roomy":
        assert summ["evictions"] == 0 and eng.kv_table.pool_hits > 0
    else:
        assert summ["evictions"] > 0


def test_kv_paged_sync_mode_hides_nothing(models):
    ref, _s, _e = _run("port", models, "canon")
    got, _s, eng = _serve("port", models, CANON, kv=True, async_io=False)
    assert got == ref
    ps = eng.paging_summary()
    assert eng.kv_hidden_s == ps["kv_hidden_s"] == 0.0
    assert ps["kv_exposed_s"] > 0.0
    _close(eng)


def test_kv_truncated_request(models):
    """Cache exhaustion under KV paging truncates at the same token as the
    resident engine, and as JAX's KV-paged engine."""
    kw = dict(max_len=16, max_new=32, slots=1)
    ref, _s, _e = _run("port", models, "trunc", **kw)
    got, s, _e = _run("port", models, "trunc", kv=True, **kw)
    jgot, js, _je = _run("jax", models, "trunc", kv=True, **kw)
    assert got == ref == jgot
    assert s.finished[0].truncated and js.finished[0].truncated


def test_kv_slot_reuse_leaves_no_stale_page(models):
    """Sequential occupants of one slot: the retired request's pooled
    blocks are dropped before the next one could hit them."""
    ref, _s, _e = _run("port", models, "reuse", slots=1)
    got, _s, eng = _run("port", models, "reuse", kv=True, pool="roomy",
                        slots=1)
    jgot, _js, jeng = _run("jax", models, "reuse", kv=True, pool="roomy",
                           slots=1)
    assert got == ref == jgot
    assert eng.kv_table.dropped == jeng.kv_table.dropped > 0
    assert _events(eng.kv_table.pool) == _events(jeng.kv_table.pool)


@pytest.mark.parametrize("pool", [None, "roomy", "tight"])
def test_kv_counters_follow_the_replay(models, pool):
    """Private table (every listed block swaps) and pooled members: the
    counters equal the replay of the log, the log equals JAX's, and the
    weights keep ``ticks x pass_counters`` without a pool."""
    got, s, eng = _run("port", models, "long", paged=True, kv=True,
                       pool=pool, max_new=10)
    jgot, _js, jeng = _run("jax", models, "long", paged=True, kv=True,
                           pool=pool, max_new=10)
    assert got == jgot
    kv = eng.kv_table
    if pool is None:
        assert _events(kv) == _events(jeng.kv_table)
        pred = paging.kv_pass_counters({}, None, kv.events)
        assert pred["m/kv"]["swaps"] == kv.swap_count == sum(
            len(ev[2]) for ev in kv.events if ev[0] == "kv")
        assert kv.pool_hits == 0
        per_pass = paging.pass_counters(len(eng.pager.pages),
                                        eng.page_resident_slots)
        assert eng.swap_count == s.ticks * per_pass["swaps"]
        assert eng.miss_count == s.ticks * per_pass["misses"]
        return
    p = kv.pool
    assert _events(p) == _events(jeng.kv_table.pool)
    pred = paging.kv_pass_counters({"m": paging.page_sizes(eng.pager.pages)},
                                   p.budget_bytes, p.events)
    summ = p.summary()
    for m in ("m", "m/kv"):
        assert {k: summ["models"][m][k] for k in COUNTERS} == {
            k: pred[m][k] for k in COUNTERS}, m
    if pool == "tight":
        # one eviction domain: weights evict KV blocks and the reverse
        assert summ["models"]["m"]["evicted"] > 0
        assert summ["models"]["m/kv"]["evicted"] > 0
    else:
        uni = paging.kv_pass_counters(
            {"m": [q.nbytes for q in eng.pager.pages]}, p.budget_bytes,
            [e for e in p.events if e[0] == "pass"])
        old = paging.shared_pass_counters(
            {"m": [q.nbytes for q in eng.pager.pages]}, p.budget_bytes,
            passes=p.pass_log)
        assert {k: uni["m"][k] for k in COUNTERS} == {
            k: old["m"][k] for k in COUNTERS}


def test_kv_overlap_split_per_tick(models, rng):
    """Per tick, each stream's split holds by construction, and the tick
    metrics fold both streams into the exposed / hidden totals."""
    _jcfg, _jtree, tcfg, ttree = models
    eng = ServingEngine(tcfg, ttree, batch_slots=2, max_len=64, device="cpu",
                        plan=_half_paged(placement, ttree))
    eng.attach_paging()
    eng.attach_kv_paging(4)
    s = Scheduler(eng, prefill_chunk=8, async_io=True)
    for uid in range(3):
        s.submit(Request(uid=uid,
                         prompt=rng.integers(0, 256, 8).astype(np.int32),
                         max_new_tokens=6))
    while s.pending:
        s.tick()
        for ov in (eng.last_overlap, eng.last_kv_overlap):
            assert ov["swap_s"] == pytest.approx(ov["hidden_s"]
                                                 + ov["exposed_s"])
            assert 0.0 <= ov["hidden_s"] <= ov["window_s"] + 1e-12
    assert s.ticks > 1
    assert eng.paging_stall_s == pytest.approx(sum(s.metrics.tick_exposed_s))
    assert eng.paging_hidden_s == pytest.approx(sum(s.metrics.tick_hidden_s))
    assert eng.kv_stall_s <= eng.paging_stall_s + 1e-12
    assert eng.kv_hidden_s <= eng.paging_hidden_s + 1e-12
    _close(eng)


def test_scheduler_close_cancels_the_kv_pass(models, rng):
    _jcfg, _jtree, tcfg, ttree = models
    eng = ServingEngine(tcfg, ttree, batch_slots=2, max_len=64, device="cpu")
    eng.attach_kv_paging(4)
    s = Scheduler(eng, prefill_chunk=8, async_io=True)
    for uid in range(3):
        s.submit(Request(uid=uid,
                         prompt=rng.integers(0, 256, 6).astype(np.int32),
                         max_new_tokens=8))
    s.tick()
    s.tick()
    assert eng._inflight_kv is not None
    s.close()
    assert eng._inflight_kv is None
    assert {r.uid for r in s.run_until_done()} == {0, 1, 2}
    _close(eng)


def _preempt_run(side, models):
    """Two streams on one 1-slot tenant of a preemptive MultiScheduler: the
    global admission preempts before the tick's fences, with the tenant's
    KV pass in flight."""
    jcfg, jtree, tcfg, ttree = models
    port = side == "port"
    cfg, tree = (tcfg, ttree) if port else (jcfg, jtree)
    kw = dict(device="cpu") if port else {}
    eng = (ServingEngine if port else JEngine)(cfg, tree, batch_slots=1,
                                              max_len=64, **kw)
    pool = (paging if port else jpaging).SharedPagePool(1 << 30)
    ms = (MultiScheduler if port else JMultiScheduler)(
        pool=pool, async_io=True, preemptive=True)
    ms.add_model("a", eng, prefill_chunk=8, kv_paged=True, kv_block_rows=4)
    ms.add_stream("a", "bulk", priority=0)
    ms.add_stream("a", "urgent", priority=2)
    make = Request if port else JRequest
    rng = np.random.default_rng(5)
    ms.submit("a", make(uid=0, prompt=rng.integers(0, 256, 13)
                        .astype(np.int32), max_new_tokens=12), stream="bulk")
    done, in_flight = [], []
    for _ in range(4):
        done += ms.tick().get("a", [])
    in_flight.append(eng._inflight_kv is not None)
    ms.submit("a", make(uid=1, prompt=rng.integers(0, 256, 9)
                        .astype(np.int32), max_new_tokens=3),
              stream="urgent")
    done += ms.run_until_done().get("a", [])
    toks = {r.uid: r.generated for r in done}
    out = (toks, eng.kv_table.preempt_drops, _events(pool), in_flight,
           ms.model("a").metrics.preemptions)
    ms.close()
    return out


def test_kv_preemption_with_a_pass_in_flight(models):
    """The preempted request resumes bit-exactly, its pooled blocks drop at
    the fence of the pass in flight, and everything equals JAX's run; the
    tokens equal an unpaged run's."""
    got = _preempt_run("port", models)
    want = _preempt_run("jax", models)
    assert got == want
    toks, preempt_drops, events, in_flight, preemptions = got
    assert in_flight == [True] and preemptions == preempt_drops == 1
    assert any(e[0] == "kvdrop" for e in events)
    _jcfg, _jtree, tcfg, ttree = models
    for uid, p in ((0, 13), (1, 9)):
        eng = ServingEngine(tcfg, ttree, batch_slots=1, max_len=64,
                            device="cpu")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, 13).astype(np.int32),
                   rng.integers(0, 256, 9).astype(np.int32)]
        eng.submit(Request(uid=uid, prompt=prompts[uid],
                           max_new_tokens=(12, 3)[uid]))
        assert eng.run_until_done()[0].generated == toks[uid]


def test_attach_kv_paging_validation(models, rng):
    _jcfg, _jtree, tcfg, ttree = models
    eng = ServingEngine(tcfg, ttree, batch_slots=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="block_rows"):
        paging.KVPageTable(eng.cache["kv"], block_rows=0, device="cpu")
    eng.attach_kv_paging(4)
    assert eng.kv_table.name == "default/kv"
    with pytest.raises(ValueError, match="already"):
        eng.attach_kv_paging(4)
    _close(eng)
    eng2 = ServingEngine(tcfg, ttree, batch_slots=2, max_len=64,
                         device="cpu")
    eng2.submit(Request(uid=0, prompt=rng.integers(0, 256, 4)
                        .astype(np.int32)))
    with pytest.raises(ValueError, match="before submitting"):
        eng2.attach_kv_paging(4)
    cfg = tget("falcon-mamba-7b").smoke()
    ssm = freeze_for_serving(tfm.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu"), bits=8,
        device="cpu")
    with pytest.raises(ValueError, match="no KV cache"):
        ServingEngine(cfg, ssm, batch_slots=1, max_len=64,
                      device="cpu").attach_kv_paging(4)


def test_metrics_kv_fields(models):
    got, s, eng = _run("port", models, "canon", kv=True)
    _jgot, js, jeng = _run("jax", models, "canon", kv=True)
    doc = validate(s.metrics.summary(paging=eng.paging_summary()))
    jdoc = js.metrics.summary(paging=jeng.paging_summary())
    pg = doc["paging"]
    assert pg["kv_swaps"] == eng.kv_table.swap_count > 0
    assert pg["kv_writebacks"] == eng.kv_table.writebacks > 0
    assert pg["kv_block_rows"] == 4
    for k in ("kv_swaps", "kv_pool_hits", "kv_writebacks", "kv_dropped",
              "kv_preempt_drops", "kv_block_rows"):
        assert pg[k] == jdoc["paging"][k], k
    validate(json.loads(json.dumps(doc)))
    doc2 = validate(MetricsRecorder(clock=lambda: 0.0).summary())
    assert doc2["paging"]["kv_swaps"] == 0
