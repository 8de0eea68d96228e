"""Port parity: multi-model tenancy (``serving/tenancy.MultiScheduler``)
over one ``SharedPagePool``.

Two tiny dense tenants (``tinyA`` / ``tinyB`` of ``tests/test_tenancy.py``),
weights initialised in JAX and carried across with ``interop``, served by
the JAX package's ``MultiScheduler`` (``mode="xla"``) and the port's
(``device="cpu"``) at temperature 0: each tenant's tokens must equal its
solo run on a private pager and JAX's, the pool's event log and counters
must equal JAX's and the ``shared_pass_counters`` / ``kv_pass_counters``
replays, and the metrics v9 multi document must equal JAX's on every field
not read from a wall clock."""

import json
import os
import sys
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from benchmarks.serving_load import _tenant_reqs  # noqa: E402

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
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (MultiScheduler, Request,  # noqa: E402
                                 Scheduler, ServingEngine, validate)

CFGS = {"a": dict(name="tinyA", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, remat=False),
        "b": dict(name="tinyB", family="dense", n_layers=2, d_model=48,
                  n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
                  head_dim=12, remat=False)}
COUNTERS = ("swaps", "misses", "pool_hits", "evicted")
# the metrics sections read from the wall clock (the tenants' own clock is
# perf_counter here) or from host timings; everything else must be equal
WALL = ("ticks", "throughput", "trace")
WALL_KEYS = ("exposed_s", "hidden_s", "overlap_frac", "stall_s",
             "kv_exposed_s", "kv_hidden_s", "ttft_ms", "latency_ms",
             "wall_s", "tok_per_s", "paging_exposed_s", "paging_hidden_s",
             "decode_s", "crc_s", "copy_s", "p99_ttft_ms")


@pytest.fixture(scope="module")
def models():
    """{tenant: (JAX cfg, JAX packed tree, port cfg, port packed tree)}."""
    out = {}
    for seed, (name, kw) in enumerate(CFGS.items()):
        jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
        packed = jfreeze(jtfm.init_params(jcfg, jax.random.PRNGKey(seed)),
                         bits=8)
        out[name] = (jcfg, packed, tcfg, interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, packed), tcfg, device="cpu"))
    return out


def _half_paged(pl, tree):
    sizes = pl.packed_sizes(tree)
    plan = pl.plan_for_budget(sizes, sum(sizes.values()) // 2)
    assert plan.paged_bytes(sizes) > 0
    return plan


def _cold(pl, tree):
    return _half_paged(pl, tree).paged_bytes(pl.packed_sizes(tree))


def _prompts(n=4):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, 3 + 4 * i).astype(np.int32)
            for i in range(n)]


def _side(side, models, name):
    jcfg, jtree, tcfg, ttree = models[name]
    port = side == "port"
    return (port, tcfg if port else jcfg, ttree if port else jtree,
            placement if port else jplacement)


def _engine(side, models, name, plan=True, slots=2):
    port, cfg, tree, pl = _side(side, models, name)
    kw = dict(device="cpu") if port else {}
    return (ServingEngine if port else JEngine)(
        cfg, tree, batch_slots=slots, max_len=64, seed=0 if name == "a"
        else 1, plan=_half_paged(pl, tree) if plan else None, **kw)


def _solo(side, models, name, prompts, max_new, kv=False):
    port = side == "port"
    eng = _engine(side, models, name)
    eng.attach_paging()
    if kv:
        eng.attach_kv_paging(4)
    s = (Scheduler if port else JScheduler)(eng, prefill_chunk=8)
    for uid, p in enumerate(prompts):
        s.submit((Request if port else JRequest)(uid=uid, prompt=p,
                                                 max_new_tokens=max_new))
    out = {r.uid: r.generated for r in s.run_until_done()}
    eng.pager.close()
    if eng.kv_table is not None:
        eng.kv_table.close()
    return out


def _tenants(side, models, budget, prompts, max_new=5, kv=False,
             async_io=True):
    """Both tenants under one MultiScheduler and one pool budget; the
    scheduler is closed by the caller."""
    port = side == "port"
    pool = (paging if port else jpaging).SharedPagePool(budget)
    ms = (MultiScheduler if port else JMultiScheduler)(pool=pool,
                                                      async_io=async_io)
    for name in ("a", "b"):
        ms.add_model(name, _engine(side, models, name), prefill_chunk=8,
                     kv_paged=kv, kv_block_rows=4)
    make = Request if port else JRequest
    for uid, p in enumerate(prompts):
        for name in ("a", "b"):
            ms.submit(name, make(uid=uid, prompt=p, max_new_tokens=max_new))
    done = ms.run_until_done()
    return ms, {n: {r.uid: r.generated for r in rs} for n, rs in done.items()}


def _budget(kind, models):
    if kind == "roomy":
        return 1 << 30
    cold = sum(_cold(placement, models[n][3]) for n in ("a", "b"))
    return int(cold * 0.6) if kind == "tight" else max(cold // 2, 1)


def _events(pool):
    return [tuple((kind, m, tuple(tuple(x) if isinstance(x, tuple) else x
                                  for x in rest[0])) if rest else
                  (kind, m)) for kind, m, *rest in pool.events]


def _strip(doc):
    """A metrics document without its wall-clock readings."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in WALL and k not in WALL_KEYS}
    return doc


def _replay(ms, bytes_, kv):
    """The pool's counters predicted from its own log (KV) or pass order."""
    sizes = {n: paging.page_sizes(ms.model(n).engine.pager.pages)
             for n in ("a", "b")}
    if kv:
        return paging.kv_pass_counters(sizes, bytes_, ms.pool.events)
    return paging.shared_pass_counters(sizes, bytes_, passes=ms.pass_log)


def _counters(ms):
    return {m: {k: c[k] for k in COUNTERS}
            for m, c in ms.pool.summary()["models"].items()}


POOL_TOTALS = ("live_bytes", "live_wire_bytes", "cached_pages", "evictions",
               "bytes_streamed_wire", "bytes_streamed_raw")


@pytest.mark.parametrize("kv,budget", [(False, "roomy"), (False, "tight"),
                                       (True, "kv-tight")])
def test_tenants_bit_exact_and_counters_equal_jax(models, kv, budget):
    """Each tenant's tokens equal its solo run and JAX's MultiScheduler's;
    the pool's log equals JAX's event for event; every member's counters
    and streamed bytes equal JAX's and the replay.

    Under KV paging the overlapped (async) log is not compared with JAX's:
    the reference drops a retired slot's pooled blocks on the calling
    thread while another tenant's pass may still run on the fetch worker,
    so its async log depends on the worker's timing (ROADMAP C8).  The
    port drops them on the pool's worker, after every fetch queued before
    them, which fixes its async log (held against a slowed worker by
    ``test_kv_drop_log_independent_of_fetch_worker_timing``).  That log is
    still not the sync one: the async tick begins every tenant's next pass
    before this tick's compute, so passes and KV batches reach the pool in
    another order.  So there the port's sync log equals JAX's sync log
    event for event, with every counter, and the port's async counters
    equal the replay of its own log."""
    prompts = _prompts(3 if kv else 4)
    max_new = 4 if kv else 5
    bytes_ = _budget(budget, models)
    ms, got = _tenants("port", models, bytes_, prompts, max_new, kv=kv)
    jms, jgot = _tenants("jax", models, bytes_, prompts, max_new, kv=kv)
    for name in ("a", "b"):
        solo = _solo("port", models, name, prompts, max_new, kv=kv)
        assert got[name] == solo == jgot[name], name
    assert ms.pass_log == jms.pass_log
    pred = _replay(ms, bytes_, kv)
    assert set(_counters(ms)) == set(pred)
    for m, c in ms.pool.summary()["models"].items():
        assert {k: c[k] for k in COUNTERS} == {
            k: pred[m][k] for k in COUNTERS}, m
        assert (c["bytes_streamed_wire"], c["bytes_streamed_raw"]) == (
            pred[m]["bytes_wire"], pred[m]["bytes_raw"])
    if kv:
        sms, sgot = _tenants("port", models, bytes_, prompts, max_new,
                             kv=kv, async_io=False)
        jsms, jsgot = _tenants("jax", models, bytes_, prompts, max_new,
                               kv=kv, async_io=False)
        assert sgot == got == jsgot
        assert sms.pass_log == jsms.pass_log
        pairs = [(sms, jsms)]
        spred = _replay(sms, bytes_, kv)
        assert _counters(sms) == {m: {k: spred[m][k] for k in COUNTERS}
                                  for m in spred}
    else:
        jpred = jpaging.shared_pass_counters(
            {n: jpaging.page_sizes(jms.model(n).engine.pager.pages)
             for n in ("a", "b")}, bytes_, passes=jms.pass_log)
        assert pred == jpred
        pairs = [(ms, jms)]
    for port_ms, jax_ms in pairs:
        assert _events(port_ms.pool) == _events(jax_ms.pool)
        assert _counters(port_ms) == _counters(jax_ms)
        summ, jsumm = port_ms.pool.summary(), jax_ms.pool.summary()
        for k in POOL_TOTALS:
            assert summ[k] == jsumm[k], k
    summ = ms.pool.summary()
    if budget == "roomy":
        assert summ["evictions"] == 0
        assert summ["models"]["a"]["swaps"] == len(
            ms.model("a").engine.pager.pages)
    else:
        assert summ["evictions"] > 0
        assert summ["live_bytes"] <= bytes_
    if kv:
        assert validate(ms.summary())["models"]["a"]["paging"][
            "kv_swaps"] > 0
        for port_ms, jax_ms in pairs:
            port_ms.close()
            jax_ms.close()
    ms.close()
    jms.close()


@pytest.mark.parametrize("delay_s", [0.02, 0.05])
def test_kv_drop_log_independent_of_fetch_worker_timing(models, monkeypatch,
                                                        delay_s):
    """The kv-tight tenancy's pool log and counters do not move when every
    page and KV block fetch sleeps first: the pooled KV drops run on the
    pool's fetch worker, ordered after every fetch queued before them
    (ROADMAP C8)."""
    prompts, bytes_ = _prompts(3), _budget("kv-tight", models)
    ms, got = _tenants("port", models, bytes_, prompts, 4, kv=True)
    log, counters = _events(ms.pool), _counters(ms)
    ms.close()
    assert any(kind == "kvdrop" for kind, *_ in log)

    def slowed(fetch):
        def run(*args, **kw):
            time.sleep(delay_s)
            return fetch(*args, **kw)
        return run

    monkeypatch.setattr(paging.HostPagedStore, "_fetch_page",
                        slowed(paging.HostPagedStore._fetch_page))
    monkeypatch.setattr(paging.KVPageTable, "_fetch_block",
                        slowed(paging.KVPageTable._fetch_block))
    sms, sgot = _tenants("port", models, bytes_, prompts, 4, kv=True)
    assert sgot == got
    assert _events(sms.pool) == log
    assert _counters(sms) == counters
    sms.close()


def test_pool_refuses_a_private_pager_and_duplicates(models):
    eng = _engine("port", models, "a", slots=1)
    eng.attach_paging()
    ms = MultiScheduler(shared_budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="private pager"):
        ms.add_model("a", eng)
    eng.pager.close()
    eng_kv = _engine("port", models, "a", plan=False, slots=1)
    eng_kv.attach_kv_paging(4)
    with pytest.raises(ValueError, match="privately"):
        ms.add_model("a", eng_kv)
    eng_kv.kv_table.close()
    eng2 = _engine("port", models, "a", slots=1)
    ms.add_model("a", eng2)
    with pytest.raises(ValueError, match="already registered"):
        ms.add_model("a", eng2)
    with pytest.raises(ValueError, match="already joined"):
        ms.pool.register("a", eng2.pager)
    with pytest.raises(ValueError, match="not both"):
        MultiScheduler(pool=ms.pool, shared_budget_bytes=1)
    with pytest.raises(ValueError, match="budget_bytes"):
        paging.SharedPagePool(0)
    ms.close()


def test_fully_resident_tenant_skips_paging(models):
    p = np.random.default_rng(3).integers(0, 256, 5).astype(np.int32)
    out = {}
    for side in ("port", "jax"):
        port = side == "port"
        ms = (MultiScheduler if port else JMultiScheduler)(
            shared_budget_bytes=1 << 20)
        res = _engine(side, models, "a", plan=False, slots=1)
        paged = _engine(side, models, "b", slots=1)
        ms.add_model("res", res)
        ms.add_model("paged", paged)
        assert res.pager is None and paged.pager is not None
        make = Request if port else JRequest
        ms.submit("res", make(uid=0, prompt=p, max_new_tokens=2))
        ms.submit("paged", make(uid=0, prompt=p, max_new_tokens=2))
        done = ms.run_until_done()
        assert ms.pass_log and all(m == "paged" for m in ms.pass_log)
        out[side] = ({n: [r.generated for r in rs]
                      for n, rs in done.items()}, ms.pass_log)
        ms.close()
    assert out["port"] == out["jax"]


def test_global_edf_admission_order_equals_jax(models):
    orders = []
    for side in ("port", "jax"):
        port = side == "port"
        clock = [0.0]
        ms = (MultiScheduler if port else JMultiScheduler)(
            clock=lambda: clock[0])
        ms.add_model("a", _engine(side, models, "a", plan=False, slots=1))
        ms.add_model("b", _engine(side, models, "b", plan=False, slots=1))
        ms.add_stream("a", "assistant", priority=0)
        ms.add_stream("b", "tracker", priority=2, deadline_ms=50.0)
        make = Request if port else JRequest
        p = np.arange(4, dtype=np.int32)
        ms.submit("a", make(uid=0, prompt=p), stream="assistant")
        ms.submit("b", make(uid=1, prompt=p), stream="tracker")
        ms.submit("b", make(uid=2, prompt=p, deadline_ms=5.0, priority=2),
                  stream="tracker")
        ms.submit("a", make(uid=3, prompt=p, priority=1), stream="assistant")
        orders.append([(m, r.uid, r.seq) for m, r in ms.admission_order()])
        ms.close()
    assert orders[0] == orders[1]
    assert [(m, u) for m, u, _s in orders[0]] == [
        ("b", 2), ("b", 1), ("a", 3), ("a", 0)]
    # one submission sequence across the tenants
    assert sorted(s for _m, _u, s in orders[0]) == [0, 1, 2, 3]


def test_global_admission_survives_duplicate_uids(models):
    ms = MultiScheduler()
    ms.add_model("a", _engine("port", models, "a", plan=False, slots=1))
    rng = np.random.default_rng(4)
    for _ in range(2):
        ms.submit("a", Request(uid=0, prompt=rng.integers(0, 256, 3)
                               .astype(np.int32), max_new_tokens=2))
    assert len(ms.run_until_done()["a"]) == 2
    ms.close()


@pytest.mark.parametrize("pages,budget,ticks", [
    ({"small": [40, 40], "huge": [200]}, 100, 2),           # never fits
    ({"a": [100, 100, 100], "b": [80, 80]}, 10_000, 3),     # roomy
    ({"a": [100, 100], "b": [100]}, 50, 2),                 # starved
    ({"a": [(100, 60, 400)] * 3, "b": [(80, 30, 320)] * 2}, 250, 4)])
def test_shared_pass_counters_equal_jax(pages, budget, ticks):
    got = paging.shared_pass_counters(pages, budget, ticks=ticks)
    assert got == jpaging.shared_pass_counters(pages, budget, ticks=ticks)
    if "huge" in pages:
        # 'small' keeps its pool hits; 'huge' never evicts anyone
        assert got["small"] == dict(swaps=2, misses=2, pool_hits=2,
                                    evicted=0, bytes_wire=80, bytes_raw=80)
        assert got["huge"]["evicted"] == got["small"]["evicted"] == 0


def test_a_page_that_never_fits_flushes_no_cotenant():
    pool = paging.SharedPagePool(100)

    class _Stub:
        pages = []
        swap_count = miss_count = 0

        def close(self, wait=True):
            pass
    pool.register("small", _Stub())
    pool.register("huge", _Stub())
    pool.admit("small", 0, 40, {})
    pool.admit("small", 1, 40, {})
    pool.admit("huge", 0, 200, {})          # never fits: no eviction
    assert pool.live_bytes == 80
    assert pool.lookup("small", 0) is not None
    assert pool.counters["small"]["evicted"] == 0
    pool.admit("huge", 1, 60, {})           # fits after evicting 'small'
    assert pool.counters["small"]["evicted"] == 1 and pool.live_bytes == 100
    assert pool.invalidate("huge", 1) and not pool.invalidate("huge", 1)
    assert pool.counters["huge"]["evicted"] == 0
    pool.close()


def test_pool_ledger_holds_under_concurrent_members():
    """Members look up, admit and invalidate from more threads than cores
    with a short switch interval: the byte ledger stays the sum of the
    cached pages and within the budget, and no pool hit is lost."""
    pool = paging.SharedPagePool(10_000)

    class _Stub:
        pages = []
        swap_count = miss_count = 0

        def close(self, wait=True):
            pass
    n = (os.cpu_count() or 2) + 2
    for i in range(n):
        pool.register(f"m{i}", _Stub())
    hits = [0] * n

    def work(i):
        for k in range(300):
            if pool.lookup(f"m{i}", k % 7) is not None:
                hits[i] += 1
            else:
                pool.admit(f"m{i}", k % 7, 100 + 50 * (k % 3), {})
            if k % 11 == 0:
                pool.invalidate(f"m{i}", (k + 3) % 7)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert pool.live_bytes == sum(
        e[0] for e in pool._cache.values()) <= pool.budget_bytes
    assert [pool.counters[f"m{i}"]["pool_hits"] for i in range(n)] == hits
    assert sum(hits) > 0
    pool.close()


def test_multi_metrics_document_equals_jax(models):
    prompts = _prompts(2)
    bytes_ = _budget("tight", models)
    docs = {}
    for side in ("port", "jax"):
        ms, done = _tenants(side, models, bytes_, prompts, max_new=3)
        doc = ms.summary()
        if side == "port":
            doc = validate(doc)
            assert set(doc["models"]) == {"a", "b"}
            for m in ("a", "b"):
                assert doc["models"][m]["requests"]["count"] == len(prompts)
                assert doc["models"][m]["paging"]["swap_count"] > 0
                assert doc["shared_pool"]["models"][m]["n_pages"] >= 1
            assert doc["totals"]["requests"] == 2 * len(prompts)
            assert doc["totals"]["tokens_out"] == sum(
                len(t) for ts in done.values() for t in ts.values())
            assert doc["ticks"]["count"] == ms.ticks
            json.loads(ms.to_json())
        docs[side] = _strip(doc)
        ms.close()
    assert docs["port"] == docs["jax"]


def test_close_cancels_inflight_kv_passes(models):
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (6, 10, 14)]
    engs = {n: _engine("port", models, n) for n in ("a", "b")}
    ms = MultiScheduler(pool=paging.SharedPagePool(1 << 30), async_io=True)
    for n, eng in engs.items():
        ms.add_model(n, eng, prefill_chunk=8, kv_paged=True)
    for uid, p in enumerate(prompts):
        for n in engs:
            ms.submit(n, Request(uid=uid, prompt=p, max_new_tokens=8))
    ms.tick()
    ms.tick()
    assert any(e._inflight_kv is not None for e in engs.values())
    ms.close()
    assert all(e._inflight_kv is None and e._inflight_pass is None
               for e in engs.values())
    assert not ms.pool._active_fetch


def test_run_for_and_write(models, tmp_path):
    ms = MultiScheduler(shared_budget_bytes=_budget("roomy", models))
    ms.add_model("a", _engine("port", models, "a", slots=1))
    ms.submit("a", Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=2))
    assert [r.uid for r in ms.run_for(60.0)["a"]] == [0]
    path = tmp_path / "multi.json"
    ms.write(str(path), note="x")
    doc = validate(json.loads(path.read_text()))
    assert doc["note"] == "x" and doc["shared_pool"]["budget_bytes"] == 1 << 30
    ms.close()


def test_chip_smoke_tenant_requests_equal_the_bench():
    """``chip_smoke.tenant_reqs`` (phase 8's traffic) is the bench's
    ``_tenant_reqs`` at its defaults, tenant by tenant."""
    for salt, name in enumerate(cs.TENANTS):
        vocab = tget(name).vocab_size
        args = types.SimpleNamespace(seed=cs.TENANCY["seed"], requests=8,
                                     max_len=cs.TENANCY["max_len"],
                                     max_new=cs.TENANCY["max_new"])
        want = _tenant_reqs(types.SimpleNamespace(vocab_size=vocab), args,
                            salt)
        got = cs.tenant_reqs(Request, vocab, 8, salt)
        assert [(r.uid, r.prompt.tolist(), r.max_new_tokens)
                for r in got] == [(r.uid, r.prompt.tolist(),
                                   r.max_new_tokens) for r in want]
