"""Port parity: the deadline-aware scheduler (``serving/sched.py``).

The XR traffic of ``benchmarks/serving_load.py`` goes through the JAX
package's ``Scheduler`` and the port's (``device="cpu"``) on the bench's
virtual clock, driven by the same loop (``chip_smoke.serve_xr``, whose copy
of the traffic is held against the bench's here).  Per uid, the greedy
tokens and the decisions (arrival, admission, first-token and finish times,
preemptions, rejections, degradations, ``max_new_tokens``), the scheduler's
counters and the metrics document's virtual-clock sections must be equal:
on the tiny dense config of ``tests/test_serving_sched.py``, on the
falcon-mamba-7b smoke config (bucketed SSM chunks), under ``"degrade"``
admission, and from a paged store with the overlapped and the synchronous
tick.  The JAX side runs ``mode="xla"``; its weights are exported through
``interop``."""

import types

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from benchmarks.serving_load import _xr_traffic  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import validate as jvalidate  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import faults, paging, placement  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (Request, Scheduler,  # noqa: E402
                                 ServingEngine, validate)

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, remat=False)
FAST = dict(backoff_s=1e-5, backoff_cap_s=1e-4)     # tests/test_faults.py:32
# the metrics sections measured on the scheduler's (virtual) clock; the
# paging seconds, the trace and the faults are wall-clock or store state
VIRTUAL = ("requests", "deadlines", "scheduler", "throughput", "streams")


@pytest.fixture(scope="module")
def models():
    """{kind: (JAX cfg, JAX packed tree, port cfg, port packed tree)}."""
    out = {}
    for kind, jcfg, tcfg in (
            ("dense", JModelConfig(**TINY), ModelConfig(**TINY)),
            ("ssm", get_config("falcon-mamba-7b").smoke(),
             tget("falcon-mamba-7b").smoke())):
        packed = jfreeze(jtfm.init_params(jcfg, jax.random.PRNGKey(0)),
                         bits=8)
        tpacked = interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, packed), tcfg, device="cpu")
        out[kind] = (jcfg, packed, tcfg, tpacked)
    return out


def _half_paged(pl, sizes):
    plan = pl.plan_for_budget(sizes, sum(sizes.values()) // 2)
    assert plan.paged_bytes(sizes) > 0
    return plan


def _serve(side, models, kind, continuous, n_requests, paged=False,
           **sched_kw):
    """One XR leg on the virtual clock: (tokens, decision record, metrics
    document, scheduler, engine)."""
    jcfg, jpacked, tcfg, tpacked = models[kind]
    port = side == "port"
    cfg, tree = (tcfg, tpacked) if port else (jcfg, jpacked)
    make_request = Request if port else JRequest
    kw = dict(batch_slots=cs.XR["slots"], max_len=cs.XR["max_len"],
              seed=cs.XR["seed"])
    if port:
        kw["device"] = "cpu"
    if paged:
        pl = placement if port else jplacement
        kw["plan"] = _half_paged(pl, pl.packed_sizes(tree))
    eng = (ServingEngine if port else JEngine)(cfg, tree, **kw)
    if paged:
        eng.attach_paging()
    clock = cs.VirtualClock()
    sched = cs.xr_scheduler(Scheduler if port else JScheduler, eng, clock,
                            continuous, **sched_kw)
    events = cs.xr_traffic(make_request, cfg.vocab_size, n_requests)
    done, admitted = cs.serve_xr(sched, clock, events)
    doc = sched.metrics.summary(paging=eng.paging_summary(),
                                trace=sched.trace_summary(),
                                faults=sched.faults_summary())
    if eng.pager is not None:
        eng.pager.close()
    return ({r.uid: r.generated for r in done},
            cs.xr_record(sched, done, admitted), doc, sched, eng)


_RUNS = {}


def _both(models, kind, continuous, n_requests, **kw):
    """The JAX and the port run of one leg, each run once a module."""
    key = (kind, continuous, n_requests, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = tuple(_serve(side, models, kind, continuous,
                                  n_requests, **kw)
                           for side in ("jax", "port"))
    return _RUNS[key]


def _virtual(doc):
    out = {k: doc[k] for k in VIRTUAL}
    out["ticks"] = {k: doc["ticks"][k] for k in ("count", "latency_ms")}
    return out


def _assert_same_run(jrun, trun):
    jtoks, jrec, jdoc, _js, _je = jrun
    ttoks, trec, tdoc, _ts, _te = trun
    assert ttoks == jtoks
    assert trec == jrec
    assert _virtual(tdoc) == _virtual(jdoc)
    for check in (validate, jvalidate):
        check(tdoc)
        check(jdoc)


def test_xr_traffic_is_the_benchs():
    """``chip_smoke.xr_traffic`` is a copy of the bench's ``_xr_traffic``."""
    args = types.SimpleNamespace(seed=cs.XR["seed"], xr_requests=60,
                                 xr_assist_new=cs.XR["assist_new"],
                                 xr_period_ms=cs.XR["period_ms"])
    bench = _xr_traffic(types.SimpleNamespace(vocab_size=256), args)
    ours = cs.xr_traffic(JRequest, 256, 60)
    assert len(ours) == len(bench) == 60
    for (t0, s0, r0), (t1, s1, r1) in zip(bench, ours):
        assert (t0, s0, r0.uid, r0.max_new_tokens) == (t1, s1, r1.uid,
                                                       r1.max_new_tokens)
        np.testing.assert_array_equal(r0.prompt, r1.prompt)


def test_edf_with_priority_admission_order(models):
    """The case of ``tests/test_serving_sched.py:43-60``, on both."""
    orders = {}
    for side in ("jax", "port"):
        jcfg, jpacked, tcfg, tpacked = models["dense"]
        if side == "port":
            s = Scheduler(ServingEngine(tcfg, tpacked, batch_slots=1,
                                        max_len=64, device="cpu"))
            make = Request
        else:
            s = JScheduler(JEngine(jcfg, jpacked, batch_slots=1, max_len=64))
            make = JRequest
        s.add_stream("hand", priority=2, deadline_ms=50.0)
        s.add_stream("gaze", priority=2, deadline_ms=10.0)
        s.add_stream("bg", priority=0)
        p = np.arange(4, dtype=np.int32)
        s.submit(make(uid=0, prompt=p), stream="bg")
        s.submit(make(uid=1, prompt=p), stream="hand")
        s.submit(make(uid=2, prompt=p), stream="gaze")
        s.submit(make(uid=3, prompt=p, deadline_ms=5.0, priority=2),
                 stream="hand")
        orders[side] = [r.uid for r in s.admission_order()]
        by_uid = {r.uid: r for r in s.queue}
        assert by_uid[1].deadline_ms == 50.0 and by_uid[1].priority == 2
        assert by_uid[3].deadline_ms == 5.0
        assert by_uid[0].deadline_ms is None
        assert [r.seq for r in s.queue] == [0, 1, 2, 3]
    assert orders["port"] == orders["jax"] == [3, 2, 1, 0]


@pytest.mark.parametrize("kind,n_requests", [("dense", 60), ("ssm", 12)])
@pytest.mark.parametrize("continuous", [False, True])
def test_xr_leg_matches_jax(models, kind, n_requests, continuous):
    jrun, trun = _both(models, kind, continuous, n_requests)
    _assert_same_run(jrun, trun)
    if continuous:
        assert trun[1]["counters"]["preemptions"] > 0
        assert trun[1]["counters"]["restores"] == \
            trun[1]["counters"]["preemptions"]


def test_xr_gate_holds_on_the_port(models):
    """The bench's gate (``serving_load.py:385-417``) over the port's two
    legs: the same tokens per uid, trackers' miss rate <= 0.05, the
    assistant's tok/s >= 0.90 of the baseline's, and a preemption."""
    base = _both(models, "dense", False, 60)[1]
    cont = _both(models, "dense", True, 60)[1]
    assert base[0] == cont[0]

    def run(r):
        return dict(sched=r[3], doc=r[2])
    miss, ratio = cs.xr_gate(run(base), run(cont))
    assert miss <= cs.XR_GATE["miss_rate"]
    assert ratio >= cs.XR_GATE["assistant_tok_ratio"]
    assert cont[2]["scheduler"]["preemptions"] > 0


def test_degrade_cuts_the_same_max_new_tokens(models):
    """``admission="degrade"`` with a 6 ms tick estimate: the same requests
    are cut to the same ``max_new_tokens`` (and the same rejected)."""
    jrun, trun = _both(models, "dense", True, 24, admission="degrade",
                       est_tick_s=6e-3)
    _assert_same_run(jrun, trun)
    counters = trun[1]["counters"]
    assert counters["degraded"] > 0
    # only the trackers carry deadlines: cut from 2 new tokens to 1
    degraded = [r for r in trun[1]["per_uid"].values() if r["degraded"]]
    assert degraded and all(r["max_new_tokens"] == 1 for r in degraded)


@pytest.mark.parametrize("async_io", [True, False])
def test_paged_leg_matches_jax_on_the_pass_counters(models, async_io):
    """A half-paged ``plan_for_budget`` store under the continuous leg:
    the same tokens, decisions and swap / miss counts as JAX, on
    ``ticks x pass_counters`` despite preemption, overlapped or not."""
    jrun, trun = _both(models, "dense", True, 24, paged=True,
                       async_io=async_io)
    _assert_same_run(jrun, trun)
    eng, sched = trun[4], trun[3]
    per_pass = paging.pass_counters(len(eng.pager.pages),
                                    eng.page_resident_slots)
    assert (eng.swap_count, eng.miss_count) == (
        sched.ticks * per_pass["swaps"], sched.ticks * per_pass["misses"])
    assert (eng.swap_count, eng.miss_count) == (jrun[4].swap_count,
                                                jrun[4].miss_count)
    assert trun[2]["paging"]["n_pages"] == jrun[2]["paging"]["n_pages"]
    if async_io:
        assert trun[2]["paging"]["hidden_s"] > 0.0
    else:
        assert trun[2]["paging"]["hidden_s"] == 0.0
    # the overlapped and the synchronous tick serve the same tokens
    other = _both(models, "dense", True, 24, paged=True,
                  async_io=not async_io)[1]
    assert other[0] == trun[0] and other[1] == trun[1]


def test_fetch_timeout_defers_a_tick_and_resumes_its_pass(models):
    """A page that hangs on every fetch under a 5 ms fetch deadline: each
    fence that times out defers its tick (no compute, no counters), the
    next fence resumes the same pass, and the tokens are JAX's unstuck
    ones (the scheduler half of ``tests/test_faults.py:243``)."""
    jcfg, jpacked, tcfg, tpacked = models["dense"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (6, 9, 12)]

    def run(port, **kw):
        pl = placement if port else jplacement
        tree = tpacked if port else jpacked
        plan = _half_paged(pl, pl.packed_sizes(tree))
        if port:
            eng = ServingEngine(tcfg, tree, batch_slots=2, max_len=64,
                                plan=plan, device="cpu")
        else:
            eng = JEngine(jcfg, tree, batch_slots=2, max_len=64, plan=plan)
        eng.attach_paging(faults=kw.pop("faults", None))
        s = (Scheduler if port else JScheduler)(eng, prefill_chunk=8, **kw)
        for uid, p in enumerate(prompts):
            s.submit((Request if port else JRequest)(
                uid=uid, prompt=p, max_new_tokens=4))
        done = {r.uid: r.generated for r in s.run_until_done()}
        s.close()
        eng.pager.close()
        return done, s, eng

    expect, _s, _e = run(False)
    stuck = faults.FaultPlan(seed=0, stuck_pages=(("default", 0),),
                             stuck_s=0.05, **FAST)
    got, s, eng = run(True, faults=stuck, fetch_timeout_s=0.005)
    assert got == expect
    fs = s.faults_summary()
    assert fs["deferred_ticks"] > 0
    assert fs["fetch_timeouts"] == fs["deferred_ticks"] == s.deferred_ticks
    per_pass = paging.pass_counters(len(eng.pager.pages),
                                    eng.page_resident_slots)
    assert eng.swap_count == s.ticks * per_pass["swaps"]
    assert eng.miss_count == s.ticks * per_pass["misses"]
    assert s.metrics.summary()["ticks"]["count"] == s.ticks
