"""Port parity: the Chrome-trace ``Tracer`` (``serving/trace.py``) and the
metrics document (``serving/metrics.py``).

The port's copies are held as the reference's own unit tests hold the
reference (``tests/test_trace.py:64-172``), and a traced paged serve of the
port's ``Scheduler`` on ``device="cpu"`` must give trace and metrics
documents that pass both the port's and the JAX package's ``validate``,
stall spans that reconcile with the paging metrics, preempt / restore
instants that match the scheduler's counters, and nothing traced when no
tracer is given."""

import gc
import json
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.serving import metrics as jmetrics  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402

from repro_torch.core.placement import (packed_sizes,  # noqa: E402
                                        plan_for_budget)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402
from repro_torch.serving import (MetricsRecorder, Request,  # noqa: E402
                                 Scheduler, ServingEngine, Stopwatch, Tracer,
                                 multi_summary, validate)
from repro_torch.serving.metrics import SCHEMA, quantiles  # noqa: E402
from repro_torch.serving.trace import (doc_tracks,  # noqa: E402
                                       instant_count, span_durations)
from repro_torch.serving.trace import validate as validate_trace  # noqa: E402

CFG = ModelConfig(name="tinyT", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, remat=False)


@pytest.fixture(scope="module")
def packed():
    params = tfm.init_params(CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    return freeze_for_serving(params, bits=8, device="cpu")


def _half_paged_plan(packed):
    sizes = packed_sizes(packed)
    plan = plan_for_budget(sizes, sum(sizes.values()) // 2)
    assert plan.paged_bytes(sizes) > 0
    return plan


def _both_validate_trace(doc):
    validate_trace(doc)
    jtrace.validate(doc)


# ---------------------------------------------------------------------------
# the Tracer primitive (tests/test_trace.py:64-172)
# ---------------------------------------------------------------------------

def test_span_nesting_instants_counters_roundtrip():
    tr = Tracer()
    with tr.span("tick", track="main", tick=0):
        with tr.span("admit", track="main"):
            tr.instant("reject", track="main", uid=3)
        tr.counter("pool_bytes", track="io", bytes=4096)
    tr.complete("page", 1e-3, track="io", page=7)
    doc = json.loads(tr.to_json())          # round-trip through JSON
    _both_validate_trace(doc)
    assert doc["displayTimeUnit"] == "ms"
    assert tr.event_count == 7              # 2x(B+E) + i + C + X, no M
    assert doc_tracks(doc) == ["main", "io"] == jtrace.doc_tracks(doc)
    assert instant_count(doc, "reject") == 1
    (dur,) = span_durations(doc, "page", track="io")
    assert dur == pytest.approx(1e-3)
    assert span_durations(doc, "page", track="io") == \
        jtrace.span_durations(doc, "page", track="io")
    tick, = span_durations(doc, "tick")
    admit, = span_durations(doc, "admit")
    assert admit <= tick


def test_span_args_and_timestamps_are_relative_microseconds():
    tr = Tracer()
    with tr.span("a", track="t", uid=1) as sp:
        pass
    doc = tr.to_dict()
    ev = [e for e in doc["traceEvents"] if e["ph"] == "B"][0]
    assert ev["args"] == {"uid": 1}
    assert 0.0 <= ev["ts"] < 1e6            # relative to tracer birth
    assert sp.dur_s >= 0.0


def test_unclosed_begin_rejected():
    tr = Tracer()
    span = tr.span("open", track="main")
    span.__enter__()
    for check in (validate_trace, jtrace.validate):
        with pytest.raises(ValueError, match="unclosed"):
            check(tr.to_dict())
    span.__exit__(None, None, None)
    _both_validate_trace(tr.to_dict())


@pytest.mark.parametrize("check", [validate_trace, jtrace.validate],
                         ids=["port", "jax"])
def test_validate_rejects_malformed_docs(check):
    with pytest.raises(ValueError):
        check({})                           # no traceEvents
    base = dict(pid=0, tid=0, ts=0.0, name="x")
    with pytest.raises(ValueError, match="ph"):
        check({"traceEvents": [dict(base, ph="Q")]})
    with pytest.raises(ValueError):
        check({"traceEvents": [dict(base, ph="X", dur=-1.0)]})
    with pytest.raises(ValueError, match="backwards"):
        check({"traceEvents": [
            dict(base, ph="B", ts=5.0), dict(base, ph="E", ts=6.0),
            dict(base, ph="B", ts=1.0), dict(base, ph="E", ts=2.0)]})


def test_cross_thread_tracks_get_distinct_tids():
    tr = Tracer()

    def worker():
        tr.complete("fetch", 1e-4, track="io")

    t = threading.Thread(target=worker)
    with tr.span("tick", track="main"):
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    doc = tr.to_dict()
    _both_validate_trace(doc)
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert len(tids) == 2                   # one lane per track, not thread


def test_disabled_tracer_is_noop_and_shared_span():
    tr = Tracer(enabled=False)
    s1 = tr.span("a", track="x", big_arg=list(range(100)))
    s2 = tr.span("b")
    assert s1 is s2                         # the module-wide null span
    with s1:
        pass
    tr.instant("i")
    tr.counter("c", v=1)
    tr.complete("x", 1.0)
    assert tr.event_count == 0
    assert tr.track_names == []
    _both_validate_trace(tr.to_dict())      # an empty doc is a valid doc


def test_disabled_tracer_zero_allocation_steady_state():
    """15k span / instant / counter calls on a disabled tracer leave the
    interpreter's allocated-block count within free-list noise."""
    tr = Tracer(enabled=False)

    def one_pass(n):
        for _ in range(n):
            with tr.span("tick", track="t"):
                pass
            tr.instant("i", track="t")
            tr.counter("c", track="t", v=1)

    one_pass(100)                           # warm up caches
    gc.collect()
    before = sys.getallocatedblocks()
    one_pass(5000)
    assert sys.getallocatedblocks() - before < 16
    assert tr.event_count == 0


def test_stopwatch_brackets_and_injectable_clock():
    ticks = iter([1.0, 3.5])
    sw = Stopwatch(clock=lambda: next(ticks))
    with sw:
        pass
    assert sw.elapsed_s == pytest.approx(2.5)
    sw2 = Stopwatch()
    sw2.start()
    assert sw2.stop() >= 0.0


# ---------------------------------------------------------------------------
# the metrics document
# ---------------------------------------------------------------------------

def test_metrics_documents_pass_both_validates():
    rec = MetricsRecorder(clock=iter(np.arange(0.0, 10.0, 0.5)).__next__)
    rec.record_tick(0.004, paging_exposed_s=0.001, paging_hidden_s=0.002,
                    budget_tokens=8, budget_used=6)
    req = Request(uid=0, prompt=np.arange(3, dtype=np.int32),
                  deadline_ms=10.0, stream="gaze", priority=1)
    req.generated, req.arrival_s = [1, 2], 0.0
    req.first_token_s, req.finish_s = 0.002, 0.008
    rec.record_request(req)
    rec.record_preemption()
    rec.record_restore()
    rec.record_rejected()
    rec.record_degraded()
    doc = rec.summary()
    assert doc["schema"] == SCHEMA == jmetrics.SCHEMA
    for check in (validate, jmetrics.validate):
        check(doc)
        check(json.loads(rec.to_json()))
    assert doc["streams"]["gaze"]["missed"] == 0
    assert doc["scheduler"]["budget_utilization"] == pytest.approx(0.75)
    assert quantiles([2.0]) == jmetrics.quantiles([2.0])
    multi = multi_summary({"a": doc, "b": doc}, ticks=3)
    assert multi == jmetrics.multi_summary({"a": doc, "b": doc}, ticks=3)
    for check in (validate, jmetrics.validate):
        check(multi)
    stale = rec.summary()
    del stale["paging"]["devices"]          # a v8 payload
    for check in (validate, jmetrics.validate):
        with pytest.raises(ValueError):
            check(stale)


# ---------------------------------------------------------------------------
# the instrumented pipeline: spans reconcile with metrics
# ---------------------------------------------------------------------------

def _traced_serve(packed, rng, *, preempt=False):
    tr = Tracer()
    eng = ServingEngine(CFG, packed, batch_slots=1 if preempt else 2,
                        max_len=64, plan=_half_paged_plan(packed),
                        device="cpu")
    eng.attach_paging()
    s = Scheduler(eng, prefill_chunk=8, async_io=True,
                  preemptive=preempt, tracer=tr, trace_track="m")
    if preempt:
        s.add_stream("urgent", priority=2)
        s.submit(Request(uid=0, prompt=rng.integers(0, 256, 6)
                         .astype(np.int32), max_new_tokens=10))
        for _ in range(4):
            s.tick()
        s.submit(Request(uid=1, prompt=rng.integers(0, 256, 5)
                         .astype(np.int32), max_new_tokens=3),
                 stream="urgent")
    else:
        for uid in range(3):
            s.submit(Request(uid=uid, prompt=rng.integers(0, 256, 6 + uid)
                             .astype(np.int32), max_new_tokens=5))
    s.run_until_done()
    doc = tr.to_dict()
    _both_validate_trace(doc)
    eng.pager.close()
    return tr, doc, s, eng


def test_traced_run_phases_and_io_spans(packed, rng):
    tr, doc, s, eng = _traced_serve(packed, rng)
    for name in ("fence", "admit", "compute"):
        assert len(span_durations(doc, name, track="m")) == s.ticks, name
    assert (s.ticks - 1 <= len(span_durations(doc, "begin", track="m"))
            <= s.ticks)
    pages = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "page"]
    assert len(pages) == eng.swap_count
    assert all(set(e["args"]) >= {"nbytes", "wire_nbytes", "encoding"}
               for e in pages)
    assert instant_count(doc, "begin_pass", track="m") > 0
    assert sum(span_durations(doc, "compute", track="m")) > 0.0


def test_trace_reconciles_with_paging_metrics(packed, rng):
    """Summed stall-span durations equal the exposed / hidden stall the same
    run's metrics recorded, within 10%, and both documents pass both
    packages' ``validate``."""
    tr, doc, s, eng = _traced_serve(packed, rng)
    summary = s.metrics.summary(paging=eng.paging_summary(),
                                trace=s.trace_summary(),
                                faults=s.faults_summary())
    for check in (validate, jmetrics.validate):
        check(summary)
        check(json.loads(json.dumps(summary)))
    pg = summary["paging"]
    span_exposed = sum(span_durations(doc, "exposed:weights",
                                      track="m:stall"))
    span_hidden = sum(span_durations(doc, "hidden:weights",
                                     track="m:stall"))
    assert span_exposed == pytest.approx(pg["exposed_s"], rel=0.10)
    assert span_hidden == pytest.approx(pg["hidden_s"], rel=0.10)
    assert "m (predicted)" in doc_tracks(doc)
    preds = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "stall(pred)"]
    assert preds and all(
        set(e["args"]) >= {"predicted_exposed_ms", "measured_exposed_ms",
                           "predicted_swaps_per_pass"} for e in preds)
    ts = s.trace_summary()
    assert ts["events"] == tr.event_count > 0
    assert ts["predicted_vs_measured_stall_ratio"] >= 0.0


def test_preempt_restore_instants_match_scheduler_counters(packed, rng):
    tr, doc, s, eng = _traced_serve(packed, rng, preempt=True)
    assert s.metrics.preemptions >= 1
    assert instant_count(doc, "preempt", track="m") == s.metrics.preemptions
    assert instant_count(doc, "restore", track="m") == s.metrics.restores
    assert instant_count(doc, "admit", track="m") >= 2  # both requests


def test_untraced_scheduler_stays_untraced(packed, rng):
    eng = ServingEngine(CFG, packed, batch_slots=2, max_len=64,
                        plan=_half_paged_plan(packed), device="cpu")
    eng.attach_paging()
    s = Scheduler(eng, prefill_chunk=8)
    assert s.tracer is None and eng.tracer is None
    assert eng.pager.tracer is None
    s.submit(Request(uid=0, prompt=rng.integers(0, 256, 6)
                     .astype(np.int32), max_new_tokens=3))
    s.run_until_done()
    ts = s.trace_summary()
    assert ts["events"] == 0 and ts["tracks"] == []
    # the predicted-vs-measured drift is tracked without a tracer
    assert ts["predicted_vs_measured_stall_ratio"] > 0.0
    eng.pager.close()


def test_faults_and_retries_are_instants_on_the_io_track(packed, rng):
    from repro_torch.core.faults import FaultPlan

    tr = Tracer()
    eng = ServingEngine(CFG, packed, batch_slots=2, max_len=64,
                        plan=_half_paged_plan(packed), device="cpu")
    eng.attach_paging(faults=FaultPlan(seed=3, fail_rate=0.3,
                                       bitflip_rate=0.3, backoff_s=1e-5,
                                       backoff_cap_s=1e-4))
    s = Scheduler(eng, prefill_chunk=8, tracer=tr)
    s.submit(Request(uid=0, prompt=rng.integers(0, 256, 6)
                     .astype(np.int32), max_new_tokens=4))
    s.run_until_done()
    eng.pager.close()
    doc = tr.to_dict()
    _both_validate_trace(doc)
    fc = s.faults_summary()
    assert fc["injected"] > 0
    assert instant_count(doc, "fault", track="io") == fc["injected"]
    assert instant_count(doc, "retry", track="io") == fc["retries"]
