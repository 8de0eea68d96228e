"""Serving metrics, the observability half of the XR serving scheduler
(reference: ``repro/serving/metrics.py``, copied: it uses only the stdlib
and numpy).

The paper's system claim is a latency bound: the heterogeneous XR workload
must finish inside the 10-20 ms frame budget.  So the serving runtime
records per-request time-to-first-token and end-to-end latency, per-tick
latency, paging stalls split into *exposed* wait (what blocked a tick) and
*hidden* overlap (stream time absorbed behind compute), deadline-miss rate
per stream and token throughput, as one JSON document whose schema string,
``repro.serving.metrics/v9``, is the reference's, so that documents of
both packages validate against either ``validate``:

    {
      "schema": "repro.serving.metrics/v9",
      "ticks":      {"count", "latency_ms": {mean,p50,p99,max},
                     "paging_exposed_ms": {...}, "paging_hidden_ms": {...}},
      "requests":   {"count", "tokens_out", "truncated",
                     "ttft_ms": {...}, "latency_ms": {...}},
      "deadlines":  {"with_deadline", "missed", "miss_rate", "truncated"},
      "scheduler":  {"preemptions", "restores", "rejected", "degraded",
                     "budget_tokens_per_tick", "budget_used_mean",
                     "budget_utilization"},
      "throughput": {"wall_s", "tok_per_s"},
      "paging":     {"swap_count", "miss_count", "exposed_s", "hidden_s",
                     "overlap_frac", "stall_s", "n_pages",
                     "bytes_streamed_raw", "bytes_streamed_wire",
                     "kv_swaps", "kv_pool_hits", "kv_writebacks",
                     "kv_dropped", "kv_preempt_drops", "kv_exposed_s",
                     "kv_hidden_s", "kv_block_rows", "devices": [...]},
      "trace":      {"events", "tracks",
                     "predicted_vs_measured_stall_ratio"},
      "faults":     {"injected", "retries", "checksum_failures",
                     "refetches", "fetch_timeouts", "deferred_ticks"},
      "streams":    {name: {"count", "missed", "miss_rate", "truncated",
                            "p99_ttft_ms"}}
    }

Latencies are milliseconds; a request's deadline is met when its
end-to-end latency (arrival -> last token) is within ``deadline_ms``.
Requests without a deadline never count toward the miss rate; truncated
requests (retired by KV-cache exhaustion, partial service) are excluded
from it and counted on their own.  Requests the admission controller
rejected appear only in ``scheduler.rejected``.  ``devices`` (v9) holds
the per-link rows of a mesh-sharded paged run (``--mesh``): one a link,
with ``device``, ``n_pages``, ``swap_count``, ``miss_count`` and the wire /
raw bytes of that link alone, so the global ``paging`` counters are their
sum (``ShardedPoolLedger``); the port's rows add the link's ``crc_s`` and
``copy_s``.  A run on one link reports ``devices: []``.

:func:`multi_summary` assembles the multi-model (tenancy) shape: per-model
sections under ``models``, the shared pool's stats under ``shared_pool``,
and summed ``totals`` whose paging seconds come from the per-model
sections alone (the pool's per-model stalls are the same wall time seen
from the pool).  :func:`validate` checks either shape.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

SCHEMA = "repro.serving.metrics/v9"


def quantiles(xs: List[float]) -> Dict[str, float]:
    """{mean, p50, p99, max} of a latency sample, in the sample's units."""
    if not xs:
        return dict(mean=0.0, p50=0.0, p99=0.0, max=0.0)
    a = np.asarray(xs, np.float64)
    return dict(mean=float(a.mean()), p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)), max=float(a.max()))


def _empty_paging() -> Dict[str, Any]:
    return dict(swap_count=0, miss_count=0, exposed_s=0.0, hidden_s=0.0,
                overlap_frac=0.0, stall_s=0.0, n_pages=0,
                bytes_streamed_raw=0, bytes_streamed_wire=0,
                kv_swaps=0, kv_pool_hits=0, kv_writebacks=0, kv_dropped=0,
                kv_preempt_drops=0,
                kv_exposed_s=0.0, kv_hidden_s=0.0, kv_block_rows=0,
                devices=[])


def _empty_faults() -> Dict[str, int]:
    # the fault-free default: nothing injected, nothing retried, no
    # deadline ever missed — what a run without a FaultPlan reports
    return dict(injected=0, retries=0, checksum_failures=0, refetches=0,
                fetch_timeouts=0, deferred_ticks=0)


def _empty_trace() -> Dict[str, Any]:
    # the un-traced default: no events, no tracks, and a drift ratio of
    # 1.0 (predicted == measured, vacuously — nothing paged or no
    # accumulation ran)
    return dict(events=0, tracks=[],
                predicted_vs_measured_stall_ratio=1.0)


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps of one finished request (seconds, recorder
    clock).  Derived metrics are properties so the aggregation below and
    ad-hoc inspection agree by construction."""

    uid: int
    stream: str = "default"
    priority: int = 0
    deadline_ms: Optional[float] = None
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    n_prompt: int = 0
    n_generated: int = 0
    truncated: bool = False

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def deadline_met(self) -> Optional[bool]:
        """None when the request carries no deadline."""
        if self.deadline_ms is None:
            return None
        lat = self.latency_s
        return lat is not None and lat * 1e3 <= self.deadline_ms


class MetricsRecorder:
    """Accumulates tick- and request-level events; renders the v5 JSON."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.tick_latency_s: List[float] = []
        self.tick_exposed_s: List[float] = []
        self.tick_hidden_s: List[float] = []
        self.records: List[RequestRecord] = []
        # continuous-batching events (v5 "scheduler" section)
        self.preemptions = 0
        self.restores = 0
        self.rejected = 0
        self.degraded = 0
        self.budget_tokens: Optional[int] = None
        self.tick_budget_used: List[int] = []
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- event intake ---------------------------------------------------------
    def start(self) -> None:
        if self._t0 is None:
            self._t0 = self.clock()

    def record_tick(self, latency_s: float, paging_exposed_s: float = 0.0,
                    paging_hidden_s: float = 0.0,
                    budget_tokens: Optional[int] = None,
                    budget_used: Optional[int] = None) -> None:
        """One tick: its wall latency, the paging wait that actually
        blocked it (*exposed*), and the stream time the async pipeline
        hid behind compute (*hidden*; 0 for synchronous streaming).
        Budgeted continuous-batching ticks also report the per-tick
        token budget and the tokens the tick's plan actually scheduled
        (``budget_used`` may exceed ``budget_tokens`` — exact-length
        prefill families absorb whole prompts, a documented overrun)."""
        self.start()
        self.tick_latency_s.append(float(latency_s))
        self.tick_exposed_s.append(float(paging_exposed_s))
        self.tick_hidden_s.append(float(paging_hidden_s))
        if budget_tokens is not None:
            self.budget_tokens = int(budget_tokens)
        if budget_used is not None:
            self.tick_budget_used.append(int(budget_used))
        self._t_last = self.clock()

    def record_preemption(self) -> None:
        """One mid-request slot eviction (the victim's state checkpoints
        host-ward and its pooled KV blocks drop)."""
        self.preemptions += 1

    def record_restore(self) -> None:
        """One preempted request rebound to a slot (bit-exact resume)."""
        self.restores += 1

    def record_rejected(self) -> None:
        """Admission control refused a request outright: its predicted
        completion already missed the deadline, so queuing it would only
        have manufactured a guaranteed miss."""
        self.rejected += 1

    def record_degraded(self) -> None:
        """Admission control shortened a request's ``max_new_tokens`` to
        the longest completion that still fits its deadline."""
        self.degraded += 1

    def record_request(self, req: Any) -> RequestRecord:
        """Fold a finished engine Request (duck-typed: uid, prompt,
        generated, plus the scheduler-stamped fields) into a record."""
        rec = RequestRecord(
            uid=req.uid,
            stream=getattr(req, "stream", "default") or "default",
            priority=getattr(req, "priority", 0) or 0,
            deadline_ms=getattr(req, "deadline_ms", None),
            arrival_s=getattr(req, "arrival_s", 0.0) or 0.0,
            first_token_s=getattr(req, "first_token_s", None),
            finish_s=getattr(req, "finish_s", None),
            n_prompt=len(req.prompt),
            n_generated=len(req.generated),
            truncated=bool(getattr(req, "truncated", False)),
        )
        self.records.append(rec)
        return rec

    # -- aggregation ----------------------------------------------------------
    @property
    def wall_s(self) -> float:
        if self._t0 is None or self._t_last is None:
            return 0.0
        return self._t_last - self._t0

    def summary(self, paging: Optional[Dict[str, Any]] = None,
                trace: Optional[Dict[str, Any]] = None,
                faults: Optional[Dict[str, int]] = None
                ) -> Dict[str, Any]:
        ttfts = [r.ttft_s * 1e3 for r in self.records if r.ttft_s is not None]
        lats = [r.latency_s * 1e3 for r in self.records
                if r.latency_s is not None]
        # truncated requests got partial service (KV cache ran out): they
        # are excluded from the miss rate and labeled under their own key
        with_dl = [r for r in self.records
                   if r.deadline_ms is not None and not r.truncated]
        trunc_dl = [r for r in self.records
                    if r.deadline_ms is not None and r.truncated]
        missed = [r for r in with_dl if r.deadline_met is False]
        tokens = sum(r.n_generated for r in self.records)
        wall = max(self.wall_s, 1e-9)

        streams: Dict[str, Dict[str, Any]] = {}
        for name in sorted({r.stream for r in self.records}):
            rs = [r for r in self.records if r.stream == name]
            rs_dl = [r for r in rs
                     if r.deadline_ms is not None and not r.truncated]
            rs_missed = [r for r in rs_dl if r.deadline_met is False]
            rs_ttft = [r.ttft_s * 1e3 for r in rs if r.ttft_s is not None]
            streams[name] = dict(
                count=len(rs), missed=len(rs_missed),
                miss_rate=(len(rs_missed) / len(rs_dl)) if rs_dl else 0.0,
                truncated=sum(1 for r in rs if r.truncated),
                p99_ttft_ms=quantiles(rs_ttft)["p99"])

        return {
            "schema": SCHEMA,
            "ticks": {
                "count": len(self.tick_latency_s),
                "latency_ms": quantiles([t * 1e3
                                         for t in self.tick_latency_s]),
                "paging_exposed_ms": quantiles([t * 1e3
                                                for t in self.tick_exposed_s]),
                "paging_hidden_ms": quantiles([t * 1e3
                                               for t in self.tick_hidden_s]),
            },
            "requests": {
                "count": len(self.records),
                "tokens_out": tokens,
                "truncated": sum(1 for r in self.records if r.truncated),
                "ttft_ms": quantiles(ttfts),
                "latency_ms": quantiles(lats),
            },
            "deadlines": {
                "with_deadline": len(with_dl),
                "missed": len(missed),
                "miss_rate": (len(missed) / len(with_dl)) if with_dl else 0.0,
                "truncated": len(trunc_dl),
            },
            "scheduler": self._scheduler_section(),
            "throughput": {
                "wall_s": self.wall_s,
                "tok_per_s": tokens / wall,
            },
            "paging": dict(paging if paging is not None else _empty_paging()),
            "trace": dict(trace if trace is not None else _empty_trace()),
            # store-level fault dicts may lack the scheduler-level
            # "deferred_ticks"; the empty template fills any gap
            "faults": {**_empty_faults(), **(faults or {})},
            "streams": streams,
        }

    def _scheduler_section(self) -> Dict[str, Any]:
        used = self.tick_budget_used
        mean_used = (sum(used) / len(used)) if used else 0.0
        budget = self.budget_tokens or 0
        return {
            "preemptions": self.preemptions,
            "restores": self.restores,
            "rejected": self.rejected,
            "degraded": self.degraded,
            "budget_tokens_per_tick": budget,
            "budget_used_mean": mean_used,
            "budget_utilization": (mean_used / budget) if budget else 0.0,
        }

    def to_json(self, paging: Optional[Dict[str, Any]] = None,
                trace: Optional[Dict[str, Any]] = None,
                faults: Optional[Dict[str, int]] = None, **extra) -> str:
        doc = self.summary(paging=paging, trace=trace, faults=faults)
        doc.update(extra)
        return json.dumps(doc, indent=2, sort_keys=False)

    def write(self, path: str, paging: Optional[Dict[str, Any]] = None,
              trace: Optional[Dict[str, Any]] = None,
              faults: Optional[Dict[str, int]] = None, **extra) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json(paging=paging, trace=trace,
                                  faults=faults, **extra)
                     + "\n")


# ---------------------------------------------------------------------------
# multi-model tenancy (metrics/v8 multi shape)
# ---------------------------------------------------------------------------

def multi_summary(models: Dict[str, Dict[str, Any]],
                  shared_pool: Optional[Dict[str, Any]] = None,
                  ticks: int = 0) -> Dict[str, Any]:
    """Assemble the multi-model document from per-model single-model
    summaries (as produced by :meth:`MetricsRecorder.summary`) plus the
    shared page pool's summary (``SharedPagePool.summary``).

    The totals' paging seconds are summed from the per-model ``paging``
    sections alone; ``shared_pool.models[*].exposed_s/hidden_s`` are the
    pool's view of the SAME wall time (one pass, two vantage points), so
    they are deliberately NOT added — that would double-count every
    pooled pass."""
    sections = {}
    for name, doc in models.items():
        doc = dict(doc)
        doc.pop("schema", None)
        sections[name] = doc
    n_req = sum(d["requests"]["count"] for d in sections.values())
    tokens = sum(d["requests"]["tokens_out"] for d in sections.values())
    trunc = sum(d["requests"]["truncated"] for d in sections.values())
    with_dl = sum(d["deadlines"]["with_deadline"] for d in sections.values())
    missed = sum(d["deadlines"]["missed"] for d in sections.values())
    exposed = sum(d["paging"].get("exposed_s", 0.0)
                  for d in sections.values())
    hidden = sum(d["paging"].get("hidden_s", 0.0)
                 for d in sections.values())
    sched_totals = {k: sum(d.get("scheduler", {}).get(k, 0)
                           for d in sections.values())
                    for k in ("preemptions", "restores", "rejected",
                              "degraded")}
    fault_totals = {k: sum(int(d.get("faults", {}).get(k, 0))
                           for d in sections.values())
                    for k in _empty_faults()}
    # the tenants share one wall clock window, so aggregate throughput is
    # total tokens over the longest per-model span, not the sum of spans
    wall = max((d["throughput"]["wall_s"] for d in sections.values()),
               default=0.0)
    return {
        "schema": SCHEMA,
        "ticks": {"count": int(ticks)},
        "models": sections,
        "shared_pool": dict(shared_pool) if shared_pool else {},
        "totals": {
            "requests": n_req,
            "tokens_out": tokens,
            "truncated": trunc,
            "with_deadline": with_dl,
            "missed": missed,
            "miss_rate": (missed / with_dl) if with_dl else 0.0,
            **sched_totals,
            "wall_s": wall,
            "tok_per_s": tokens / max(wall, 1e-9),
            "paging_exposed_s": exposed,
            "paging_hidden_s": hidden,
            "overlap_frac": (hidden / (exposed + hidden)
                             if (exposed + hidden) > 0 else 0.0),
            "faults": fault_totals,
        },
    }


_SINGLE_KEYS = {
    "ticks": ("count", "latency_ms", "paging_exposed_ms",
              "paging_hidden_ms"),
    "requests": ("count", "tokens_out", "truncated", "ttft_ms",
                 "latency_ms"),
    "deadlines": ("with_deadline", "missed", "miss_rate", "truncated"),
    # v5: continuous-batching observability — its absence is exactly
    # what marks a stale v4 payload
    "scheduler": ("preemptions", "restores", "rejected", "degraded",
                  "budget_tokens_per_tick", "budget_used_mean",
                  "budget_utilization"),
    "throughput": ("wall_s", "tok_per_s"),
    "paging": ("swap_count", "miss_count", "exposed_s", "hidden_s",
               "overlap_frac", "n_pages",
               # v7: encoded-pages byte ledger — its absence is exactly
               # what marks a stale v6 payload
               "bytes_streamed_raw", "bytes_streamed_wire",
               # v4: the KV-cache share of the same page stream
               "kv_swaps", "kv_pool_hits", "kv_writebacks", "kv_dropped",
               # v5: preemption's share of the dropped blocks
               "kv_preempt_drops",
               "kv_exposed_s", "kv_hidden_s", "kv_block_rows",
               # v9: per-device split of a mesh-sharded run — its
               # presence (even as []) is exactly what marks a stale v8
               # payload
               "devices"),
    # v6: chrome-trace observability — its absence is exactly what marks
    # a stale v5 payload
    "trace": ("events", "tracks", "predicted_vs_measured_stall_ratio"),
    # v8: fault-tolerant page I/O — its absence is exactly what marks a
    # stale v7 payload
    "faults": ("injected", "retries", "checksum_failures", "refetches",
               "fetch_timeouts", "deferred_ticks"),
}

_TOTALS_KEYS = ("requests", "tokens_out", "truncated", "with_deadline",
                "missed", "miss_rate",
                "preemptions", "restores", "rejected", "degraded",
                "wall_s", "tok_per_s",
                "paging_exposed_s", "paging_hidden_s", "overlap_frac",
                "faults")


def _validate_single(doc: Dict[str, Any], where: str) -> None:
    for section, keys in _SINGLE_KEYS.items():
        if section not in doc:
            raise ValueError(f"{where}: missing section {section!r}")
        for k in keys:
            if k not in doc[section]:
                raise ValueError(f"{where}: missing {section}.{k}")
    if "streams" not in doc:
        raise ValueError(f"{where}: missing section 'streams'")
    for name, s in doc["streams"].items():
        for k in ("count", "missed", "miss_rate", "truncated",
                  "p99_ttft_ms"):
            if k not in s:
                raise ValueError(f"{where}: missing streams.{name}.{k}")


def validate(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Assert ``doc`` is a well-formed ``repro.serving.metrics/v9``
    document (either the single-model or the multi-model shape); returns
    the document unchanged so it can be used inline.  Raises ValueError
    naming the first missing piece."""
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema is {doc.get('schema')!r}, want {SCHEMA!r}")
    if "models" in doc:
        if not doc["models"]:
            raise ValueError("multi document with an empty 'models' map")
        for section in ("shared_pool", "totals", "ticks"):
            if section not in doc:
                raise ValueError(f"multi document missing {section!r}")
        for k in _TOTALS_KEYS:
            if k not in doc["totals"]:
                raise ValueError(f"multi document missing totals.{k}")
        for name, sub in doc["models"].items():
            _validate_single(sub, where=f"models.{name}")
        pool = doc["shared_pool"]
        if pool:
            for k in ("budget_bytes", "live_bytes", "live_wire_bytes",
                      "cached_pages", "evictions",
                      "bytes_streamed_wire", "bytes_streamed_raw",
                      "models"):
                if k not in pool:
                    raise ValueError(f"shared_pool missing {k!r}")
            for name, c in pool["models"].items():
                for k in ("swaps", "misses", "pool_hits", "evicted",
                          "exposed_s", "hidden_s", "n_pages",
                          "bytes_streamed_wire", "bytes_streamed_raw"):
                    if k not in c:
                        raise ValueError(
                            f"shared_pool.models.{name} missing {k!r}")
    else:
        _validate_single(doc, where="document")
    return doc
