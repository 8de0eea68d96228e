"""Multi-model tenancy: N serving engines, one scheduler, one page budget
(reference: ``repro/serving/tenancy.py``).

Siracusa's system claim (§V) is *concurrent* heterogeneous workloads (hand
tracking, gaze and a background assistant) sharing ONE memory hierarchy
inside the 10-20 ms frame budget.  This module is that claim's serving
side:

  * a :class:`MultiScheduler` multiplexes N :class:`ServingEngine`\\ s, each
    wrapped in its own :class:`Scheduler` for mechanism, but admitted
    through ONE global EDF-with-priority loop: every tick all tenants'
    queued requests (and preempted checkpoints) are sorted together
    (priority class first, earliest absolute deadline within a class, the
    shared submission sequence last) and placed into their own model's
    free slots;
  * all models' cold pages, and with ``kv_paged`` their KV blocks, flow
    through ONE :class:`~repro_torch.core.paging.SharedPagePool`: each
    tenant's ``attach_paging`` joins the pool, cross-model eviction is the
    pool's call, and the per-member counters follow the
    :func:`~repro_torch.core.paging.kv_pass_counters` replay of the pool's
    event log;
  * ``token_budget`` is dealt out across all tenants by one global plan;
  * per-model metrics land in the ``repro.serving.metrics/v9`` multi shape
    (:func:`~repro_torch.serving.metrics.multi_summary`);
  * the tick is a software pipeline across tenants: every pending tenant
    fences the passes begun last tick, then (in registration order) begins
    the next tick's, then computes; the pool's serialized fetch worker
    keeps the pass order, and so every counter, that of the synchronous
    schedule (``async_io=False``).

Each tenant's tokens are bit-exact against serving that model alone on a
private pager: the pool changes which fetches cost a host->device swap,
never the bytes the step consumes.

Typical use::

    pool = SharedPagePool(budget_bytes=4 << 20)
    ms = MultiScheduler(pool=pool)
    ms.add_model("assistant", assistant_engine, prefill_chunk=16,
                 kv_paged=True)
    ms.add_model("tracker", tracker_engine)
    ms.add_stream("tracker", "frames", priority=2, deadline_ms=15.0)
    ms.submit("tracker", Request(uid=0, prompt=p), stream="frames")
    done = ms.run_until_done()
    print(ms.to_json())
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.faults import FaultsArg, PageFetchTimeout, as_injector
from repro_torch.core.paging import SharedPagePool
from repro_torch.core.placement import packed_sizes
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.metrics import multi_summary
from repro_torch.serving.sched import Scheduler, StreamSpec
from repro_torch.serving.trace import Tracer


class MultiScheduler:
    """One EDF-with-priority admission loop over N tenant engines.

    ``pool`` (or ``shared_budget_bytes``, which constructs one) is the
    single device-bytes budget every tenant's cold pages contend for.
    Without either, tenants serve fully resident (no paging is attached).

    ``token_budget`` is the continuous-batching budget shared across ALL
    tenants: every tick one global plan deals it out in admission-key
    order (decode-ready slots first, then prefill chunks), so a tracker
    tenant's 10 ms request draws budget away from the assistant's long
    prefill THIS tick.  ``preemptive`` / ``admission`` forward to every
    tenant scheduler (mid-request slot handover and predicted-miss
    refusal, see :class:`~repro_torch.serving.sched.Scheduler`); the
    submission-sequence counter is shared, so the global admission order
    — and therefore every paging counter — is deterministic."""

    def __init__(self, *, pool: Optional[SharedPagePool] = None,
                 shared_budget_bytes: Optional[int] = None,
                 async_io: bool = True,
                 token_budget: Optional[int] = None,
                 preemptive: bool = False,
                 admission: Optional[str] = None,
                 clock=time.perf_counter,
                 tracer: Optional[Tracer] = None,
                 fetch_timeout_s: Optional[float] = None,
                 faults: FaultsArg = None):
        if pool is not None and shared_budget_bytes is not None:
            raise ValueError("pass either pool= or shared_budget_bytes=, "
                             "not both")
        if pool is None and shared_budget_bytes is not None:
            pool = SharedPagePool(shared_budget_bytes)
        self.pool = pool
        self.async_io = bool(async_io)
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got "
                             f"{token_budget}")
        self.token_budget = token_budget
        self.preemptive = bool(preemptive)
        self.admission = admission
        self.clock = clock
        # multi-wide fault defaults: every tenant added without its own
        # override inherits these (per-model overrides matter because the
        # pool's single serialized worker makes one tenant's stuck fetch
        # delay everyone's -- only the stuck tenant should defer)
        self.fetch_timeout_s = fetch_timeout_s
        self.faults = as_injector(faults)
        self.models: Dict[str, Scheduler] = {}
        self.ticks = 0
        self._seq = itertools.count()      # one submission order, global
        # one tracer across every tenant: each model gets its own track
        # (its registered name), the pool's I/O lands on the shared "io"
        # track, and the global admission pass on "scheduler"
        self.tracer = tracer

    @property
    def pass_log(self) -> List[str]:
        """One entry per member streaming pass in BEGIN (== execution)
        order — the exact ``passes=`` argument ``shared_pass_counters``
        needs.  Owned by the pool, which logs each pass at construction:
        under the async pipeline a tenant's next pass is begun a tick
        before it is fenced, and a tenant going idle then receiving live
        traffic re-enters the rotation out of registration order, so the
        fence order the scheduler sees is NOT always the order the pool
        executed."""
        return [] if self.pool is None else self.pool.pass_log

    # -- tenants --------------------------------------------------------------
    def add_model(self, name: str, engine: ServingEngine, *,
                  prefill_chunk: Optional[int] = None,
                  page_bytes: Optional[int] = None,
                  resident_slots: int = 2,
                  kv_paged: bool = False,
                  kv_block_rows: int = 16,
                  fetch_timeout_s: Optional[float] = None,
                  faults: FaultsArg = None) -> Scheduler:
        """Register a tenant.  When the MultiScheduler owns a shared pool
        and the engine's plan pages, the engine's paging is attached
        JOINED to that pool (an engine arriving with a private pager is
        rejected — a private cache would dodge the shared budget).  With
        ``kv_paged``, the tenant's per-slot KV cache pages through the
        SAME pool budget as everyone's weight pages (member
        ``<name>/kv`` — the one-memory-hierarchy reading of §V), in
        ``kv_block_rows``-row blocks.

        ``fetch_timeout_s`` / ``faults`` override the MultiScheduler-wide
        defaults for THIS tenant only (pass them to give one tenant a
        fetch deadline, or a private fault plan, without touching the
        others)."""
        if name in self.models:
            raise ValueError(f"model {name!r} already registered")
        if self.pool is not None and engine.pager is not None:
            raise ValueError(
                f"model {name!r} already has a private pager; tenants "
                f"of a shared pool must attach through it (pass the "
                f"engine un-attached)")
        if self.pool is not None and engine.kv_table is not None:
            raise ValueError(
                f"model {name!r} already pages its KV cache privately; "
                f"tenants of a shared pool must attach through it")
        # construct the Scheduler first: it validates prefill_chunk, and a
        # failure here must not leave the engine half-joined to the pool
        # (token_budget stays None per tenant — the GLOBAL plan below
        # deals the shared budget out instead)
        if fetch_timeout_s is None:
            fetch_timeout_s = self.fetch_timeout_s
        inj = as_injector(faults) if faults is not None else self.faults
        sched = Scheduler(engine, prefill_chunk=prefill_chunk,
                          async_io=self.async_io, clock=self.clock,
                          preemptive=self.preemptive,
                          admission=self.admission,
                          seq_counter=self._seq,
                          tracer=self.tracer, trace_track=name,
                          fetch_timeout_s=fetch_timeout_s)
        if self.pool is not None:
            sizes = packed_sizes(engine.params)
            if engine.plan.paged_bytes(sizes) > 0:
                engine.attach_paging(page_bytes, resident_slots,
                                     pool=self.pool, name=name,
                                     faults=inj)
        if kv_paged and engine.kv_table is None and "kv" in engine.cache:
            # families without a KV cache (pure SSM trackers) simply have
            # no KV state to page — the flag is a no-op for them
            engine.attach_kv_paging(kv_block_rows, pool=self.pool,
                                    name=f"{name}/kv", faults=inj)
        self.models[name] = sched
        return sched

    def model(self, name: str) -> Scheduler:
        return self.models[name]

    def add_stream(self, model: str, name: str, *, priority: int = 0,
                   deadline_ms: Optional[float] = None) -> StreamSpec:
        return self.models[model].add_stream(name, priority=priority,
                                             deadline_ms=deadline_ms)

    def submit(self, model: str, req: Request,
               stream: Optional[str] = None) -> None:
        self.models[model].submit(req, stream=stream)

    # -- the single admission loop -------------------------------------------
    def admission_order(self) -> List[Tuple[str, Request]]:
        """ALL tenants' waiting requests in one service order: priority
        class first, then earliest absolute deadline (EDF), then the
        shared submission sequence — the same key each per-model
        scheduler uses, applied across models."""
        waiting = [(sched._admission_key(req), name, req)
                   for name, sched in self.models.items()
                   for req in sched.queue]
        waiting.sort(key=lambda t: t[0])
        return [(name, req) for _key, name, req in waiting]

    def _admit_global(self) -> None:
        """One global admission pass: every tenant's queue AND preempted
        pool in one key order; each candidate takes a free slot of its
        own model, or (``preemptive``) evicts a strictly-lower-priority
        occupant there.  Preempting here — before the tick's fences —
        defers the victim's KV-drop flush to its tenant's fence, which
        still lands before the usurper's first writeback."""
        for sched in self.models.values():
            sched._adopt_engine_queue()
            if sched.admission is not None:
                sched._admission_control()
        while True:
            cands = [(key, name, kind, obj)
                     for name, sched in self.models.items()
                     for key, kind, obj in sched._candidates()]
            cands.sort(key=lambda t: t[0])
            placed = False
            for _key, name, kind, obj in cands:
                sched = self.models[name]
                free = sched.engine.free_slots()
                if free:
                    sched._place(kind, obj, free[0])
                    placed = True
                    break            # keys are static: rescan continues
                if sched.preemptive:
                    req = obj if kind == "queue" else obj.req
                    slot = sched._preempt_for(req)
                    if slot is not None:
                        sched._preempt_slot(slot)
                        sched._place(kind, obj, slot)
                        placed = True
                        break
                # this tenant is full; later candidates may still admit
            if not placed:
                return

    def _plan_global(self) -> None:
        """Deal the shared ``token_budget`` across ALL tenants' live
        slots in one admission-key order (decode-ready slots cost 1 off
        the top, prefill chunks next) and hand each tenant its slice as
        the tick plan its ``tick_begin``/``tick_compute`` consume."""
        scheds = list(self.models.values())
        if self.token_budget is None:
            for sched in scheds:
                sched._tick_plan = None
                sched._tick_budget_tokens = None
                sched._tick_budget_used = None
            return
        plans: Dict[int, Dict[int, int]] = {id(s): {} for s in scheds}
        used: Dict[int, int] = {
            id(s): sum(1 for r in s.engine.slot_req
                       if r is not None and r.prefill_pos >= len(r.prompt))
            for s in scheds}
        remaining = self.token_budget - sum(used.values())
        prefilling = [(sched, i, r)
                      for sched in scheds
                      for i, r in enumerate(sched.engine.slot_req)
                      if r is not None and r.prefill_pos < len(r.prompt)]
        prefilling.sort(key=lambda t: t[0]._admission_key(t[2]))
        for sched, i, r in prefilling:
            rem = len(r.prompt) - r.prefill_pos
            if sched.engine._bucketed:
                alloc = min(sched.prefill_chunk or rem, rem,
                            max(remaining, 0))
            else:
                alloc = rem if remaining > 0 else 0
            if alloc > 0:
                plans[id(sched)][i] = int(alloc)
                remaining -= alloc
                used[id(sched)] += alloc
        for sched in scheds:
            sched._tick_plan = plans[id(sched)]
            sched._tick_budget_tokens = self.token_budget
            sched._tick_budget_used = used[id(sched)]

    # -- ticks ----------------------------------------------------------------
    @property
    def pending(self) -> bool:
        return any(s.pending for s in self.models.values())

    def tick(self) -> Dict[str, List[Request]]:
        """One tenancy tick, pipelined across tenants: one global
        EDF-with-priority admission pass, then — for every tenant with
        pending work, in registration order — phase 1 fences the page
        pass begun last tick, phase 2 begins the next tick's stream, and
        phase 3 runs this tick's prefill/decode while those streams
        proceed.  Keeping the phases tenant-ordered (all fences, then all
        begins, then all computes) preserves the global A,B,A,B pass
        order of the synchronous loop, which is what keeps the shared
        pool's counters on the static ``shared_pass_counters``
        prediction.  Returns {model: requests finished this tick}."""
        tr = self.tracer
        if tr is None:
            self._admit_global()
        else:
            with tr.span("admit", track="scheduler", tick=self.ticks):
                self._admit_global()
        active = [(name, sched) for name, sched in self.models.items()
                  if sched.pending]
        fenced = []
        for name, sched in active:
            try:
                t0, params = sched.tick_fence()
            except PageFetchTimeout as e:
                # only THIS tenant's tick degrades: its pass stays
                # resumable (futures/accounting intact) and is re-fenced
                # next tick; everyone else proceeds below
                sched.defer_tick(e)
                continue
            fenced.append((name, sched, t0, params))
        for _name, sched, _t0, _params in fenced:
            sched._admit()                 # late engine.submit stragglers
        self._plan_global()                # budget over the final slot set
        for _name, sched, _t0, _params in fenced:
            sched.tick_begin()
        finished: Dict[str, List[Request]] = {}
        for name, sched, t0, params in fenced:
            done = sched.tick_compute(t0, params)
            if done:
                finished[name] = done
        self.ticks += 1
        return finished

    def run_until_done(self, max_ticks: int = 100_000
                       ) -> Dict[str, List[Request]]:
        """Serve until every tenant's queue drains; ``max_ticks`` bounds
        this call, and the return value is {model: requests completed by
        this call}."""
        done: Dict[str, List[Request]] = {}
        ticks = 0
        while self.pending:
            for name, reqs in self.tick().items():
                done.setdefault(name, []).extend(reqs)
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("tenancy loop did not converge")
        return done

    def run_for(self, seconds: float) -> Dict[str, List[Request]]:
        """Serve until the wall budget is spent or every queue drains;
        returns the per-model requests completed by this call."""
        t0 = self.clock()
        done: Dict[str, List[Request]] = {}
        while self.pending and (self.clock() - t0) < seconds:
            for name, reqs in self.tick().items():
                done.setdefault(name, []).extend(reqs)
        return done

    # -- metrics / lifecycle --------------------------------------------------
    def summary(self) -> Dict:
        """The ``repro.serving.metrics/v9`` multi-model document."""
        models = {name: sched.metrics.summary(
                      paging=sched.engine.paging_summary(),
                      trace=sched.trace_summary(),
                      faults=sched.faults_summary())
                  for name, sched in self.models.items()}
        return multi_summary(
            models,
            shared_pool=self.pool.summary() if self.pool else None,
            ticks=self.ticks)

    def to_json(self, **extra) -> str:
        doc = self.summary()
        doc.update(extra)
        return json.dumps(doc, indent=2, sort_keys=False)

    def write(self, path: str, **extra) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json(**extra) + "\n")

    def close(self, wait: bool = True) -> None:
        """Shut every tenant's pager down (through the pool when one is
        shared).  In-flight overlapped passes are cancelled/drained FIRST
        so an early exit cannot leak worker fetches or the pool's
        eviction guard."""
        for sched in self.models.values():
            sched.close()                  # cancel unfenced AsyncPageStream
        if self.pool is not None:
            self.pool.close(wait=wait)
        for sched in self.models.values():
            if sched.engine.pager is not None:
                sched.engine.pager.close(wait=wait)
            if sched.engine.kv_table is not None:
                sched.engine.kv_table.close(wait=wait)

    def __enter__(self) -> "MultiScheduler":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
