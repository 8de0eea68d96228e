"""Deadline-aware XR serving scheduler: policy over the engine's ticks
(reference: ``repro/serving/sched.py``).

Siracusa's system claim is "inside the frame budget": the heterogeneous XR
workload (hand tracking, gaze, a background assistant) must finish each
invocation within a 10-20 ms deadline while everything shares one memory
hierarchy.  This is the serving-side analogue:

  * N **request streams**, each with a default priority and deadline;
  * **EDF-with-priority admission**: free slots go to the highest priority
    class first, earliest absolute deadline within a class, and ties break
    on the monotonic submission sequence, so admission (and with it every
    paging counter) is reproducible run to run;
  * **continuous batching** (``token_budget=``): every tick re-plans a
    shared token budget: one token a decode-ready slot off the top, the
    rest dealt to mid-prefill slots in admission-key order (an exact-length
    family absorbs its whole prompt, a documented overrun);
  * **mid-request preemption** (``preemptive=True``): an urgent request
    with no free slot evicts the worst-ranked occupant of a strictly lower
    priority class (:meth:`ServingEngine.preempt`); the victim re-enters
    the admission pool and later resumes bit-exactly
    (:meth:`ServingEngine.restore`) for greedy requests;
  * **admission control** (``admission="reject"|"degrade"``): a request
    whose predicted completion (prefill + decode ticks at the per-tick
    cost, the exposed stall from
    :func:`~repro_torch.core.memsys.overlap_stall`) already misses its
    deadline is refused, or under ``"degrade"`` its ``max_new_tokens`` is
    cut to the longest completion that still fits;
  * **chunked prefill**: a long prompt advances at most ``prefill_chunk``
    tokens a tick;
  * **overlapped paging** (``async_io=True``, the default): fence the
    weight and KV passes begun last tick, admit, *begin* the next tick's
    streams, then compute while they proceed; only the exposed wait lands
    on the tick.  ``async_io=False`` is the synchronous stream-then-step tick,
    with the same tokens and swap / miss counters;
  * **metrics**: TTFT, end-to-end latency, p50 / p99, deadline-miss rate,
    tok/s, exposed vs hidden paging stalls, preemption and admission
    counters and budget use, as the ``repro.serving.metrics/v9`` document
    (:mod:`repro_torch.serving.metrics`).

The scheduler owns no device state: it drives the engine's tick primitives
(``begin_tick_params`` / ``fence_tick_params`` / ``assign`` / ``preempt``
/ ``restore`` / ``prefill_tick`` / ``decode_tick`` / ``sync_kv_tick``).
:class:`~repro_torch.serving.tenancy.MultiScheduler` drives several of
them through one admission loop and one page pool.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.faults import PageFetchTimeout
from repro_torch.core.memsys import overlap_stall
from repro_torch.core.paging import pass_counters
from repro_torch.serving.engine import (Request, ServingEngine,
                                        SlotCheckpoint, _next_pow2)
from repro_torch.serving.metrics import MetricsRecorder
from repro_torch.serving.trace import Tracer


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One request stream (an XR app's model invocations): requests
    submitted to the stream inherit its priority and deadline unless they
    carry their own."""
    name: str
    priority: int = 0                      # higher = more urgent
    deadline_ms: Optional[float] = None    # None = best effort


class Scheduler:
    """EDF-with-priority front-end over a :class:`ServingEngine`.

    Typical use::

        eng = ServingEngine(cfg, packed, plan=plan).attach_paging()
        sched = Scheduler(eng, prefill_chunk=32, token_budget=64,
                          preemptive=True, admission="reject")
        sched.add_stream("hand", priority=2, deadline_ms=15.0)
        sched.add_stream("assistant")                  # best effort
        sched.submit(Request(uid=0, prompt=p), stream="hand")
        done = sched.run_until_done()
        print(sched.metrics.to_json(paging=eng.paging_summary()))

    ``token_budget`` turns on the continuous-batching tick plan,
    ``preemptive`` allows mid-request slot handover to strictly-higher
    priority requests, and ``admission`` ("reject" or "degrade") refuses
    requests whose predicted completion already misses their deadline
    (an explicit ``est_tick_s`` pins the cost model — deterministic
    admission for virtual-clock benches; without it the controller uses
    measured per-tick EMAs, admitting optimistically until it has
    data).  ``seq_counter`` shares one submission sequence across
    schedulers (the tenancy loop passes its own, so that the global
    admission order is deterministic)."""

    def __init__(self, engine: ServingEngine, *,
                 prefill_chunk: Optional[int] = None,
                 metrics: Optional[MetricsRecorder] = None,
                 async_io: bool = True,
                 token_budget: Optional[int] = None,
                 preemptive: bool = False,
                 admission: Optional[str] = None,
                 est_tick_s: Optional[float] = None,
                 seq_counter: Optional[itertools.count] = None,
                 clock=time.perf_counter,
                 tracer: Optional[Tracer] = None,
                 trace_track: Optional[str] = None,
                 fetch_timeout_s: Optional[float] = None):
        self.engine = engine
        # overlap the next tick's page stream with this tick's compute;
        # False = the fully synchronous stream-then-step tick
        self.async_io = bool(async_io)
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                # _next_pow2 maps 0/negative to 1 — reject instead of
                # silently pacing at chunk=1
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            self.prefill_chunk: Optional[int] = _next_pow2(prefill_chunk)
        else:
            self.prefill_chunk = None      # engine default pacing
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got "
                             f"{token_budget}")
        self.token_budget = token_budget
        self.preemptive = bool(preemptive)
        if admission not in (None, "reject", "degrade"):
            raise ValueError(f"admission must be None, 'reject' or "
                             f"'degrade', got {admission!r}")
        self.admission = admission
        self.metrics = metrics if metrics is not None else MetricsRecorder(
            clock=clock)
        self.clock = clock
        self.streams: Dict[str, StreamSpec] = {
            "default": StreamSpec("default")}
        self.queue: List[Request] = []
        self.preempted: List[SlotCheckpoint] = []
        self.rejected: List[Request] = []
        self.finished: List[Request] = []
        self.ticks = 0
        # fetch deadline for the tick's I/O fence: on expiry the tick is
        # DEFERRED (the in-flight pass resumes at the next fence) instead
        # of stalling the world — graceful degradation under stuck pages
        self.fetch_timeout_s = fetch_timeout_s
        self.deferred_ticks = 0
        self._seq = (seq_counter if seq_counter is not None
                     else itertools.count())
        # the budgeted tick's plan ({slot: token alloc}), set between
        # admission and begin (the tenancy loop sets it from its GLOBAL
        # plan), consumed by tick_begin/tick_compute
        self._tick_plan: Optional[Dict[int, int]] = None
        self._tick_budget_tokens: Optional[int] = None
        self._tick_budget_used: Optional[int] = None
        # admission-control cost model: EMAs of per-tick compute and
        # stream (swap) seconds; predicted tick cost composes them via
        # the memsys overlap identity
        self._compute_ema: Optional[float] = None
        self._swap_ema: Optional[float] = None
        self._est_seed_s = est_tick_s
        # opt-in chrome-trace instrumentation: every hot-path hook guards
        # on ``tracer is None`` (the default), so the un-traced tick pays
        # one branch and allocates nothing
        self.tracer = tracer
        self.track = trace_track if trace_track is not None else "serve"
        if tracer is not None:
            engine.set_tracer(tracer, track=self.track)
        # predicted-vs-measured exposed-stall accumulators: the closed
        # form (memsys.overlap_stall over the fenced pass's swap/window)
        # against what the fence actually booked — summarized as the
        # metrics ``trace.predicted_vs_measured_stall_ratio``
        self._pred_exposed_s = 0.0
        self._meas_exposed_s = 0.0

    # -- streams & submission -------------------------------------------------
    def add_stream(self, name: str, *, priority: int = 0,
                   deadline_ms: Optional[float] = None) -> StreamSpec:
        spec = StreamSpec(name, priority=priority, deadline_ms=deadline_ms)
        self.streams[name] = spec
        return spec

    def submit(self, req: Request, stream: Optional[str] = None) -> None:
        """Queue a request.  Stream defaults fill in a missing priority /
        deadline; arrival is stamped here (TTFT and the deadline clock run
        from submission, not admission), as is the monotonic submission
        sequence the admission key breaks ties on."""
        name = stream if stream is not None else req.stream
        if name not in self.streams:
            raise KeyError(f"unknown stream {name!r}; add_stream() first")
        spec = self.streams[name]
        self.engine._check_fits(req)       # reject oversized/empty NOW,
        req.stream = name                  # not mid-loop at admission
        if req.priority is None:
            req.priority = spec.priority
        if req.deadline_ms is None:
            req.deadline_ms = spec.deadline_ms
        if req.arrival_s is None:
            req.arrival_s = self.clock()
        if req.seq is None:
            req.seq = next(self._seq)
        self.queue.append(req)

    # -- admission policy -----------------------------------------------------
    def _admission_key(self, req: Request) -> Tuple[int, float, int]:
        """Priority class first, EDF inside the class, and the monotonic
        submission sequence as the deterministic tie-break (requests that
        never passed :meth:`submit` fall back to their uid)."""
        deadline_abs = (float("inf") if req.deadline_ms is None
                        else req.arrival_s + req.deadline_ms / 1e3)
        seq = req.seq if req.seq is not None else req.uid
        return (-(req.priority or 0), deadline_abs, seq)

    def admission_order(self) -> List[Request]:
        """Waiting requests in service order: priority class first, then
        earliest absolute deadline (EDF), then submission sequence."""
        return sorted(self.queue, key=self._admission_key)

    def _adopt_engine_queue(self) -> None:
        """Requests submitted through the still-public ``engine.submit``
        join the scheduler's queue (their stream if it exists here, else
        "default") — otherwise ``pending`` would count them while nothing
        ever admits them."""
        while self.engine.waiting:
            req = self.engine.waiting.pop(0)
            stream = req.stream if req.stream in self.streams else "default"
            if self.clock is not time.perf_counter:
                # engine.submit stamped arrival with perf_counter; under a
                # custom scheduler clock that would mix domains in every
                # latency/deadline metric — re-stamp on adoption
                req.arrival_s = None
            self.submit(req, stream=stream)

    # -- admission control (predicted-miss refusal) ---------------------------
    def est_tick_s(self) -> Optional[float]:
        """Predicted cost of one tick.  An explicit ``est_tick_s``
        constructor seed PINS the cost model (deterministic admission —
        benches and tests driving a virtual clock need predictions that
        never drift with host load, since the engine-side stall split is
        measured in real time).  Without a seed, the prediction is the
        measured compute EMA plus the exposed share of the stream EMA
        under the memsys overlap model (``stall = swap - hidden``), and
        None until the first measured tick — the controller then admits
        optimistically rather than rejecting on no data."""
        if self._est_seed_s is not None:
            return self._est_seed_s
        if self._compute_ema is None:
            return None
        stall = overlap_stall(self._swap_ema or 0.0, self._compute_ema)
        return self._compute_ema + stall["exposed_s"]

    def _ticks_needed(self, req: Request, new_tokens: int) -> int:
        """Service ticks to produce ``new_tokens``: chunked prefill ticks
        (the first token lands on the last of them), then one decode tick
        per further token.  Optimistic — budget contention and queueing
        ahead are not modeled, so a predicted miss is a CERTAIN miss
        under at-least-this-cost service, which is exactly the one-sided
        guarantee rejection needs."""
        remaining = len(req.prompt) - req.prefill_pos
        if remaining <= 0:
            p_ticks = 0
        elif self.engine._bucketed and self.prefill_chunk:
            p_ticks = math.ceil(remaining / self.prefill_chunk)
        else:
            p_ticks = 1
        return p_ticks + max(new_tokens - 1, 0)

    def _admission_control(self) -> None:
        cost = self.est_tick_s()
        if cost is None or cost <= 0.0:
            return
        now = self.clock()
        kept: List[Request] = []
        for req in self.queue:
            if req.deadline_ms is None:
                kept.append(req)
                continue
            deadline_abs = req.arrival_s + req.deadline_ms / 1e3
            slack_ticks = math.floor((deadline_abs - now) / cost)
            if self._ticks_needed(req, req.max_new_tokens) <= slack_ticks:
                kept.append(req)
                continue
            # the longest completion that still fits the deadline
            feasible = slack_ticks - self._ticks_needed(req, 1) + 1
            if self.admission == "degrade" and feasible >= 1:
                if feasible < req.max_new_tokens:
                    req.max_new_tokens = int(feasible)
                    if not req.degraded:
                        req.degraded = True
                        self.metrics.record_degraded()
                        if self.tracer is not None:
                            self.tracer.instant(
                                "degrade", track=self.track, uid=req.uid,
                                max_new_tokens=req.max_new_tokens)
                kept.append(req)
            else:
                req.rejected = True
                req.finish_s = now
                self.rejected.append(req)
                self.metrics.record_rejected()
                if self.tracer is not None:
                    self.tracer.instant("reject", track=self.track,
                                        uid=req.uid)
        self.queue[:] = kept

    # -- admission + preemption -----------------------------------------------
    def _candidates(self) -> List[Tuple[tuple, str, object]]:
        """The unified admission pool — fresh queue entries and preempted
        checkpoints under ONE key — sorted into service order.  A
        preempted victim competes on its own (priority, deadline, seq):
        an urgent victim re-enters ahead of best-effort arrivals, and may
        itself preempt a lower-priority usurper."""
        cands = [(self._admission_key(r), "queue", r) for r in self.queue]
        cands += [(self._admission_key(c.req), "restore", c)
                  for c in self.preempted]
        cands.sort(key=lambda t: t[0])
        return cands

    def _place(self, kind: str, obj, slot: int) -> None:
        # remove by identity: Request's dataclass __eq__ compares the
        # ndarray prompt (and SlotCheckpoint's its state arrays), so
        # list.remove could raise on an equality tie
        if kind == "queue":
            idx = next(i for i, r in enumerate(self.queue) if r is obj)
            del self.queue[idx]
            self.engine.assign(obj, slot)
            if self.tracer is not None:
                self.tracer.instant("admit", track=self.track,
                                    uid=obj.uid, slot=slot)
        else:
            idx = next(i for i, c in enumerate(self.preempted) if c is obj)
            del self.preempted[idx]
            self.engine.restore(obj, slot)
            self.metrics.record_restore()
            if self.tracer is not None:
                self.tracer.instant("restore", track=self.track,
                                    uid=obj.req.uid, slot=slot)

    def _preempt_slot(self, slot: int) -> None:
        """Evict ``slot`` mid-service into the preempted pool — the one
        copy of the checkpoint + metrics + trace bookkeeping shared by
        the solo admit loop and the tenancy global pass."""
        ck = self.engine.preempt(slot)
        self.preempted.append(ck)
        self.metrics.record_preemption()
        if self.tracer is not None:
            self.tracer.instant("preempt", track=self.track,
                                uid=ck.req.uid, slot=slot)

    def _preempt_for(self, req: Request) -> Optional[int]:
        """Pick a victim slot for ``req``: the worst-ranked occupant of a
        STRICTLY lower priority class (equal-priority preemption would
        thrash: the victim would immediately out-rank its usurper by
        deadline and want the slot back).  Returns None when no occupant
        qualifies."""
        prio = req.priority or 0
        victims = [(i, r) for i, r in enumerate(self.engine.slot_req)
                   if r is not None and (r.priority or 0) < prio]
        if not victims:
            return None
        slot, _r = max(victims, key=lambda t: self._admission_key(t[1]))
        return slot

    def _admit(self) -> None:
        tr = self.tracer
        if tr is None:
            self._admit_impl()
            return
        with tr.span("admit", track=self.track):
            self._admit_impl()

    def _admit_impl(self) -> None:
        self._adopt_engine_queue()
        if self.admission is not None:
            self._admission_control()
        for slot in self.engine.free_slots():
            cands = self._candidates()
            if not cands:
                break
            _key, kind, obj = cands[0]
            self._place(kind, obj, slot)
        if not self.preemptive:
            return
        # every iteration strictly raises the evicted slot's priority, so
        # the handover chain terminates
        while True:
            cands = self._candidates()
            if not cands:
                return
            _key, kind, obj = cands[0]
            req = obj if kind == "queue" else obj.req
            slot = self._preempt_for(req)
            if slot is None:
                return
            self._preempt_slot(slot)
            self._place(kind, obj, slot)

    # -- the budgeted tick plan (continuous batching) -------------------------
    def _plan_tick(self) -> Optional[Dict[int, int]]:
        """Deal this tick's ``token_budget`` across the live slots: one
        token per decode-ready slot off the top (decode is a single
        batched step — withholding it would stall every live stream),
        the remainder to mid-prefill slots in admission-key order, capped
        at ``prefill_chunk``.  Exact-length families (hybrid / moe) are
        all-or-nothing: a scheduled slot absorbs its whole remaining
        prompt (documented overrun) rather than starving forever.
        Returns the {slot: alloc} plan, or None when unbudgeted."""
        if self.token_budget is None:
            self._tick_budget_tokens = None
            self._tick_budget_used = None
            return None
        eng = self.engine
        occ = [(i, r) for i, r in enumerate(eng.slot_req) if r is not None]
        used = sum(1 for _i, r in occ if r.prefill_pos >= len(r.prompt))
        remaining = self.token_budget - used
        plan: Dict[int, int] = {}
        prefilling = sorted(
            ((i, r) for i, r in occ if r.prefill_pos < len(r.prompt)),
            key=lambda t: self._admission_key(t[1]))
        for i, r in prefilling:
            rem = len(r.prompt) - r.prefill_pos
            if eng._bucketed:
                alloc = min(self.prefill_chunk or rem, rem,
                            max(remaining, 0))
            else:
                alloc = rem if remaining > 0 else 0
            if alloc > 0:
                plan[i] = int(alloc)
                remaining -= alloc
                used += alloc
        self._tick_budget_tokens = self.token_budget
        self._tick_budget_used = used
        return plan

    # -- the tick (a 3-phase software pipeline) -------------------------------
    def tick_fence(self) -> tuple:
        """Phase 1: fence the page pass begun last tick (demand-begins a
        blocking one on the cold first tick / in sync mode) and stamp the
        tick start.  Returns ``(t0, params)`` for :meth:`tick_compute`.

        A fence past ``fetch_timeout_s`` raises
        :class:`~repro_torch.core.faults.PageFetchTimeout` with the pass
        left resumable (:meth:`tick` defers the tick on it)."""
        t0 = self.clock()
        self.metrics.start()                     # wall clock spans tick 1
        tr = self.tracer
        if tr is None:
            params = self.engine.fence_tick_params(
                timeout_s=self.fetch_timeout_s)
        else:
            with tr.span("fence", track=self.track, tick=self.ticks):
                params = self.engine.fence_tick_params(
                    timeout_s=self.fetch_timeout_s)
        return t0, params

    def tick_begin(self) -> None:
        """Phase 2 (after admission + planning): begin the NEXT tick's
        page stream — only when the engine is certain to tick again, so
        every begun pass is consumed by exactly one fence and the
        swap/miss counters stay identical to the synchronous schedule."""
        if not self.async_io:
            return
        if self._tick_plan is not None:
            more = self.engine.has_tick_after(plan=self._tick_plan)
        else:
            more = self.engine.has_tick_after(self.prefill_chunk)
        if self.queue or self.preempted or more:
            tr = self.tracer
            if tr is None:
                self.engine.begin_tick_params()
            else:
                with tr.span("begin", track=self.track):
                    self.engine.begin_tick_params()

    def _compute_tick(self, params) -> List[Request]:
        """The engine-driving core of phase 3: planned prefills, one
        batched decode, KV writeback."""
        started = self.engine.prefill_tick(params, complete=False,
                                           chunk=self.prefill_chunk,
                                           plan=self._tick_plan)
        now = self.clock()
        for req in started:
            req.first_token_s = now              # scheduler clock wins
        finished = [r for r in started if r.done]
        finished += self.engine.decode_tick(params)
        # KV paging: blocks the append-only frontier completed this tick
        # are written back host-ward once, becoming fetchable next pass
        self.engine.sync_kv_tick()
        return finished

    def _trace_tick(self, measured_exposed_s: float) -> None:
        """Accumulate this tick's predicted-vs-measured exposed-stall
        drift (the metrics ``trace`` section) and, when tracing,
        render the closed-form prediction on the ``<track> (predicted)``
        overlay next to the measured fence spans."""
        eng = self.engine
        overlaps = [ov for ov in (eng.last_overlap, eng.last_kv_overlap)
                    if ov is not None]
        if not overlaps:
            return
        pred_exposed = pred_hidden = swap = 0.0
        for ov in overlaps:
            st = overlap_stall(ov["swap_s"], ov["window_s"])
            pred_exposed += st["exposed_s"]
            pred_hidden += st["hidden_s"]
            swap += ov["swap_s"]
        self._pred_exposed_s += pred_exposed
        self._meas_exposed_s += measured_exposed_s
        tr = self.tracer
        if tr is None:
            return
        per_pass_swaps = (
            pass_counters(len(eng.pager.pages),
                          eng.page_resident_slots)["swaps"]
            if eng.pager is not None else 0)
        tr.complete("stall(pred)", pred_exposed,
                    track=f"{self.track} (predicted)",
                    predicted_exposed_ms=pred_exposed * 1e3,
                    predicted_hidden_ms=pred_hidden * 1e3,
                    measured_exposed_ms=measured_exposed_s * 1e3,
                    swap_ms=swap * 1e3,
                    predicted_swaps_per_pass=per_pass_swaps)

    def tick_compute(self, t0: float, params) -> List[Request]:
        """Phase 3: prefill per the tick plan (one chunk per slot when
        unbudgeted), one batched decode, retire + metrics — overlapping
        with the phase-2 stream."""
        tr = self.tracer
        if tr is None:
            finished = self._compute_tick(params)
        else:
            with tr.span("compute", track=self.track, tick=self.ticks):
                finished = self._compute_tick(params)
        now = self.clock()
        for req in finished:
            req.finish_s = now
            self.metrics.record_request(req)
            self.finished.append(req)
        self.ticks += 1
        latency = now - t0
        exposed = self.engine.last_stall_s
        hidden = self.engine.last_hidden_s
        # cost-model EMAs: compute is the tick wall net of the exposed
        # paging wait; "swap" is the full stream time (exposed + hidden)
        alpha = 0.3
        compute = max(latency - exposed, 0.0)
        self._compute_ema = (compute if self._compute_ema is None
                             else (1 - alpha) * self._compute_ema
                             + alpha * compute)
        swap = exposed + hidden
        self._swap_ema = (swap if self._swap_ema is None
                          else (1 - alpha) * self._swap_ema + alpha * swap)
        self._trace_tick(exposed)
        self.metrics.record_tick(latency_s=latency,
                                 paging_exposed_s=exposed,
                                 paging_hidden_s=hidden,
                                 budget_tokens=self._tick_budget_tokens,
                                 budget_used=self._tick_budget_used)
        self._tick_plan = None
        self._tick_budget_tokens = None
        self._tick_budget_used = None
        return finished

    def defer_tick(self, exc: PageFetchTimeout) -> None:
        """Record a tick deferred on an I/O deadline: the fence timed out,
        the in-flight pass stays owned by the engine (resumed by the next
        fence), no compute ran and no tick counters advanced — so the
        weight-counter identity ``swaps == ticks x pass_counters`` holds
        on COMPUTED ticks, exactly as the static prediction expects."""
        self.deferred_ticks += 1
        if self.tracer is not None:
            self.tracer.instant("defer", track="io", model=exc.model,
                                timeout_ms=exc.timeout_s * 1e3,
                                pending=exc.pending, tick=self.ticks)

    def tick(self) -> List[Request]:
        """One scheduler tick: fence the in-flight pages, admit EDF
        (preempting / refusing per policy), re-plan the token budget,
        begin the next stream, then advance the planned prefills and run
        one batched decode while the stream proceeds.  Returns the
        requests that finished this tick.

        With a ``fetch_timeout_s``, a fence that exceeds the deadline
        defers the whole tick (empty return) instead of blocking: the
        pass resumes at the next tick's fence."""
        try:
            t0, params = self.tick_fence()
        except PageFetchTimeout as e:
            self.defer_tick(e)
            return []
        self._admit()
        self._tick_plan = self._plan_tick()
        self.tick_begin()
        return self.tick_compute(t0, params)

    # -- loops ----------------------------------------------------------------
    @property
    def pending(self) -> bool:
        return bool(self.queue or self.preempted or self.engine.pending)

    def run_until_done(self, max_ticks: int = 100_000) -> List[Request]:
        """Serve until the queue drains.  ``max_ticks`` bounds THIS call
        (a reused scheduler's cumulative ``self.ticks`` must not trip the
        convergence check early), and the return value is the requests
        completed by this call — ``self.finished`` keeps the all-time
        list (admission-rejected requests land in ``self.rejected``,
        never here)."""
        done: List[Request] = []
        ticks = 0
        while self.pending:
            done += self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("scheduler loop did not converge")
        return done

    def run_for(self, seconds: float) -> List[Request]:
        """Serve until the wall budget is spent or the queue drains;
        returns the requests completed by this call.  A pass begun for
        the tick after the budget expired stays in flight — a later run
        call fences it; call :meth:`close` instead to cancel it."""
        t0 = self.clock()
        done: List[Request] = []
        while self.pending and (self.clock() - t0) < seconds:
            done += self.tick()
        return done

    def close(self) -> None:
        """Early exit: cancel/drain a page pass begun for a tick that
        will never run, so nothing leaks past teardown (the engine's
        pager itself is owned by the caller / pool)."""
        self.engine.cancel_tick_params()

    def faults_summary(self) -> Dict[str, int]:
        """The metrics ``faults`` section for this scheduler: the
        engine's store-level fault counters plus the ticks this scheduler
        deferred on a fetch deadline."""
        out = self.engine.faults_summary()
        out["deferred_ticks"] = self.deferred_ticks
        return out

    # -- trace introspection ---------------------------------------------------
    def trace_summary(self) -> Dict[str, object]:
        """The metrics ``trace`` section for this scheduler: tracer
        event/track counts (zeros when un-traced) and the run's
        predicted-vs-measured exposed-stall ratio.  The ratio is the
        summed closed-form prediction over the summed fence-measured
        exposure; 1.0 means the stall model matched reality (vacuously
        so for runs that never paged)."""
        meas, pred = self._meas_exposed_s, self._pred_exposed_s
        if meas > 0.0:
            ratio = pred / meas
        else:
            ratio = 1.0 if pred <= 0.0 else 0.0
        tr = self.tracer
        return dict(
            events=0 if tr is None else tr.event_count,
            tracks=[] if tr is None else tr.track_names,
            predicted_vs_measured_stall_ratio=ratio)
