"""Batched serving engine over the packed At-MRAM weight store
(reference: ``repro/serving/engine.py``).

A continuous-batching loop, as in the reference:

  * requests join a waiting queue and are admitted into free batch slots;
  * prompts prefill in power-of-two **buckets** (left-aligned, right-padded)
    for the dense and SSM families: the causal mask keeps the pads invisible
    to real tokens, and the SSM mixer turns them into exact state no-ops
    given each row's real length.  The hybrid family (hymba) prefills each
    prompt exact-length in one shot, with its meta-token prefix.  All fresh
    slots of a (bucket, prefix) group prefill in ONE batched call: gather the
    slots' cache rows (the KV rows sliced to the ``kv_span`` the chunk can
    reach, and the SSM state), run a batch step padded to the slot count,
    scatter the rows back.  The MoE family prefills exact-length too, and
    one slot at a time: expert capacity is shared by every token of a call,
    so a pad or a co-batched prompt would change a real token's routing;
  * one batched decode step serves every decode-ready slot each tick, with
    per-slot sampling at each request's own temperature; slots that are
    empty or still prefilling park their KV write at the scratch row
    ``max_len - 1``, and a still-prefilling slot's SSM state is saved
    around the step and put back.  Under MoE the parked rows route and take
    expert capacity like real ones, as in the reference;
  * finished sequences free their slot at once, and a reused slot's SSM
    state starts cold; ``preempt`` / ``restore`` hand a slot over
    mid-request, bit-exactly, KV rows and SSM state alike;
  * with :meth:`attach_paging`, the plan's cold parameters live on the host
    and stream device-ward every tick through ``core/paging``'s
    ``HostPagedStore`` (§II-B2 virtual paging, swap / miss / stall counters
    kept); with ``wire_serve=True`` its re-encoded int8 cold pages are
    multiplied straight from their wire form by the blockscale kernel.
    With ``pool=`` the store joins a
    :class:`~repro_torch.core.paging.SharedPagePool`, one device-bytes
    budget shared with other tenants (:mod:`repro_torch.serving.tenancy`);
  * with :meth:`attach_kv_paging`, the completed ``block_rows``-row blocks
    of every slot's KV cache live on the host (``KVPageTable``), written
    back once when the frontier crosses them; each tick the live slots'
    blocks stream back, through the same pool when there is one, and are
    scattered over the device cache in one indexed copy a part.
    :meth:`begin_tick_params` kicks a tick's weight and KV passes while the
    caller computes and :meth:`fence_tick_params` joins them at first use
    (under an optional deadline); :meth:`tick_params` is the blocking begin
    + fence that ``step`` uses.

The engine owns mechanism only.  Policy (deadlines, priorities, chunk
pacing, the token budget, preemption, metrics) lives in
:class:`repro_torch.serving.sched.Scheduler`, which drives the tick
primitives: ``begin_tick_params`` / ``fence_tick_params`` /
``cancel_tick_params`` / ``has_tick_after`` / ``assign`` / ``preempt`` /
``restore`` / ``prefill_tick(chunk=, plan=)`` / ``decode_tick`` /
``sync_kv_tick``.  :meth:`set_tracer` puts the engine's fences and the
pager's page fetches on a :class:`~repro_torch.serving.trace.Tracer`.

The reference compiles one program per (bucket, kv span); PyTorch runs
eagerly, so there is nothing to cache beyond the per-layer parameter views.
Sampling draws from an explicit ``torch.Generator`` on the engine's device
(the reference splits ``jax.random`` keys; the two agree at temperature 0).

Not ported yet: paging across a mesh (``mesh=``: ROADMAP A11) and the
wire-served paging of a MoE store (``attach_paging(wire_serve=True)``: its
experts would need the grouped blockscale kernel, ROADMAP B item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, device_of, resolve_device
from repro_torch.core.faults import merge_fault_counters
from repro_torch.core.paging import (HostPagedStore, KVPageTable,
                                     packed_tree_store, thread_packed)
from repro_torch.core.placement import PlacementPlan, as_plan
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.trace import now as _now


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 1.0) -> torch.Tensor:
    """logits (..., V) -> token ids (...,)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


def sample_token_batch(logits: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temperatures: Sequence[float]) -> torch.Tensor:
    """Per-row sampling: logits (B, V) with host temperatures (B,).  Row b is
    greedy when ``temperatures[b] <= 0`` and otherwise sampled at its own
    temperature."""
    greedy = torch.argmax(logits, dim=-1)
    temps_np = np.asarray(temperatures, np.float32)
    if not (temps_np > 0).any():
        return greedy
    temps = torch.as_tensor(temps_np, device=logits.device)
    safe = torch.clamp(temps, min=1e-6)[:, None]
    probs = torch.softmax(logits.to(torch.float32) / safe, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temps <= 0.0, greedy, sampled)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    # deadline-aware scheduling (serving.sched): latency bound in ms from
    # arrival to the last token, None = best effort; priority None takes
    # the stream's default
    deadline_ms: Optional[float] = None
    priority: Optional[int] = None
    stream: str = "default"
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # retired because the KV cache ran out before max_new_tokens
    truncated: bool = False
    prefill_pos: int = 0               # prompt tokens already prefilled
    arrival_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    # the monotonic submission sequence (the admission tie-break), the
    # admission-control verdicts, and the preemptions suffered
    seq: Optional[int] = None
    rejected: bool = False             # admission control refused it
    degraded: bool = False             # max_new_tokens cut to fit
    preemptions: int = 0


@dataclasses.dataclass
class SlotCheckpoint:
    """Bit-exact resumable snapshot of one preempted batch slot: the slot's
    valid KV rows ``[0, valid)`` and its SSM state as host (CPU) tensor
    copies, plus the request, which carries its chunk frontier and the
    tokens so far."""
    req: Request
    slot_pos: int
    valid: int
    kv: Optional[Dict[str, torch.Tensor]] = None
    ssm: Optional[Dict[str, torch.Tensor]] = None


class ServingEngine:
    """``plan`` is the per-parameter weight placement
    (:class:`~repro_torch.core.placement.PlacementPlan`); the legacy
    ``engine`` dict ({"scenario", "mode", "bits"}) is accepted too.
    ``device`` defaults to ``cuda`` and must be where ``params`` lie."""

    def __init__(self, cfg: ModelConfig, params: Any, *, batch_slots: int = 4,
                 max_len: int = 512, engine: Optional[Dict] = None,
                 plan: Optional[PlacementPlan] = None, seed: int = 0,
                 prefill_chunk: int = 64, device: DeviceLike = None):
        tfm.check_family(cfg)
        self.device = resolve_device(device)
        p_dev = device_of(params)
        if p_dev is not None and p_dev.type != self.device.type:
            raise ValueError(f"params lie on {p_dev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self._layers = tfm.layer_params(params, cfg)
        self.slots = batch_slots
        self.max_len = max_len
        if plan is not None and engine is not None:
            raise ValueError("pass either plan= or the legacy engine=, "
                             "not both")
        self.plan = plan if plan is not None else as_plan(engine)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # pad-safe bucketing: attention hides pads behind the causal mask and
        # the pure-SSM mixer masks them into exact state no-ops; hybrid and
        # MoE (whose capacity routing a pad would contend) keep exact-length
        # single-shot prefill, as in the reference
        self._bucketed = cfg.family in ("dense", "ssm")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.prefill_chunk = _next_pow2(prefill_chunk)

        self.cache = tfm.init_serve_cache(cfg, batch_slots, max_len,
                                          device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        # every slot handover (assign, preempt, restore, retire) bumps the
        # slot's generation: a KV pass begun under an older generation must
        # not scatter its rows over the slot's new occupant
        self._slot_gen = np.zeros(batch_slots, np.int64)
        self._kv_begun_gen: Optional[np.ndarray] = None
        self.preempt_count = 0
        self.restore_count = 0

        # §II-B2 weight paging (attach_paging).  paging_stall_s holds the
        # EXPOSED wait (what blocked a tick), paging_hidden_s the stream
        # time hidden behind the caller's compute
        self.pager: Optional[HostPagedStore] = None
        self.page_resident_slots = 2
        self.paging_stall_s = 0.0
        self.paging_hidden_s = 0.0
        self.last_stall_s = 0.0
        self.last_hidden_s = 0.0
        # split of the last fenced pass: swap_s, window_s, exposed_s,
        # hidden_s (the memsys.overlap_stall identity)
        self.last_overlap: Optional[Dict[str, float]] = None
        self._inflight_pass = None        # AsyncPageStream begun, unfenced

        # KV-cache paging (attach_kv_paging), through the same pool budget
        # and the same begin / fence overlap; kv_stall_s / kv_hidden_s are
        # the KV share of paging_stall_s / paging_hidden_s
        self.kv_table: Optional[KVPageTable] = None
        self._inflight_kv = None          # KVPageStream begun, unfenced
        self.kv_stall_s = 0.0
        self.kv_hidden_s = 0.0
        self.last_kv_overlap: Optional[Dict[str, float]] = None
        self._kv_synced = np.zeros(batch_slots, np.int64)  # blocks on host
        # opt-in chrome trace (set_tracer): the untraced fence pays one
        # branch
        self.tracer = None
        self.trace_track = "serve"

    # -- §II-B2: weight paging -----------------------------------------------
    def attach_paging(self, page_bytes: Optional[int] = None,
                      resident_slots: int = 2, *, pool: Optional[Any] = None,
                      name: Optional[str] = None,
                      faults: Optional[Any] = None, wire_serve: bool = False,
                      mesh: Optional[Any] = None,
                      shard_budget_bytes: Optional[int] = None
                      ) -> "ServingEngine":
        """Put the plan's paged parameters behind a
        :class:`~repro_torch.core.paging.HostPagedStore`
        (``repro/serving/engine.py:299-398``).

        The plan's resident set is put on the device once; every cold
        parameter group is evacuated to its host image and streamed to the
        device each tick (:meth:`tick_params`).  ``page_bytes`` defaults to
        the largest cold group (one page per group).  ``faults`` (a
        FaultPlan or FaultInjector) puts every fetch under seeded fault
        injection with CRC-verified retry.  ``wire_serve=True`` serves
        int8-re-encoded cold pages straight from their wire form: the fetch
        skips the host decode and ``linear`` sends those params to the
        blockscale kernel.  With ``pool`` (a
        :class:`~repro_torch.core.paging.SharedPagePool`) the store joins
        the pool's shared budget under ``name`` instead of keeping a
        private cache: the tenancy path.

        After this call ``self.params`` holds the resident groups on the
        device and the cold groups' HOST (CPU tensor) view: on a card, a
        step that computed with it instead of the streamed pages would make
        the kernel wrappers raise.  ``mesh=`` (sharded paging, ROADMAP A11)
        is not ported."""
        if mesh is not None or shard_budget_bytes is not None:
            raise NotImplementedError("mesh-sharded paging arrives with "
                                      "ROADMAP A11")
        if resident_slots < 1:
            raise ValueError(f"resident_slots must be >= 1, got "
                             f"{resident_slots}")
        if self.pager is not None:
            raise ValueError("paging is already attached")
        if wire_serve and self.cfg.family == "moe":
            raise NotImplementedError(
                f"{self.cfg.name}: wire-served paging of a MoE store would "
                "multiply the experts' cold pages by the blockscale kernel "
                "grouped over experts, which is not ported (ROADMAP B item "
                "6)")
        if wire_serve:
            # before the store is built, so that the fetch path and the
            # model's linear dispatch read the same plan
            self.plan = self.plan.replace(wire_serve=True)
        store = packed_tree_store(self.params, self.plan)
        paged = [n for n in store.params
                 if self.plan.placement_for(n).paged]
        if not paged:
            raise ValueError("plan has no paged parameters; nothing to "
                             "stream: use the engine without paging")
        if page_bytes is None:
            page_bytes = max(store.params[n].nbytes_packed for n in paged)
        self.pager = HostPagedStore(store, page_bytes, device=self.device,
                                    plan=self.plan, pool=pool,
                                    name=name if name is not None
                                    else "default", faults=faults)
        self.page_resident_slots = resident_slots
        host_view = self.pager.template_view()
        self.params = thread_packed(self.params,
                                    {**self.pager.resident, **host_view})
        self._layers = tfm.layer_params(self.params, self.cfg)
        if self.tracer is not None:
            self.set_tracer(self.tracer)   # reach the new store and pool
        return self

    # -- KV-cache paging through the same pool --------------------------------
    def attach_kv_paging(self, block_rows: int = 16, *,
                         pool: Optional[Any] = None,
                         name: Optional[str] = None,
                         faults: Optional[Any] = None) -> "ServingEngine":
        """Page the per-slot KV cache through the same device-bytes budget
        and the same begin / fence overlap as the weight pages
        (``repro/serving/engine.py:431-470``).

        The device cache stays the compute buffer, but the authoritative
        copy of every completed ``block_rows``-row block lives in a
        :class:`~repro_torch.core.paging.KVPageTable` host image: written
        back once when the frontier crosses it, and each tick the live
        slots' completed blocks stream back device-ward beside the weight
        pages.  With ``pool`` the table joins the shared budget under
        ``name`` (default ``<weights name>/kv``); without one every block
        swaps every pass.  Attach before serving: the table snapshots the
        (idle) cache."""
        if "kv" not in self.cache:
            raise ValueError(f"family {self.cfg.family!r} has no KV cache "
                             "to page (recurrent state is not paged)")
        if self.kv_table is not None:
            raise ValueError("KV paging already attached")
        if self.waiting or any(r is not None for r in self.slot_req):
            raise ValueError("attach_kv_paging before submitting work: "
                             "the host image snapshots an idle cache")
        if name is None:
            name = (self.pager.name if self.pager is not None
                    else "default") + "/kv"
        self.kv_table = KVPageTable(self.cache["kv"], block_rows=block_rows,
                                    pool=pool, name=name, device=self.device,
                                    faults=faults)
        self._kv_synced[:] = 0
        if self.tracer is not None:
            self.set_tracer(self.tracer)   # reach the new table and pool
        return self

    def set_tracer(self, tracer, track: Optional[str] = None
                   ) -> "ServingEngine":
        """Attach (or, with None, detach) a
        :class:`~repro_torch.serving.trace.Tracer` to the engine and every
        paging component it owns (the paged store, the KV page table and
        their pool), so that one trace shows the scheduler's phases, the
        fence stalls, the per-page fetches, evictions and pool occupancy
        together.  ``track`` names this engine's rows.  Paging attached
        later picks it up too."""
        self.tracer = tracer
        if track is not None:
            self.trace_track = track
        for part in (self.pager, self.kv_table):
            if part is not None:
                part.tracer = tracer
                if part.pool is not None:
                    part.pool.tracer = tracer
        return self

    def _kv_full_blocks(self) -> Dict[int, int]:
        """{slot: host-synced completed-block count} over the occupied
        slots: the span map one KV pass fetches.  The *synced* count (not
        the frontier) keeps a just-restored preemption victim safe: its
        blocks live only in the device cache until ``sync_kv_tick`` writes
        them back again."""
        out = {}
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            full = int(self._kv_synced[i])
            if full > 0:
                out[i] = full
        return out

    def _scatter_kv(self, blocks: Dict[int, Dict[str, torch.Tensor]]
                    ) -> None:
        """Fetched KV blocks -> the device cache, in one indexed copy a part
        on the compute stream.  A slot retired since the pass began, or
        handed over (its generation moved: preempt, restore, assign), is
        skipped: those rows belong to its previous occupant."""
        nb, br = self.kv_table.n_blocks, self.kv_table.block_rows
        keep = []
        for page in sorted(blocks):        # slot-major, block-ascending
            slot, blk = divmod(page, nb)
            if self.slot_req[slot] is None:
                continue
            if (self._kv_begun_gen is not None
                    and self._kv_begun_gen[slot] != self._slot_gen[slot]):
                continue
            keep.append((slot, blk, blocks[page]))
        if not keep:
            return
        slots: List[int] = []
        rows: List[int] = []
        for slot, blk, kv in keep:
            n = kv["k"].shape[2]
            slots += [slot] * n
            rows += range(blk * br, blk * br + n)
        s_idx = self._to_device(np.asarray(slots, np.int64), torch.long)
        r_idx = self._to_device(np.asarray(rows, np.int64), torch.long)
        for part, c in self.cache["kv"].items():
            # (L, H, R, D) -> the (R, L, H, D) that c[:, slots, :, rows]
            # selects: the two index tensors' dim goes first
            data = torch.cat([kv[part] for _s, _b, kv in keep], dim=2)
            c[:, s_idx, :, r_idx] = data.permute(2, 0, 1, 3)

    def sync_kv_tick(self) -> None:
        """End-of-tick writeback, which the scheduler's tick and ``step``
        call: blocks the append-only frontier completed this tick move
        device->host once, fetchable (and poolable) from the next pass
        on."""
        if self.kv_table is None:
            return
        block = self.kv_table.block_rows
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            full = self._kv_valid(i) // block
            if full > self._kv_synced[i]:
                self.kv_table.writeback(i, int(self._kv_synced[i]), full,
                                        self.cache["kv"])
                self._kv_synced[i] = full

    def begin_tick_params(self) -> None:
        """Kick the overlapped host->device page stream for the next fence
        and return at once (a no-op without paging, or with a pass in
        flight): the fetch loop runs on the pager's worker while the
        caller computes.  With KV paging the live slots' completed blocks
        ride the same stream (blocks completed after this begin are
        demand-fetched at the fence)."""
        kicked = []
        if self.pager is not None and self._inflight_pass is None:
            self._inflight_pass = self.pager.begin_pass(
                self.page_resident_slots)
            kicked.append("weights")
        if self.kv_table is not None and self._inflight_kv is None:
            self._kv_begun_gen = self._slot_gen.copy()
            self._inflight_kv = self.kv_table.begin_pass(
                self._kv_full_blocks())
            kicked.append("kv")
        if kicked and self.tracer is not None:
            self.tracer.instant("begin_pass", track=self.trace_track,
                                streams="+".join(kicked))

    def fence_tick_params(self, timeout_s: Optional[float] = None) -> Any:
        """The params tree for this tick, fencing at first use.  Without
        paging it is the resident tree.  With paging the in-flight passes
        (demand-begun here if none is) are joined, the weight pages
        threaded into the template, the KV blocks scattered over the cache,
        and each pass's wait split into the exposed part (this call
        blocked) and the hidden part.

        ``timeout_s`` bounds the wait: on expiry
        :class:`~repro_torch.core.faults.PageFetchTimeout` is raised with
        the passes still in flight and owned by the engine (nothing
        threaded or scattered, no stall booked), and the next call resumes
        the same passes (a fenced stream's result is kept)."""
        self.last_stall_s = 0.0
        self.last_hidden_s = 0.0
        if self.pager is None and self.kv_table is None:
            return self.params
        demand = self._inflight_pass is None and self._inflight_kv is None
        if demand:
            self.begin_tick_params()
        ps, ks = self._inflight_pass, self._inflight_kv
        dev = ps.fence(timeout_s=timeout_s) if ps is not None else None
        blocks = (ks.fence(self._kv_full_blocks(), timeout_s=timeout_s)
                  if ks is not None else None)
        self._inflight_pass = None
        self._inflight_kv = None
        params = self.params
        if ps is not None:
            self.last_overlap = self._account_fence(
                ps, demand, self.pager.pool, self.pager.name)
            # the reference caches a flattened template (engine.py:399-430)
            # to spare a pytree walk a tick; threading the port's nested
            # dicts rebuilds a few dozen dicts and copies no tensor
            params = thread_packed(self.params, dev)
        if ks is not None:
            self.last_kv_overlap = self._account_fence(
                ks, demand, self.kv_table.pool, self.kv_table.name, kv=True)
            self._scatter_kv(blocks)
            # retired slots' pooled blocks go on the pool's fetch worker,
            # after every fetch queued before them: no late fetch brings
            # one back, and the drop's place in the log is the traffic's
            self.kv_table.flush_drops()
        return params

    def _account_fence(self, ps, demand: bool, pool, name: str,
                       kv: bool = False) -> Dict[str, float]:
        """Book one fenced pass's stall split, weight or KV.  A pass
        demand-begun inside this fence spent its whole wall blocked here:
        all of it lands exposed, none hidden."""
        exposed, hidden, window = ps.exposed_s, ps.hidden_s, ps.window_s
        if demand:
            exposed, hidden, window = exposed + hidden, 0.0, 0.0
        self.last_stall_s += exposed
        self.last_hidden_s += hidden
        self.paging_stall_s += exposed
        self.paging_hidden_s += hidden
        if kv:
            self.kv_stall_s += exposed
            self.kv_hidden_s += hidden
        if pool is not None:
            pool.add_stall(name, exposed, hidden)
        tr = self.tracer
        if tr is not None:
            # retro-dated so that [hidden][exposed] render as one swap bar
            # ending at the fence: the spans that reconcile with the
            # metrics' exposed_s / hidden_s
            stream = "kv" if kv else "weights"
            track = f"{self.trace_track}:stall"
            if hidden > 0.0:
                tr.complete(f"hidden:{stream}", hidden, track=track,
                            end_offset_s=exposed, swap_ms=ps.swap_s * 1e3)
            tr.complete(f"exposed:{stream}", exposed, track=track,
                        demand=demand, window_ms=window * 1e3)
        return dict(swap_s=ps.swap_s, window_s=window, exposed_s=exposed,
                    hidden_s=hidden)

    def cancel_tick_params(self) -> None:
        """Cancel or drain passes begun for a tick that will never run
        (an early scheduler exit), so that no worker fetch, and no pool
        guard, outlives them."""
        if self._inflight_pass is not None:
            self._inflight_pass.close()
            self._inflight_pass = None
        if self._inflight_kv is not None:
            self._inflight_kv.close()
            self._inflight_kv = None

    def tick_params(self) -> Any:
        """Blocking begin + fence: the stream's whole wall lands exposed."""
        self.begin_tick_params()
        return self.fence_tick_params()

    def has_tick_after(self, chunk: Optional[int] = None,
                       plan: Optional[Dict[int, int]] = None) -> bool:
        """Will the engine still hold work after one more scheduler-paced
        tick (prefill at ``chunk`` pacing, or at the per-slot ``plan``
        allocations of a budgeted tick)?  The scheduler begins the next
        pass only then: a pass no tick consumes would stream an extra pass
        and move the swap counters off ``ticks x pass_counters``.  It
        mirrors the tick's own retirement rules; in doubt it answers False
        (a missed overlap costs time, a phantom pass determinism)."""
        if self.waiting:
            return True
        prefix = self.cfg.n_meta_tokens
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            remaining = len(r.prompt) - r.prefill_pos
            if remaining > 0:
                if plan is not None:
                    if plan.get(i, 0) <= 0:
                        return True      # unscheduled: the frontier stays
                    n, _b, _p, _q = self._chunk_shape(r, plan[i])
                else:
                    n, _b, _p, _q = self._chunk_shape(r, chunk)
                if n < remaining:
                    return True          # more prefill chunks after this
                # prefill completes this tick and the same tick's decode
                # already sees it, so the slot leaves with two tokens
                # unless max_new retires it at one
                if (r.max_new_tokens > 2
                        and prefix + len(r.prompt) + 1 < self.max_len - 1):
                    return True
            elif (len(r.generated) + 1 < r.max_new_tokens
                    and self.slot_pos[i] + 1 < self.max_len - 1):
                return True              # survives this decode tick
        return False

    @property
    def swap_count(self) -> int:
        return 0 if self.pager is None else self.pager.swap_count

    @property
    def miss_count(self) -> int:
        return 0 if self.pager is None else self.pager.miss_count

    def paging_summary(self) -> Dict[str, Any]:
        """The page streams' counters under the reference's keys (the
        ``kv_*`` keys the KV share), plus the weight fetch worker's host
        seconds: ``decode_s``, ``crc_s`` and ``copy_s``."""
        total = self.paging_stall_s + self.paging_hidden_s
        pg, kv = self.pager, self.kv_table
        return dict(
            swap_count=self.swap_count, miss_count=self.miss_count,
            exposed_s=self.paging_stall_s, hidden_s=self.paging_hidden_s,
            overlap_frac=(self.paging_hidden_s / total) if total > 0 else 0.0,
            stall_s=self.paging_stall_s,
            n_pages=0 if pg is None else len(pg.pages),
            bytes_streamed_wire=0 if pg is None else pg.bytes_streamed_wire,
            bytes_streamed_raw=0 if pg is None else pg.bytes_streamed_raw,
            decode_skipped_bytes=(0 if pg is None
                                  else pg.decode_skipped_bytes),
            decode_s=0.0 if pg is None else pg.decode_s,
            crc_s=0.0 if pg is None else pg.crc_s,
            copy_s=0.0 if pg is None else pg.copy_s,
            kv_swaps=0 if kv is None else kv.swap_count,
            kv_pool_hits=0 if kv is None else kv.pool_hits,
            kv_writebacks=0 if kv is None else kv.writebacks,
            kv_dropped=0 if kv is None else kv.dropped,
            kv_preempt_drops=0 if kv is None else kv.preempt_drops,
            kv_exposed_s=self.kv_stall_s, kv_hidden_s=self.kv_hidden_s,
            kv_block_rows=0 if kv is None else kv.block_rows,
            # the per-device rows of a mesh-sharded store (ROADMAP A11)
            devices=[])

    def faults_summary(self) -> Dict[str, int]:
        """Fault-path counters summed over the engine's paging components
        (weight pager and KV table)."""
        return merge_fault_counters([s.fault_counters
                                     for s in (self.pager, self.kv_table)
                                     if s is not None])

    def _step(self, params: Any, tokens: torch.Tensor, cache: Dict[str, Any],
              pos: torch.Tensor, **kw) -> Tuple[torch.Tensor, Dict[str, Any]]:
        layers = self._layers if params is self.params else None
        return tfm.step(params, tokens, cache, pos, self.cfg,
                        engine=self.plan, layers=layers, **kw)

    def _to_device(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    # -- slot management --------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._check_fits(req)
        if req.arrival_s is None:
            req.arrival_s = _now()
        self.waiting.append(req)

    def _check_fits(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError("empty prompt: nothing to condition on (and "
                             "no first token to decode from)")
        if self.cfg.n_meta_tokens and len(req.prompt) < 2:
            # a 1-token prompt takes the decode path (S == 1), which cannot
            # build the meta-token prefix the positions assume
            raise ValueError("meta-token models need prompts of >= 2 "
                             "tokens (single-token prefill cannot build "
                             "the prefix)")
        prefix = self.cfg.n_meta_tokens
        if prefix + len(req.prompt) + 1 > self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens (+{prefix} prefix) "
                f"does not fit max_len={self.max_len}")

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def assign(self, req: Request, slot: int) -> None:
        """Bind a request to a batch slot (prefill starts next tick pass)."""
        if self.slot_req[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        self._check_fits(req)
        if req.arrival_s is None:
            req.arrival_s = _now()
        req.prefill_pos = 0
        self._slot_gen[slot] += 1
        if self.kv_table is not None:
            # the previous occupant's pooled blocks were queued for drop at
            # its retirement and flush at the next fence, before this
            # request's first writeback; only the sync count resets here
            self._kv_synced[slot] = 0
        if "ssm" in self.cache:
            # recurrent state is live across the whole row (no position mask
            # hides a predecessor's leftovers), so a reused slot starts cold
            for c in self.cache["ssm"].values():
                c[:, slot] = 0
        self.slot_req[slot] = req

    def _kv_valid(self, i: int) -> int:
        """Valid KV rows of slot ``i``: the prompt prefix absorbed so far,
        then ``slot_pos`` once decoding."""
        r = self.slot_req[i]
        if r is None or r.prefill_pos == 0:
            return 0
        if r.prefill_pos < len(r.prompt):
            return self.cfg.n_meta_tokens + r.prefill_pos
        return int(self.slot_pos[i])

    def preempt(self, slot: int) -> SlotCheckpoint:
        """Evict the request occupying ``slot`` mid-service and return a
        bit-exact resumable :class:`SlotCheckpoint`.  The device cache is
        authoritative for an occupied slot.  Its pooled KV blocks are
        released as on a retirement: flushed now when no KV pass is in
        flight, else at that pass's fence."""
        req = self.slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty; nothing to preempt")
        valid = self._kv_valid(slot)
        kv = ssm = None
        if "kv" in self.cache and valid > 0:
            kv = {n: c[:, slot, :, :valid].to("cpu", copy=True)
                  for n, c in self.cache["kv"].items()}
        if "ssm" in self.cache:
            ssm = {n: c[:, slot].to("cpu", copy=True)
                   for n, c in self.cache["ssm"].items()}
        ckpt = SlotCheckpoint(req=req, slot_pos=int(self.slot_pos[slot]),
                              valid=int(valid), kv=kv, ssm=ssm)
        req.preemptions += 1
        self.slot_req[slot] = None
        self._slot_gen[slot] += 1
        self.preempt_count += 1
        if self.kv_table is not None:
            self.kv_table.preempt_release(
                slot, in_flight=self._inflight_kv is not None)
            self._kv_synced[slot] = 0
        return ckpt

    def restore(self, ckpt: SlotCheckpoint, slot: int) -> None:
        """Rebind a preempted request to a free slot and scatter its
        checkpointed cache rows back; decode resumes from
        ``generated[-1]``, chunked prefill from its chunk frontier.  The KV
        host image is not written here: the sync count restarts at 0 and
        the next ``sync_kv_tick`` writes the completed blocks back."""
        if self.slot_req[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        self.slot_req[slot] = ckpt.req
        self.slot_pos[slot] = ckpt.slot_pos
        self._slot_gen[slot] += 1
        self.restore_count += 1
        if ckpt.kv is not None:
            for n, c in self.cache["kv"].items():
                c[:, slot, :, :ckpt.valid] = ckpt.kv[n].to(c.device, c.dtype)
        if ckpt.ssm is not None:
            for n, c in self.cache["ssm"].items():
                c[:, slot] = ckpt.ssm[n].to(c.device, c.dtype)
        if self.kv_table is not None:
            self._kv_synced[slot] = 0

    @property
    def pending(self) -> bool:
        return bool(self.waiting
                    or any(r is not None for r in self.slot_req))

    # -- tick primitives ----------------------------------------------------------
    def _chunk_shape(self, req: Request, chunk: Optional[int] = None
                     ) -> Tuple[int, int, bool, int]:
        """(n_tokens, bucket, add_prefix, insert_pos) of the next chunk, at
        ``chunk`` tokens (default: the engine's pacing)."""
        prefix = self.cfg.n_meta_tokens
        remaining = len(req.prompt) - req.prefill_pos
        if self._bucketed:
            n = min(chunk if chunk is not None else self.prefill_chunk,
                    remaining)
            bucket = _next_pow2(n)
            # never let the padded window spill past the cache: near the end
            # shrink to the largest power of two that still fits
            avail = self.max_len - prefix - req.prefill_pos
            if bucket > avail:
                bucket = _pow2_floor(avail)
                n = min(bucket, remaining)
        else:
            n = bucket = remaining      # exact-length single shot (hybrid, MoE)
        first = req.prefill_pos == 0
        # the prefix is prepended on the first chunk only; the flag stays
        # True for prefix-free models so that it never splits a group
        add_prefix = first if prefix else True
        insert_pos = 0 if first else prefix + req.prefill_pos
        return n, bucket, add_prefix, insert_pos

    def prefill_tick(self, params: Any, complete: bool = False,
                     chunk: Optional[int] = None,
                     plan: Optional[Dict[int, int]] = None
                     ) -> List[Request]:
        """Advance every prefilling slot by one chunk (``complete=True``
        loops until all prompts are absorbed).  ``chunk`` (a power of two)
        overrides the engine's pacing for this call; ``plan`` ({slot: token
        allocation}, a budgeted scheduler tick) prefills only the listed
        slots, each at its own allocation, and the others hold their
        frontier.  Slots whose prompt completes sample their first token.
        Returns the requests that got their first token this call."""
        if complete and plan is not None:
            raise ValueError("plan= paces one scheduler tick; it cannot "
                             "be combined with complete=True")
        started: List[Request] = []
        while True:
            pending = [(i, r) for i, r in enumerate(self.slot_req)
                       if r is not None and r.prefill_pos < len(r.prompt)
                       and (plan is None or plan.get(i, 0) > 0)]
            if not pending:
                break
            groups: Dict[Tuple[int, bool],
                         List[Tuple[int, Request, int, int]]] = {}
            for i, r in pending:
                c = plan[i] if plan is not None else chunk
                n, bucket, add_prefix, pos = self._chunk_shape(r, c)
                groups.setdefault((bucket, add_prefix),
                                  []).append((i, r, n, pos))
            for (bucket, add_prefix), rows in groups.items():
                self._run_prefill_group(params, bucket, add_prefix, rows,
                                        started)
            if not complete:
                break
        return started

    def _kv_span_for(self, bucket: int,
                     rows: List[Tuple[int, Request, int, int]]
                     ) -> Optional[int]:
        """KV span one prefill group attends: the next power of two covering
        every row's ``insert_pos + bucket`` (plus the meta-token prefix on
        first chunks), clamped to ``max_len``; None without a KV cache."""
        if "kv" not in self.cache:
            return None
        prefix = self.cfg.n_meta_tokens
        need = max((prefix if r.prefill_pos == 0 else 0) + pos + bucket
                   for _i, r, _n, pos in rows)
        return min(self.max_len, _next_pow2(need))

    def _run_prefill_group(self, params: Any, bucket: int, add_prefix: bool,
                           rows: List[Tuple[int, Request, int, int]],
                           started: List[Request]) -> None:
        """One batched prefill call for a (bucket, prefix) group, padded to
        the slot count; under MoE one call a slot, batch 1
        (``repro/serving/engine.py:1017-1025``): expert capacity is shared
        by the call's tokens, so padding rows or co-batched prompts could
        displace a real token's routing."""
        if self.cfg.family == "moe":
            for row in rows:
                self._run_prefill_rows(params, bucket, add_prefix, [row], 1,
                                       started)
            return
        self._run_prefill_rows(params, bucket, add_prefix, rows, self.slots,
                               started)

    def _run_prefill_rows(self, params: Any, bucket: int, add_prefix: bool,
                          rows: List[Tuple[int, Request, int, int]], k: int,
                          started: List[Request]) -> None:
        """One prefill call over ``rows``, padded to ``k`` batch rows."""
        kv_span = self._kv_span_for(bucket, rows)
        tokens = np.zeros((k, bucket), np.int64)
        slot_idx = np.zeros((k,), np.int64)
        pos_vec = np.zeros((k,), np.int32)
        lengths = np.zeros((k,), np.int32)
        for j in range(k):
            # rows beyond the group repeat the last row: the duplicate
            # scatter writes identical values
            i, r, n, pos = rows[min(j, len(rows) - 1)]
            tokens[j, :n] = r.prompt[r.prefill_pos:r.prefill_pos + n]
            slot_idx[j] = i
            pos_vec[j] = pos
            lengths[j] = n
        sidx = self._to_device(slot_idx, torch.long)
        sub: Dict[str, Any] = {}
        if "kv" in self.cache:
            sub["kv"] = {n: c[:, sidx, :, :kv_span]
                         for n, c in self.cache["kv"].items()}
        if "ssm" in self.cache:
            sub["ssm"] = {n: c[:, sidx] for n, c in self.cache["ssm"].items()}
        # the SSM rows need each row's real-token count so that the bucket's
        # pads are state no-ops; attention hides them by the causal mask
        lens = (self._to_device(lengths, torch.int32)
                if self._bucketed and "ssm" in self.cache else None)
        logits, sub = self._step(params, self._to_device(tokens, torch.long),
                                 sub, self._to_device(pos_vec, torch.int32),
                                 add_prefix=add_prefix, lengths=lens)
        if "kv" in self.cache:
            for n, c in self.cache["kv"].items():
                c[:, sidx, :, :kv_span] = sub["kv"][n]
        if "ssm" in self.cache:
            for n, c in self.cache["ssm"].items():
                c[:, sidx] = sub["ssm"][n]
        for j, (i, r, n, _pos) in enumerate(rows):
            r.prefill_pos += n
            if r.prefill_pos < len(r.prompt):
                continue                      # more chunks next tick
            tok = int(sample_token(logits[j, n - 1], self.generator,
                                   r.temperature))
            r.generated.append(tok)
            r.first_token_s = _now()
            self.slot_pos[i] = len(r.prompt) + self.cfg.n_meta_tokens
            started.append(r)
            if len(r.generated) >= r.max_new_tokens:
                self._retire(i)

    def decode_tick(self, params: Any) -> List[Request]:
        """One batched decode step over the decode-ready slots.  Slots that
        are empty or still prefilling park their write at the scratch row
        (max_len - 1), which real decoding never reaches and the cache-length
        mask never attends.  Returns the requests finished this tick."""
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and r.prefill_pos >= len(r.prompt)]
        if not active:
            return []
        tokens = np.zeros((self.slots, 1), np.int64)
        temps = np.zeros((self.slots,), np.float32)
        pos = np.full((self.slots,), self.max_len - 1, np.int32)
        for i in active:
            req = self.slot_req[i]
            tokens[i, 0] = req.generated[-1]
            temps[i] = req.temperature
            pos[i] = self.slot_pos[i]
        # a KV slot mid-prefill parks its write at the scratch row, but the
        # recurrent state has no position to park at: the batched decode
        # would advance a chunk-prefilling slot's state with a garbage
        # token, so those slots' state is saved and put back after
        parked = [i for i, r in enumerate(self.slot_req)
                  if r is not None and r.prefill_pos < len(r.prompt)]
        saved = None
        if parked and "ssm" in self.cache:
            p_idx = self._to_device(np.asarray(parked, np.int64), torch.long)
            saved = {n: c[:, p_idx] for n, c in self.cache["ssm"].items()}
        logits, self.cache = self._step(params,
                                        self._to_device(tokens, torch.long),
                                        self.cache,
                                        self._to_device(pos, torch.int32))
        if saved is not None:
            for n, c in self.cache["ssm"].items():
                c[:, p_idx] = saved[n]
        toks = sample_token_batch(logits[:, -1], self.generator,
                                  temps).tolist()
        finished: List[Request] = []
        for i in active:
            req = self.slot_req[i]
            req.generated.append(int(toks[i]))
            self.slot_pos[i] += 1
            if len(req.generated) >= req.max_new_tokens:
                finished.append(self._retire(i))
            elif self.slot_pos[i] >= self.max_len - 1:
                # cache exhausted mid-request: partial service
                req.truncated = True
                finished.append(self._retire(i))
        return finished

    def _retire(self, slot: int) -> Request:
        req = self.slot_req[slot]
        req.done = True
        req.finish_s = _now()
        self.finished.append(req)
        self.slot_req[slot] = None
        self._slot_gen[slot] += 1
        if self.kv_table is not None:
            self.kv_table.queue_drop(slot)
            self._kv_synced[slot] = 0
        return req

    # -- FIFO loop ----------------------------------------------------------------
    def _admit(self) -> None:
        for i in self.free_slots():
            if not self.waiting:
                break
            self.assign(self.waiting.pop(0), i)

    def step(self) -> List[Request]:
        """One engine tick: stream pages, admit FIFO, full prefill for the
        fresh slots, batched decode, retire.  Returns the requests finished
        this tick."""
        before = len(self.finished)
        params = self.tick_params()
        self._admit()
        self.prefill_tick(params, complete=True)
        self.decode_tick(params)
        self.sync_kv_tick()
        return self.finished[before:]

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        """Serve until the queue drains; returns the requests completed by
        THIS call (``self.finished`` keeps the all-time list)."""
        done: List[Request] = []
        ticks = 0
        while self.pending:
            done += self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("serving loop did not converge")
        return done
