"""Software-assisted virtual weight paging (paper §II-B2), on one device.

Ports the single-device part of ``repro/core/paging.py``: ``Page``,
``page_sizes``, ``page_crc`` and ``build_pages`` (``:56-208``); the static
schedule (``PageScheduleEntry``, ``StallModel``, ``make_schedule``,
``validate_schedule``, ``:210-297``); the page pool shared by tenants
(``SharedPagePool``, ``shared_pass_counters``, ``:299-570``); the host wire
images (``HostParam``, ``encode_host_param``, ``page_roundtrip_param``,
``page_crc_of_buffers``, ``retry_fetch``, ``:572-739``); ``HostPagedStore``,
``PageStream`` and ``AsyncPageStream`` (``:741-1229``); ``pass_counters``
(``:1231-1259``); KV-cache paging (``KVPageTable``, ``KVPageStream``,
``kv_pass_counters``, ``:1696-2176``); ``thread_packed`` and
``packed_tree_store`` (``:2179-2229``).

Packed weights whose plan placement is ``paged`` live on the host in their
page *wire* encoding ("background flash"); every pass streams them to the
device, page by page, in a static access order, each page CRC-checked over
its wire bytes before it is installed.  A re-encoded int8 page of a
``wire_serve`` plan goes to the device as it crossed the wire, packed
levels with one scale per 32 weights, and the blockscale kernel multiplies
it from that form; every other page is decoded on the host first.

Stores and KV page tables may join one :class:`SharedPagePool`: one
device-bytes budget, LRU eviction across its members, a page still cached
from an earlier pass served without a swap, and ONE fetch worker for every
member, so that overlapped passes of several tenants run in begin order and
the counters follow the :func:`kv_pass_counters` replay of the pool's event
log exactly.

On a CUDA device each host image is pinned once, when the store or table
is built.  The fetch worker copies a page with ``non_blocking=True`` on a
side CUDA stream, records an event and waits on it before the page's future
completes, so a fenced page is on the device and ``fence``'s exposed /
hidden split keeps its meaning.  The device tensors are allocated on the
side stream; when a pass hands a page over (``fence``, or the sync
stream's yield) they are marked (``record_stream``) for the stream current
then, so the caching allocator cannot give their memory to the next copy
while compute still reads it, even when a co-tenant's fetch evicts the
page from the pool meanwhile.

With a :class:`~repro_torch.serving.trace.Tracer` on ``store.tracer``
(``ServingEngine.set_tracer`` puts it there), every swap is a ``page``
(weights) or ``kv_block`` span on the ``io`` track, and every injected
fault and retry, pool eviction and KV drop an instant there.

Not ported here: the mesh-sharded stores (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import packing, quantize
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.faults import (FaultsArg, PageChecksumError,
                                     PageFetchError, PageFetchTimeout,
                                     ScheduleError, TransientFetchFault,
                                     as_injector, new_fault_counters)
from repro_torch.core.memsys import encoded_wire_bytes, overlap_stall
from repro_torch.core.placement import (Placement, PlacementPlan,
                                        wire_served_bits)
from repro_torch.core.weight_store import (SIRACUSA_MRAM_BYTES, PackedParam,
                                           WeightStore, flatten_tree)

# Scale-group width of the intN page wire codec (weights per f32 scale).
PAGE_ENC_BLOCK = quantize.PAGE_SCALE_BLOCK


def _np(t: Any) -> np.ndarray:
    """A host copy of a tensor (or array) as a writable numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.array(t)


def _cpu(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``, copied only when ``a`` is read-only."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


@dataclasses.dataclass(frozen=True)
class Page:
    """One unit of host->device streaming.

    ``nbytes`` is the *device* bytes the page occupies while cached,
    ``wire_nbytes`` what crosses the host->device link per swap (encoded
    payload plus the scales that travel with it), ``raw_nbytes`` the
    fp32-dense equivalent an unencoded stream would move (``== wire`` for
    the ``"fp"`` encoding).  ``encoding`` is shared by every param on the
    page; ``crc32`` chains the member params' wire CRCs (None: no host
    image was given)."""
    index: int
    param_names: Tuple[str, ...]
    nbytes: int
    wire_nbytes: Optional[int] = None
    raw_nbytes: Optional[int] = None
    encoding: str = "fp"
    crc32: Optional[int] = None

    def __post_init__(self):
        if self.wire_nbytes is None:
            object.__setattr__(self, "wire_nbytes", self.nbytes)
        if self.raw_nbytes is None:
            object.__setattr__(self, "raw_nbytes", self.wire_nbytes)


def page_sizes(pages: Sequence[Page]) -> List[Tuple[int, int, int]]:
    """``[(device, wire, raw), ...]`` byte triples in page order."""
    return [(p.nbytes, p.wire_nbytes, p.raw_nbytes) for p in pages]


def _param_page_sizes(p: PackedParam, placement: Optional[Placement]
                      ) -> Tuple[str, int, int, int]:
    """(encoding, device, wire, raw) bytes of one paged param: device =
    the packed payload, wire = payload + scales (per channel for the
    verbatim and identity encodings, per block for a re-encoded page),
    raw = fp32 dense for intN encodings and = wire for fp."""
    dev = p.nbytes_packed
    n_weights = int(np.prod(p.orig_shape))
    enc = placement.page_encoding if placement is not None else "fp"
    page_bits = placement.page_bits if placement is not None else None
    scale_nb = int(np.prod(p.scale.shape)) * 4
    if page_bits is None or page_bits == p.bits:
        wire = dev + scale_nb
        raw = wire if page_bits is None else n_weights * 4
        return enc, dev, wire, raw
    rows = n_weights // int(p.orig_shape[-1])
    wire = encoded_wire_bytes(rows, int(p.orig_shape[-1]), page_bits,
                              PAGE_ENC_BLOCK)
    return enc, dev, wire, n_weights * 4


def page_crc(host_params: Sequence[Optional["HostParam"]]) -> Optional[int]:
    """Chain the member params' wire CRCs into one page checksum (None if
    any member has none)."""
    acc = 0
    for hp in host_params:
        if hp is None or hp.crc32 is None:
            return None
        acc = zlib.crc32(int(hp.crc32).to_bytes(4, "little"), acc)
    return acc & 0xFFFFFFFF


def build_pages(store: WeightStore, page_bytes: int = SIRACUSA_MRAM_BYTES,
                order: Optional[Sequence[str]] = None,
                plan: Optional[PlacementPlan] = None,
                host: Optional[Dict[str, "HostParam"]] = None
                ) -> List[Page]:
    """Greedy first-fit pagination in access order.  With ``plan`` only its
    paged params are paginated, and an encoding change closes the current
    page; with ``host`` each page gets the CRC32 of its wire images."""
    names = list(order) if order is not None else list(store.params.keys())
    if plan is not None:
        names = [n for n in names if plan.placement_for(n).paged]
    pages: List[Page] = []
    cur: List[str] = []
    cur_dev = cur_wire = cur_raw = 0
    cur_enc = "fp"

    def _close():
        nonlocal cur, cur_dev, cur_wire, cur_raw
        crc = (page_crc([host.get(n) for n in cur])
               if host is not None else None)
        pages.append(Page(len(pages), tuple(cur), cur_dev, cur_wire,
                          cur_raw, cur_enc, crc))
        cur, cur_dev, cur_wire, cur_raw = [], 0, 0, 0

    for name in names:
        placement = plan.placement_for(name) if plan is not None else None
        enc, dev, wire, raw = _param_page_sizes(store.params[name],
                                                placement)
        if dev > page_bytes:
            where = (f"plan path {name!r} -> {placement.scenario}/"
                     f"{placement.weight_bits}b/{enc}" if placement
                     is not None else f"param {name!r} ({enc})")
            raise ValueError(
                f"{where}: {dev} B packed exceeds page size {page_bytes} B;"
                f" set page_bytes >= {dev} or split the parameter")
        if cur and (cur_dev + dev > page_bytes or enc != cur_enc):
            _close()
        cur.append(name)
        cur_enc = enc
        cur_dev += dev
        cur_wire += wire
        cur_raw += raw
    if cur:
        _close()
    return pages


@dataclasses.dataclass
class PageScheduleEntry:
    page: int
    prefetch_next: Optional[int]     # page to swap in while this one runs
    evicts: Optional[int]            # page slot being overwritten


@dataclasses.dataclass
class StallModel:
    """Analytical stall of a paged execution: ``swap_time(page) =
    page.wire_nbytes / swap_bandwidth``, and a swap started with page k's
    compute hides ``min(compute_k, swap_{k+1})``."""
    swap_bandwidth_bytes_per_s: float

    def run(self, pages: Sequence[Page],
            compute_time_s: Sequence[float]) -> Dict[str, float]:
        if len(pages) != len(compute_time_s):
            raise ValueError("one compute time per page")
        total_compute = float(sum(compute_time_s))
        stall = pages[0].wire_nbytes / self.swap_bandwidth_bytes_per_s
        for k in range(1, len(pages)):
            swap = pages[k].wire_nbytes / self.swap_bandwidth_bytes_per_s
            stall += overlap_stall(swap, compute_time_s[k - 1])["exposed_s"]
        return dict(total_compute_s=total_compute, stall_s=stall,
                    total_s=total_compute + stall,
                    stall_fraction=stall / max(total_compute + stall, 1e-12))


def make_schedule(n_pages: int, resident_slots: int = 2
                  ) -> List[PageScheduleEntry]:
    """Static proactive-prefetch schedule over a linear page order.  With
    one live slot there is nowhere to double-buffer: every page is demand-
    fetched after evicting the previous one."""
    if resident_slots < 1:
        raise ValueError(f"resident_slots must be >= 1, got {resident_slots}")
    if resident_slots == 1:
        return [PageScheduleEntry(page=k, prefetch_next=None,
                                  evicts=k - 1 if k > 0 else None)
                for k in range(n_pages)]
    entries: List[PageScheduleEntry] = []
    for k in range(n_pages):
        nxt = k + 1 if k + 1 < n_pages else None
        # with S slots, prefetching page k+1 evicts page k+1-S
        ev = (k + 1 - resident_slots
              if nxt is not None and k + 1 - resident_slots >= 0 else None)
        entries.append(PageScheduleEntry(page=k, prefetch_next=nxt, evicts=ev))
    return entries


def validate_schedule(entries: Sequence[PageScheduleEntry],
                      resident_slots: int = 2) -> None:
    """Every page resident before use, the in-use page never evicted,
    residency within the slot count; violations raise ScheduleError."""
    resident: List[int] = []
    for e in entries:
        if e.page not in resident:
            resident.append(e.page)      # demand fetch (cold miss)
        if e.evicts is not None:
            if e.evicts == e.page:
                raise ScheduleError(
                    f"schedule evicts the in-use page {e.page}",
                    page=e.page)
            if e.evicts in resident:
                resident.remove(e.evicts)
        if e.prefetch_next is not None and e.prefetch_next not in resident:
            resident.append(e.prefetch_next)
        if len(resident) > resident_slots:
            raise ScheduleError(
                f"residency {resident} exceeds {resident_slots} slots at "
                f"page {e.page}", page=e.page)


class SharedPagePool:
    """One device-bytes budget shared by every tenant's paged store and KV
    page table (the §V concurrent workloads share ONE memory hierarchy).

    Members register under a name; every page a member fetches is admitted
    here, and admission evicts least-recently-used pages of *other*
    members until the new page fits (the fetching member's own pages, and
    those of any member whose overlapped pass is mid-fetch, are never
    evicted).  A page still cached from an earlier pass satisfies a
    re-fetch without a host->device swap (a *pool hit*).

    Every member routes its fetches through the pool's single fetch
    worker, so overlapped passes of different tenants execute serialized
    in begin order: the lookup / admit sequence, and with it every
    counter, is that of the sequential sync passes, which
    :func:`kv_pass_counters` replays from :attr:`events`."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.members: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.RLock()
        # (member, page) -> (nbytes, wire_nbytes, device tensors); the
        # insertion / touch order IS the LRU order (front = coldest)
        self._cache: "OrderedDict[Tuple[str, int], Tuple[int, int, Any]]" = \
            OrderedDict()
        self.live_bytes = 0           # device bytes held (what budget charges)
        self.live_wire_bytes = 0      # wire bytes those pages cost to re-swap
        self.counters: Dict[str, Dict[str, Any]] = {}
        # every member event in begin (== execution) order:
        #   ("pass", model)                       one full weight pass
        #   ("kv", model, ((page, nbytes), ...))  one KV fetch batch
        #   ("kvdrop", model, (page, ...))        slot-reuse invalidation
        self.events: List[Tuple] = []
        # ONE fetch worker for every member store
        self._exec = ThreadPoolExecutor(max_workers=1)
        # members whose pass fetches are in flight: admit() never evicts
        # their pages, so an overlapped pass's live window survives
        self._active_fetch: set = set()
        # opt-in chrome trace (ServingEngine.set_tracer): evictions as
        # instants, live bytes as a counter track
        self.tracer = None

    def register(self, name: str, store: Any) -> None:
        """Join the pool.  ``store`` is a :class:`HostPagedStore` or a
        :class:`KVPageTable`; both kinds of page contend for the SAME
        budget (one eviction domain)."""
        with self._lock:
            if name in self.members:
                raise ValueError(f"model {name!r} already joined this pool")
            self.members[name] = store
            self.counters[name] = dict(pool_hits=0, evicted=0,
                                       exposed_s=0.0, hidden_s=0.0)

    @property
    def pass_log(self) -> List[str]:
        """One entry per full WEIGHT pass in begin order: the ``passes=``
        argument of :func:`shared_pass_counters`."""
        with self._lock:
            return [m for kind, m, *_rest in self.events if kind == "pass"]

    def log_event(self, *event) -> None:
        with self._lock:
            self.events.append(tuple(event))

    def _pass_begin(self, name: str) -> None:
        """Mark ``name``'s pass fetches in flight (eviction-protected)."""
        with self._lock:
            self._active_fetch.add(name)

    def _pass_end(self, name: str) -> None:
        """Release the fetch guard (idempotent; also called on cancel)."""
        with self._lock:
            self._active_fetch.discard(name)

    def lookup(self, name: str, page_idx: int) -> Optional[Any]:
        """The device tensors of a page still cached from an earlier fetch,
        or None (the caller then swaps it in and admits it)."""
        with self._lock:
            key = (name, page_idx)
            entry = self._cache.get(key)
            if entry is None:
                return None
            self._cache.move_to_end(key)
            self.counters[name]["pool_hits"] += 1
            return entry[2]

    def admit(self, name: str, page_idx: int, nbytes: int, params: Any,
              wire_nbytes: Optional[int] = None,
              raw_nbytes: Optional[int] = None) -> None:
        """Cache a freshly swapped page under the shared budget, evicting
        other members' LRU pages to make room.  A page that cannot fit even
        then is not cached (and one larger than the whole budget flushes
        nobody).  ``nbytes`` (device bytes) is what the budget charges;
        ``wire_nbytes`` is only tracked; ``raw_nbytes`` is accepted for
        symmetry with :class:`Page`."""
        del raw_nbytes               # per-member ledgers live in the stores
        with self._lock:
            if nbytes > self.budget_bytes:
                return              # can NEVER fit: don't flush co-tenants
            wire = int(wire_nbytes) if wire_nbytes is not None else nbytes
            tr = self.tracer
            for key in list(self._cache.keys()):
                if self.live_bytes + nbytes <= self.budget_bytes:
                    break
                victim_model, victim_page = key
                if victim_model == name or victim_model in self._active_fetch:
                    continue
                freed, freed_wire, _ = self._cache.pop(key)
                self.live_bytes -= freed
                self.live_wire_bytes -= freed_wire
                self.counters[victim_model]["evicted"] += 1
                if tr is not None:
                    tr.instant("evict", track="io", model=victim_model,
                               page=victim_page, nbytes=freed, by=name)
            if self.live_bytes + nbytes <= self.budget_bytes:
                self._cache[(name, page_idx)] = (nbytes, wire, params)
                self.live_bytes += nbytes
                self.live_wire_bytes += wire
            if tr is not None:
                tr.counter("pool_bytes", track="io", bytes=self.live_bytes,
                           wire_bytes=self.live_wire_bytes)

    def invalidate(self, name: str, page_idx: int) -> bool:
        """Drop ``name``'s cached page at its owner's request (a KV block
        whose slot was handed over); not counted as an eviction.  Returns
        whether the page was present."""
        with self._lock:
            entry = self._cache.pop((name, page_idx), None)
            if entry is None:
                return False
            self.live_bytes -= entry[0]
            self.live_wire_bytes -= entry[1]
            if self.tracer is not None:
                self.tracer.counter("pool_bytes", track="io",
                                    bytes=self.live_bytes,
                                    wire_bytes=self.live_wire_bytes)
            return True

    def add_stall(self, name: str, exposed_s: float,
                  hidden_s: float = 0.0) -> None:
        """Book one pass's stall split for ``name``."""
        with self._lock:
            self.counters[name]["exposed_s"] += float(exposed_s)
            self.counters[name]["hidden_s"] += float(hidden_s)

    def summary(self) -> Dict[str, Any]:
        """Per-member swap / miss / pool-hit / evict counters, streamed
        bytes and stall split, and the pool's state: the ``shared_pool``
        section of the metrics document.  Its stall seconds are the pool's
        view of the wall time the engines report too; a total sums one of
        the two, never both."""
        with self._lock:
            models = {}
            for name, store in self.members.items():
                c = self.counters[name]
                models[name] = dict(
                    swaps=store.swap_count, misses=store.miss_count,
                    pool_hits=c["pool_hits"], evicted=c["evicted"],
                    exposed_s=c["exposed_s"], hidden_s=c["hidden_s"],
                    n_pages=len(store.pages),
                    bytes_streamed_wire=getattr(store, "bytes_streamed_wire",
                                                0),
                    bytes_streamed_raw=getattr(store, "bytes_streamed_raw",
                                               0))
            return dict(
                budget_bytes=self.budget_bytes,
                live_bytes=self.live_bytes,
                live_wire_bytes=self.live_wire_bytes,
                cached_pages=len(self._cache),
                evictions=sum(c["evicted"] for c in self.counters.values()),
                bytes_streamed_wire=sum(m["bytes_streamed_wire"]
                                        for m in models.values()),
                bytes_streamed_raw=sum(m["bytes_streamed_raw"]
                                       for m in models.values()),
                models=models)

    def close(self, wait: bool = True) -> None:
        with self._lock:
            members = list(self.members.values())
            self._cache.clear()
            self.live_bytes = 0
            self.live_wire_bytes = 0
        for store in members:
            store.close(wait=wait)
        self._exec.shutdown(wait=wait, cancel_futures=not wait)

    def __enter__(self) -> "SharedPagePool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def shared_pass_counters(page_nbytes: Dict[str, Sequence[Any]],
                         budget_bytes: int, resident_slots: int = 2,
                         passes: Optional[Sequence[str]] = None,
                         ticks: int = 1) -> Dict[str, Dict[str, int]]:
    """Static per-member counters of weight passes through a
    :class:`SharedPagePool`: the weights-only view of
    :func:`kv_pass_counters`.  ``page_nbytes`` maps each member to its page
    sizes in access order (device-byte ints, or ``(device, wire, raw)``
    triples from :func:`page_sizes`); ``passes`` is the sequence of full
    passes (``SharedPagePool.pass_log``), by default ``ticks`` round-robin
    rounds over the members in dict order."""
    order = list(page_nbytes.keys())
    if passes is None:
        passes = [m for _ in range(ticks) for m in order]
    out = kv_pass_counters(page_nbytes, budget_bytes,
                           [("pass", m) for m in passes],
                           resident_slots=resident_slots)
    for m in order:
        out.setdefault(m, dict(swaps=0, misses=0, pool_hits=0, evicted=0,
                               dropped=0, bytes_wire=0, bytes_raw=0))
    # weight passes never drop pages; keep the reference's key set
    return {m: {k: n for k, n in c.items() if k != "dropped"}
            for m, c in out.items()}


@dataclasses.dataclass
class HostParam:
    """Host image of ONE paged parameter, in its page wire encoding.

    *Identity* (``page_bits`` None, or equal to ``bits``): the payload is
    the device carrier and the scales the per-channel device scales.
    *Re-encoded*: blockwise ``page_bits`` levels (packed) and per-(row,
    ``PAGE_ENC_BLOCK``) scales, rows being the param flattened to (-1, K);
    :meth:`decode` rebuilds the per-channel device form."""
    bits: int                         # device weight bits
    orig_shape: Tuple[int, ...]
    packed_shape: Tuple[int, ...]     # device carrier shape to rebuild
    scale_shape: Tuple[int, ...]      # device per-channel scale shape
    page_bits: Optional[int]          # wire bits (None = fp/verbatim)
    payload: np.ndarray
    scales: np.ndarray
    crc32: Optional[int] = None       # over (payload, scales) bytes

    @property
    def identity(self) -> bool:
        return self.page_bits is None or self.page_bits == self.bits

    @property
    def encoding(self) -> str:
        return "fp" if self.page_bits is None else f"int{self.page_bits}"

    @property
    def wire_nbytes(self) -> int:
        return int(self.payload.nbytes) + int(self.scales.nbytes)

    def wire_crc(self, payload: Optional[np.ndarray] = None,
                 scales: Optional[np.ndarray] = None) -> int:
        """CRC32 of the stored wire buffers, or of the buffers a fetch
        received (to verify them before install)."""
        payload = self.payload if payload is None else payload
        scales = self.scales if scales is None else scales
        crc = zlib.crc32(np.ascontiguousarray(payload))
        crc = zlib.crc32(np.ascontiguousarray(scales), crc)
        return crc & 0xFFFFFFFF

    def decode(self, payload: Optional[np.ndarray] = None,
               scales: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Wire form -> device form ``(packed, scale)`` on the host: a
        no-op for identity encodings; otherwise dequantize the blocks and
        re-quantize per channel at ``bits`` (the eager quantizer, as the
        reference does)."""
        payload = self.payload if payload is None else payload
        scales = self.scales if scales is None else scales
        if self.identity:
            return payload, scales
        k = int(self.orig_shape[-1])
        levels = packing.unpack(_cpu(payload), self.page_bits, k).numpy()
        dense = quantize.dequantize_blockwise(levels, scales,
                                              block=PAGE_ENC_BLOCK)
        qt = quantize.quantize_weights(torch.from_numpy(dense), self.bits,
                                       channel_axis=0)
        packed = packing.pack(qt.values, self.bits).numpy()
        return (packed.reshape(self.packed_shape),
                qt.scale.numpy().astype(np.float32).reshape(self.scale_shape))


def encode_host_param(p: PackedParam, page_bits: Optional[int]) -> HostParam:
    """One paged param's host wire image (see :class:`HostParam`).  A
    re-encoded param is dequantized once, flattened to (-1, K) rows, and
    blockwise-quantized at ``page_bits``; the device carrier is not
    kept."""
    packed = _np(p.packed)
    scale = _np(p.scale)
    hp = HostParam(bits=p.bits, orig_shape=tuple(p.orig_shape),
                   packed_shape=tuple(packed.shape),
                   scale_shape=tuple(scale.shape),
                   page_bits=page_bits, payload=packed, scales=scale)
    if not hp.identity:
        k = int(p.orig_shape[-1])
        levels = packing.unpack(torch.from_numpy(
            packed.reshape(-1, packed.shape[-1])), p.bits, k).numpy()
        dense = (levels.astype(np.float32)
                 * scale.reshape(-1, 1).astype(np.float32))
        wire_levels, wire_scales = quantize.quantize_blockwise(
            dense, page_bits, block=PAGE_ENC_BLOCK)
        hp.payload = packing.pack(torch.from_numpy(wire_levels),
                                  page_bits).numpy()
        hp.scales = wire_scales
    hp.crc32 = hp.wire_crc()
    return hp


def page_roundtrip_param(p: PackedParam, page_bits: Optional[int]
                         ) -> PackedParam:
    """One param encoded and decoded through the page codec: what a decoding
    fetch installs, for a resident reference engine to hold the same
    weights (as CPU tensors)."""
    packed, scale = encode_host_param(p, page_bits).decode()
    return PackedParam(packed=_cpu(packed), scale=_cpu(scale), bits=p.bits,
                       orig_shape=tuple(p.orig_shape))


def page_crc_of_buffers(wire: Sequence[Tuple[str, HostParam, np.ndarray,
                                             np.ndarray]]) -> int:
    """Page CRC recomputed from the buffers a fetch received."""
    acc = 0
    for _name, hp, payload, scales in wire:
        c = hp.wire_crc(payload=payload, scales=scales)
        acc = zlib.crc32(c.to_bytes(4, "little"), acc)
    return acc & 0xFFFFFFFF


def retry_fetch(store: Any, idx: int, attempt_fn: Callable[[int], Any]) -> Any:
    """Run one page fetch under the store's retry policy: an injected
    transient failure or a checksum mismatch retries after the plan's
    deterministic backoff; exhausting ``max_attempts`` (1 without a fault
    plan) raises PageFetchError.  Counters land on
    ``store.fault_counters``, and with a ``store.tracer`` each fault and
    retry is an instant on its ``io`` track."""
    tr = getattr(store, "tracer", None)
    inj = store.faults
    plan = inj.plan if inj is not None else None
    max_attempts = plan.max_attempts if plan is not None else 1
    attempt = 0
    while True:
        try:
            return attempt_fn(attempt)
        except (TransientFetchFault, PageChecksumError) as e:
            if isinstance(e, TransientFetchFault):
                store.fault_counters["injected"] += 1
                if tr is not None:
                    tr.instant("fault", track="io", model=store.name,
                               page=idx, kind="fail", attempt=attempt)
            else:
                store.fault_counters["checksum_failures"] += 1
                store.fault_counters["refetches"] += 1
            attempt += 1
            if attempt >= max_attempts:
                raise PageFetchError(model=store.name, page=idx,
                                     attempts=attempt, last_error=e) from e
            store.fault_counters["retries"] += 1
            if tr is not None:
                tr.instant("retry", track="io", model=store.name, page=idx,
                           attempt=attempt, cause=type(e).__name__)
            time.sleep(plan.backoff(attempt))


class HostPagedStore:
    """Runtime paged weight streaming: host memory is the background flash,
    device memory holds the live pages; one fetch worker thread does the
    proactive swaps.

    With a ``plan``, its resident params are put on the device once
    (``self.resident``) and only its paged params flow through the page
    cache, each held on the host in its plan-assigned wire encoding.
    Counters: ``swap_count`` / ``miss_count``; ``bytes_streamed_wire`` /
    ``bytes_streamed_raw``; ``decode_skipped_bytes`` (wire-served bytes
    that needed no host decode); and host seconds spent by the worker in
    ``decode_s`` (host decode), ``crc_s`` (CRC over the received wire
    bytes) and ``copy_s`` (host->device copies, enqueue to completion).

    With a ``pool`` (:class:`SharedPagePool`) the store joins the pool's
    budget under ``name``: a fetch looks the page up there first (a hit
    swaps nothing), admits what it swapped, and runs on the pool's single
    fetch worker.  ``faults`` (a FaultPlan or FaultInjector) puts every
    fetch attempt under seeded fault injection with CRC-verified retry.
    ``device`` defaults to ``cuda`` and raises without a card.
    """

    def __init__(self, store: WeightStore, page_bytes: int,
                 device: DeviceLike = None,
                 plan: Optional[PlacementPlan] = None,
                 pool: Optional[SharedPagePool] = None,
                 name: str = "default", faults: FaultsArg = None):
        self.plan = plan
        self.pool = pool
        self.name = name
        self.device = resolve_device(device)
        # the host wire images come first, so that build_pages can stamp
        # each page with the CRC of the bytes it will move
        self._host: Dict[str, HostParam] = {}
        self.resident: Dict[str, PackedParam] = {}
        for pname, p in store.params.items():
            if plan is not None and not plan.placement_for(pname).paged:
                self.resident[pname] = PackedParam(
                    packed=p.packed.to(self.device),
                    scale=p.scale.to(self.device), bits=p.bits,
                    orig_shape=p.orig_shape)
            else:
                pb = (plan.placement_for(pname).page_bits
                      if plan is not None else None)
                self._host[pname] = encode_host_param(p, pb)
        self.pages = build_pages(store, page_bytes, plan=plan,
                                 host=self._host)
        # cold params served from their wire form (the predicate the
        # model's `linear` dispatches on)
        self.wire_served = {n for n in self._host
                            if wire_served_bits(plan, n) is not None}
        # on a card: every host image pinned once, and a side stream for
        # the copies
        self._copy_stream = None
        if self.device.type == "cuda":
            for hp in self._host.values():
                hp.payload = _cpu(hp.payload).pin_memory().numpy()
                hp.scales = _cpu(hp.scales).pin_memory().numpy()
            self._copy_stream = torch.cuda.Stream(self.device)
        self._exec = ThreadPoolExecutor(max_workers=1)
        self.swap_count = 0
        self.miss_count = 0
        self.bytes_streamed_wire = 0
        self.bytes_streamed_raw = 0
        self.decode_s = 0.0
        self.crc_s = 0.0
        self.copy_s = 0.0
        self.decode_skipped_bytes = 0
        self.faults = as_injector(faults)
        self.fault_counters = new_fault_counters()
        self._closed = False
        self._live: Dict[int, Dict[str, PackedParam]] = {}
        # opt-in chrome trace: per-page fetch spans on the "io" track,
        # emitted from the fetch worker
        self.tracer = None
        if pool is not None:
            pool.register(self.name, self)

    @property
    def _fetch_exec(self) -> ThreadPoolExecutor:
        """The worker fetches run on: the pool's shared one for a member
        (overlapped passes of tenants then run in begin order), else the
        store's own."""
        return self._exec if self.pool is None else self.pool._exec

    def _fetch_page(self, idx: int) -> Dict[str, PackedParam]:
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        if self._closed:
            raise CancelledError(f"{self.name}: store closed before fetch "
                                 f"of page {idx} started")
        if self.pool is not None:
            cached = self.pool.lookup(self.name, idx)
            if cached is not None:
                if tr is not None:       # pool hit: no host->device swap
                    tr.complete("page", tr.now() - t0, track="io",
                                model=self.name, page=idx, pool_hit=True)
                return cached
        page = self.pages[idx]
        out = retry_fetch(self, idx,
                          lambda attempt: self._fetch_page_once(idx, page,
                                                                attempt))
        if self._closed:
            # close(wait=False) landed during the fetch: drop the page
            raise CancelledError(f"{self.name}: store closed during fetch "
                                 f"of page {idx}")
        self.swap_count += 1
        self.bytes_streamed_wire += page.wire_nbytes
        self.bytes_streamed_raw += page.raw_nbytes
        if self.pool is not None:
            self.pool.admit(self.name, idx, page.nbytes, out,
                            wire_nbytes=page.wire_nbytes,
                            raw_nbytes=page.raw_nbytes)
        if tr is not None:
            tr.complete("page", tr.now() - t0, track="io", model=self.name,
                        page=idx, nbytes=page.nbytes,
                        wire_nbytes=page.wire_nbytes,
                        encoding=page.encoding, pool_hit=False)
        return out

    def _fetch_page_once(self, idx: int, page: Page,
                         attempt: int) -> Dict[str, PackedParam]:
        """One fetch attempt: inject faults, verify the page CRC over the
        received wire bytes, decode (unless wire-served), copy to the
        device.  An injected bit-flip lands on a transient copy of the
        payload, never on the host image, so a retry reads clean bytes."""
        inj = self.faults
        if inj is not None:
            self.fault_counters["injected"] += inj.pre_fetch(self.name, idx,
                                                             attempt)
        wire: List[Tuple[str, HostParam, np.ndarray, np.ndarray]] = []
        for name in page.param_names:
            hp = self._host[name]
            payload = hp.payload
            if inj is not None:
                flipped = inj.corrupt(self.name, idx, attempt,
                                      np.ascontiguousarray(payload).tobytes())
                if flipped is not None:
                    self.fault_counters["injected"] += 1
                    if self.tracer is not None:
                        self.tracer.instant("fault", track="io",
                                            model=self.name, page=idx,
                                            kind="bitflip", param=name,
                                            attempt=attempt)
                    payload = np.frombuffer(
                        flipped, dtype=payload.dtype).reshape(payload.shape)
            wire.append((name, hp, payload, hp.scales))
        if page.crc32 is not None:
            t0 = time.perf_counter()
            got = page_crc_of_buffers(wire)
            self.crc_s += time.perf_counter() - t0
            if got != page.crc32:
                raise PageChecksumError(model=self.name, page=idx,
                                        expected=page.crc32, got=got)
        host = []
        for name, hp, payload, scales in wire:
            if name in self.wire_served:
                # the blockwise wire form as it arrived; the codec
                # flattened to (rows, k), the leading dims come back
                self.decode_skipped_bytes += hp.wire_nbytes
                bits = hp.page_bits
            else:
                t_dec = time.perf_counter()
                payload, scales = hp.decode(payload=payload, scales=scales)
                self.decode_s += time.perf_counter() - t_dec
                bits = hp.bits
            if name in self.wire_served:
                lead = hp.packed_shape[:-1]
                payload = payload.reshape(*lead, -1)
                scales = scales.reshape(*lead, -1)
            host.append((name, payload, scales, bits, hp.orig_shape))
        t0 = time.perf_counter()
        out = {name: PackedParam(packed=p, scale=s, bits=bits,
                                 orig_shape=shape)
               for name, p, s, bits, shape in self._upload(host)}
        self.copy_s += time.perf_counter() - t0
        return out

    def _upload(self, host):
        """Host buffers -> device tensors; on a card the copies run on the
        side stream and are complete when this returns.  A pinned host
        image is copied asynchronously; a pageable buffer (a decoded page, a
        bit-flipped transient copy) is staged by the CUDA runtime, which has
        read it when its copy call returns."""
        if self.device.type != "cuda":
            return [(n, torch.from_numpy(np.array(p)),
                     torch.from_numpy(np.array(s)), b, sh)
                    for n, p, s, b, sh in host]
        with torch.cuda.stream(self._copy_stream):
            out = [(n, _cpu(p).to(self.device, non_blocking=True),
                    _cpu(s).to(self.device, non_blocking=True), b, sh)
                   for n, p, s, b, sh in host]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return out

    def _hand_over(self, params: Dict[str, PackedParam]
                   ) -> Dict[str, PackedParam]:
        """Mark fetched device pages for the stream current now, the one
        the caller computes on: their memory then goes back to the side
        stream's copies only after that stream's work on them is done,
        also when a co-tenant's fetch evicts a pooled page meanwhile.  A
        pool hit hands over the pool's own tensors the same way."""
        if self._copy_stream is not None:
            stream = torch.cuda.current_stream(self.device)
            for p in params.values():
                p.packed.record_stream(stream)
                p.scale.record_stream(stream)
        return params

    def template_view(self) -> Dict[str, PackedParam]:
        """Host (CPU tensor) leaves for every PAGED param in the layout a
        fetched page takes: wire-served params as their wire buffers with
        the carrier's leading dims, the others decoded to the device
        form."""
        view: Dict[str, PackedParam] = {}
        for name, hp in self._host.items():
            if name in self.wire_served:
                lead = hp.packed_shape[:-1]
                view[name] = PackedParam(
                    packed=_cpu(hp.payload.reshape(*lead, -1)),
                    scale=_cpu(hp.scales.reshape(*lead, -1)),
                    bits=hp.page_bits, orig_shape=hp.orig_shape)
                continue
            packed, scale = hp.decode()
            view[name] = PackedParam(packed=_cpu(packed), scale=_cpu(scale),
                                     bits=hp.bits, orig_shape=hp.orig_shape)
        return view

    def stream(self, resident_slots: int = 2) -> "PageStream":
        """(page, device params) in access order with proactive prefetch;
        each pass starts from a cold page cache, so per-pass counters
        follow :func:`pass_counters`."""
        return PageStream(self, resident_slots)

    def begin_pass(self, resident_slots: int = 2) -> "AsyncPageStream":
        """Submit ONE full overlapped pass to the fetch worker and return;
        :meth:`AsyncPageStream.fence` joins it."""
        return AsyncPageStream(self, resident_slots)

    def close(self, wait: bool = True):
        """Shut the fetch worker down (``wait=True``: after in-flight swaps
        finish; ``wait=False``: cancel what it can).  The closed flag goes
        up first, so a running fetch drops its page."""
        self._closed = True
        self._exec.shutdown(wait=wait, cancel_futures=not wait)

    def __enter__(self) -> "HostPagedStore":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _drain(futures: Sequence[Future]) -> None:
    """Cancel what has not started; wait out what has (never leak a
    worker fetch past teardown)."""
    for fut in futures:
        if not fut.cancel():
            try:
                fut.result()
            except CancelledError:
                pass            # store closed mid-fetch: nothing to keep


class PageStream:
    """One streaming pass over a :class:`HostPagedStore`: an iterable of
    ``(Page, {name: PackedParam})`` and a context manager; closing it
    (explicitly, by ``with`` or by exhausting it) drains in-flight
    prefetches and reclaims the live page slots."""

    def __init__(self, store: HostPagedStore, resident_slots: int = 2):
        self._store = store
        self._sched = make_schedule(len(store.pages), resident_slots)
        self._inflight: Dict[int, Future] = {}
        if store.pool is not None:
            store.pool.log_event("pass", store.name)
        self._gen = self._iterate()

    def __iter__(self):
        return self._gen

    def __enter__(self) -> "PageStream":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self):
        _drain(list(self._inflight.values()))
        self._inflight.clear()
        self._store._live.clear()
        self._gen.close()

    def _iterate(self) -> Iterator[Tuple[Page, Dict[str, PackedParam]]]:
        st = self._store
        try:
            for e in self._sched:
                if e.page in st._live:
                    page_params = st._live[e.page]
                elif e.page in self._inflight:
                    page_params = self._inflight.pop(e.page).result()
                    st._live[e.page] = page_params
                else:
                    st.miss_count += 1    # demand miss (cold start)
                    page_params = st._fetch_page(e.page)
                    st._live[e.page] = page_params
                if (e.prefetch_next is not None
                        and e.prefetch_next not in st._live):
                    self._inflight[e.prefetch_next] = st._fetch_exec.submit(
                        st._fetch_page, e.prefetch_next)
                if e.evicts is not None:
                    st._live.pop(e.evicts, None)
                yield st.pages[e.page], st._hand_over(page_params)
        finally:
            _drain(list(self._inflight.values()))
            self._inflight.clear()
            st._live.clear()


class AsyncPageStream:
    """One *overlapped* streaming pass: construction submits every fetch of
    the pass to the worker in the order :class:`PageStream` would make
    them (same miss accounting and counters); :meth:`fence` joins at first
    use and splits the pass wall time:

      * ``window_s``  — begin -> fence call, the caller's compute;
      * ``exposed_s`` — time the fence blocked;
      * ``hidden_s``  — ``min(begin -> last fetch done, window)``;
      * ``swap_s``    — ``hidden_s + exposed_s``,

    which is :func:`repro_torch.core.memsys.overlap_stall` applied to
    (``swap_s``, ``window_s``).

    For a pool member the pass holds the pool's fetch guard while its
    fetches execute (marker tasks on the serialized worker set it right
    before the first and release it right after the last), so co-tenant
    admissions cannot evict its pages mid-pass; :meth:`close` releases it
    too."""

    def __init__(self, store: HostPagedStore, resident_slots: int = 2):
        self._store = store
        self._result: Optional[Dict[str, PackedParam]] = None
        self._closed = False
        self.swap_s = 0.0
        self.window_s = 0.0
        self.exposed_s = 0.0
        self.hidden_s = 0.0
        pool = store.pool
        self._t_ready: Optional[float] = None   # last fetch completion
        self._t_begin = time.perf_counter()
        self._futures: List[Tuple[int, Future]] = []
        self._marks: List[Future] = []
        if pool is not None:
            pool.log_event("pass", store.name)
            self._marks.append(
                store._fetch_exec.submit(pool._pass_begin, store.name))
        live: set = set()
        inflight: set = set()
        for e in make_schedule(len(store.pages), resident_slots):
            if e.page in live:
                pass
            elif e.page in inflight:
                inflight.discard(e.page)
                live.add(e.page)
            else:
                store.miss_count += 1        # demand miss (cold start)
                self._futures.append(
                    (e.page, store._fetch_exec.submit(store._fetch_page,
                                                      e.page)))
                live.add(e.page)
            if e.prefetch_next is not None and e.prefetch_next not in live:
                inflight.add(e.prefetch_next)
                self._futures.append(
                    (e.prefetch_next,
                     store._fetch_exec.submit(store._fetch_page,
                                              e.prefetch_next)))
            if e.evicts is not None:
                live.discard(e.evicts)
        if pool is not None:
            self._marks.append(
                store._fetch_exec.submit(pool._pass_end, store.name))
        if self._futures:
            self._futures[-1][1].add_done_callback(self._mark_ready)
        else:
            self._t_ready = self._t_begin

    def _mark_ready(self, _fut) -> None:
        self._t_ready = time.perf_counter()

    @property
    def done(self) -> bool:
        """True once fenced or closed."""
        return self._result is not None or self._closed

    def fence(self, timeout_s: Optional[float] = None
              ) -> Dict[str, PackedParam]:
        """Block until every page is on the device and record the stall
        split; idempotent.  ``timeout_s`` bounds the total wait: on expiry
        PageFetchTimeout is raised and the pass stays resumable."""
        if self._closed:
            raise RuntimeError("fence() after close(): the pass was "
                               "cancelled")
        if self._result is not None:
            return self._result
        t_fence = time.perf_counter()
        dev: Dict[str, PackedParam] = {}
        for n_done, (_idx, fut) in enumerate(self._futures):
            try:
                remaining = (None if timeout_s is None else
                             max(0.0, timeout_s - (time.perf_counter()
                                                   - t_fence)))
                dev.update(fut.result(timeout=remaining))
            except FuturesTimeout:
                self._store.fault_counters["fetch_timeouts"] += 1
                raise PageFetchTimeout(
                    model=self._store.name, timeout_s=timeout_s,
                    pending=len(self._futures) - n_done) from None
        # the worker waited on each page's copy event, so the pages are
        # on the device already
        t_join = time.perf_counter()
        t_ready = self._t_ready if self._t_ready is not None else t_join
        self.window_s = t_fence - self._t_begin
        self.exposed_s = t_join - t_fence
        self.hidden_s = min(t_ready - self._t_begin, self.window_s)
        self.swap_s = self.hidden_s + self.exposed_s
        self._futures.clear()
        self._result = self._store._hand_over(dev)
        return dev

    def close(self) -> None:
        """Cancel what has not started and drain what has (a fetch error of
        the abandoned pass is raised here) and release the pool's fetch
        guard; a no-op on a fenced pass, and idempotent."""
        try:
            _drain([f for _i, f in self._futures] + self._marks)
        finally:
            self._futures.clear()
            self._marks.clear()
            if self._result is None:
                self._closed = True
            if self._store.pool is not None:
                self._store.pool._pass_end(self._store.name)

    def __enter__(self) -> "AsyncPageStream":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def pass_counters(n_pages: int, resident_slots: int = 2) -> Dict[str, int]:
    """Static swap/miss counts of ONE full pass from a cold page cache, the
    prediction :class:`HostPagedStore`'s counters match pass for pass."""
    live: set = set()
    inflight: set = set()
    swaps = misses = 0
    for e in make_schedule(n_pages, resident_slots):
        if e.page in live:
            pass
        elif e.page in inflight:
            inflight.discard(e.page)
            live.add(e.page)
        else:
            misses += 1
            swaps += 1
            live.add(e.page)
        if e.prefetch_next is not None and e.prefetch_next not in live:
            inflight.add(e.prefetch_next)
            swaps += 1
        if e.evicts is not None:
            live.discard(e.evicts)
    return dict(swaps=swaps, misses=misses)


# ---------------------------------------------------------------------------
# KV-cache paging: the per-slot KV cache flows through the SAME budget
# ---------------------------------------------------------------------------

KV_PARTS = ("k", "v")


class KVPageTable:
    """Pages a serving engine's per-slot KV cache through the same
    device-bytes budget, and the same begin / fence overlap, as the weight
    pages.

    A KV *page* is ``block_rows`` consecutive cache rows of one batch
    slot, across every layer and both k and v: page index ``slot *
    n_blocks + block``.  The engine's device cache stays the compute
    buffer; the authoritative copy of every *completed* block lives in
    this table's host image:

      * a block is written back host-ward once, when the prefill / decode
        frontier crosses its end (KV rows are append-only);
      * each tick the live slots' completed blocks stream host->device
        (through the pool when there is one: a pooled block is a hit, not
        a swap) and the engine scatters them over its cache;
      * the partly filled frontier block stays on the device;
      * when a slot is handed to a new request its pooled blocks are
        dropped (``queue_drop`` / ``flush_drops``, at the next fence, on
        the pool's fetch worker after every fetch queued before it) and
        its host rows zeroed.

    The host image keeps the cache's dtype as CPU tensors, one contiguous
    ``(n_layers, n_kv_heads, block_rows, head_dim)`` block a page (shape
    ``(n_slots, n_blocks, n_layers, n_kv_heads, block_rows, head_dim)``,
    the last block padded when ``block_rows`` does not divide
    ``max_len``), pinned on a card, so a fetch is one asynchronous copy a
    part on the side stream.  ``row_nbytes`` and ``page_nbytes`` are those
    of the cache, so the pool charges what the reference charges.

    Counters (``swap_count == miss_count``: every non-pooled KV fetch is a
    demand swap), writebacks and drops follow the :func:`kv_pass_counters`
    replay of the event log.  Faults: ``pre_fetch`` failures and latency
    apply; bit-flips do not (KV rows cross no checksummed wire codec)."""

    def __init__(self, cache_kv: Dict[str, torch.Tensor], *,
                 block_rows: int = 16,
                 pool: Optional[SharedPagePool] = None,
                 name: str = "default/kv", device: DeviceLike = None,
                 faults: FaultsArg = None):
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        k, v = cache_kv["k"], cache_kv["v"]
        # cache layout (n_layers, n_slots, n_kv_heads, max_len, head_dim)
        n_layers, self.n_slots, n_heads, self.max_len, head_dim = k.shape
        self.block_rows = int(block_rows)
        self.n_blocks = -(-self.max_len // self.block_rows)
        self.row_nbytes = ((k.numel() + v.numel()) * k.element_size()
                           // (self.n_slots * self.max_len))
        self.page_nbytes = self.block_rows * self.row_nbytes
        self.name = name
        self.pool = pool
        self.device = resolve_device(device)
        shape = (self.n_slots, self.n_blocks, n_layers, n_heads,
                 self.block_rows, head_dim)
        self._copy_stream = None
        pin = self.device.type == "cuda"
        self.host = {part: torch.zeros(shape, dtype=k.dtype,
                                       pin_memory=pin)
                     for part in KV_PARTS}
        if pin:
            self._copy_stream = torch.cuda.Stream(self.device)
        for slot in range(self.n_slots):      # the cache as it is now
            self._write_rows(slot, 0, self.n_blocks, cache_kv)
        self.swap_count = 0
        self.miss_count = 0
        self.pool_hits = 0
        # KV rows stream in their device format: wire == raw == device
        self.bytes_streamed_wire = 0
        self.bytes_streamed_raw = 0
        self.writebacks = 0           # blocks written back host-ward
        self.dropped = 0              # pooled blocks invalidated (slot reuse)
        self.preempt_drops = 0        # of which: mid-request preemptions
        self.faults = as_injector(faults)
        self.fault_counters = new_fault_counters()
        self._closed = False
        # pool-less prediction log (pooled tables log into pool.events)
        self.events: List[Tuple] = []
        self._pending_drops: set = set()
        self._exec = ThreadPoolExecutor(max_workers=1)
        # opt-in chrome trace (ServingEngine.set_tracer): per-block fetch
        # spans and kvdrop instants on the "io" track
        self.tracer = None
        if pool is not None:
            pool.register(name, self)

    @property
    def pages(self) -> range:
        return range(self.n_slots * self.n_blocks)

    @property
    def _fetch_exec(self) -> ThreadPoolExecutor:
        return self._exec if self.pool is None else self.pool._exec

    def _log(self, *event) -> None:
        if self.pool is not None:
            self.pool.log_event(*event)
        else:
            self.events.append(tuple(event))

    def page_index(self, slot: int, block: int) -> int:
        return slot * self.n_blocks + block

    def _block_rows_span(self, page_idx: int) -> Tuple[int, int, int]:
        slot, blk = divmod(page_idx, self.n_blocks)
        a = blk * self.block_rows
        return slot, a, min(a + self.block_rows, self.max_len)

    def _fetch_block(self, page_idx: int) -> Dict[str, torch.Tensor]:
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        if self._closed:
            raise CancelledError(f"{self.name}: table closed before fetch "
                                 f"of page {page_idx} started")
        if self.pool is not None:
            cached = self.pool.lookup(self.name, page_idx)
            if cached is not None:
                self.pool_hits += 1
                if tr is not None:       # pool hit: no host->device swap
                    tr.complete("kv_block", tr.now() - t0, track="io",
                                model=self.name, page=page_idx,
                                pool_hit=True)
                return cached
        slot, a, b = self._block_rows_span(page_idx)
        rows = retry_fetch(self, page_idx,
                           lambda attempt: self._fetch_block_once(
                               page_idx, slot, a, b, attempt))
        if self._closed:
            raise CancelledError(f"{self.name}: table closed during fetch "
                                 f"of page {page_idx}")
        self.swap_count += 1
        self.miss_count += 1
        nb = (b - a) * self.row_nbytes
        self.bytes_streamed_wire += nb
        self.bytes_streamed_raw += nb
        if self.pool is not None:
            self.pool.admit(self.name, page_idx, nb, rows)
        if tr is not None:
            tr.complete("kv_block", tr.now() - t0, track="io",
                        model=self.name, page=page_idx, nbytes=nb,
                        pool_hit=False)
        return rows

    def _fetch_block_once(self, page_idx: int, slot: int, a: int, b: int,
                          attempt: int) -> Dict[str, torch.Tensor]:
        """One attempt: the block's pinned host rows to the device on the
        side stream, complete (its event waited on) when this returns; on
        the CPU, a copy (the pool keeps it, and a drop zeroes the host)."""
        if self.faults is not None:
            self.fault_counters["injected"] += self.faults.pre_fetch(
                self.name, page_idx, attempt)
        src = {part: self.host[part][slot, a // self.block_rows, :, :,
                                     :b - a]
               for part in KV_PARTS}
        if self._copy_stream is None:
            return {part: t.clone() for part, t in src.items()}
        with torch.cuda.stream(self._copy_stream):
            out = {part: t.to(self.device, non_blocking=True)
                   for part, t in src.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return out

    def _write_rows(self, slot: int, block_lo: int, block_hi: int,
                    cache_kv: Dict[str, torch.Tensor]) -> None:
        a = block_lo * self.block_rows
        b = min(block_hi * self.block_rows, self.max_len)
        for part in KV_PARTS:
            # a blocking copy on the current (compute) stream: it returns
            # once the stream's queued work, the tick that wrote these
            # rows, has finished and the rows are on the host
            rows = cache_kv[part][:, slot, :, a:b].to("cpu")
            for blk in range(block_lo, block_hi):
                r0 = (blk - block_lo) * self.block_rows
                n = min(self.block_rows, b - a - r0)
                self.host[part][slot, blk, :, :, :n] = rows[:, :, r0:r0 + n]

    def writeback(self, slot: int, block_lo: int, block_hi: int,
                  cache_kv: Dict[str, torch.Tensor]) -> None:
        """Completed blocks ``[block_lo, block_hi)`` of ``slot`` move
        device->host from the engine's cache, each exactly once, when its
        block fills (append-only KV: immutable from here on)."""
        if block_hi <= block_lo:
            return
        self._write_rows(slot, block_lo, block_hi, cache_kv)
        self.writebacks += block_hi - block_lo

    def queue_drop(self, slot: int) -> None:
        """Mark ``slot``'s pages stale (its request retired or the slot is
        reassigned); :meth:`flush_drops` invalidates them at the next
        fence, after every fetch in flight has settled, so a late fetch
        cannot re-admit a dropped page."""
        self._pending_drops.add(int(slot))

    def flush_drops(self) -> None:
        """Invalidate the queued slots' pooled blocks and zero their host
        rows.  A pooled table runs this as a task on the pool's one fetch
        worker and joins it: it lands after every fetch any member queued
        before it, so the drop's place in the pool's event log is fixed
        by the traffic, not by how far the worker has got with another
        tenant's pass (ROADMAP C8; the reference invalidates on the
        calling thread while such a pass may still be running)."""
        if not self._pending_drops:
            return
        if self.pool is None:
            self._drop_pending()
        else:
            self.pool._exec.submit(self._drop_pending).result()

    def _drop_pending(self) -> None:
        for slot in sorted(self._pending_drops):
            pages = range(slot * self.n_blocks, (slot + 1) * self.n_blocks)
            if self.pool is not None:
                removed = tuple(p for p in pages
                                if self.pool.invalidate(self.name, p))
                if removed:
                    self.pool.log_event("kvdrop", self.name, removed)
                    if self.tracer is not None:
                        self.tracer.instant("kvdrop", track="io",
                                            model=self.name, slot=slot,
                                            pages=len(removed))
                self.dropped += len(removed)
            # stale rows are never served again: zeroed, a bug that
            # fetches a dropped block shows as loud wrong bytes
            for part in KV_PARTS:
                self.host[part][slot] = 0
        self._pending_drops.clear()

    def preempt_release(self, slot: int, *, in_flight: bool) -> None:
        """Release ``slot``'s pooled blocks for a mid-request preemption:
        flushed now when no KV pass is in flight (so the slot's next
        occupant can write back this very tick), else at that pass's
        fence, which still comes before the usurper's first writeback."""
        self.queue_drop(slot)
        self.preempt_drops += 1
        if not in_flight:
            self.flush_drops()

    def begin_pass(self, full_blocks: Dict[int, int]) -> "KVPageStream":
        """Kick one overlapped KV pass: ``full_blocks`` maps each live slot
        to its completed-block count; every listed block's fetch is
        submitted now (slot, then block order), and blocks that complete
        before the fence are demand-fetched there."""
        return KVPageStream(self, full_blocks)

    def close(self, wait: bool = True) -> None:
        # flag first: a fetch already running aborts before it admits
        self._closed = True
        self._exec.shutdown(wait=wait, cancel_futures=not wait)

    def __enter__(self) -> "KVPageTable":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class KVPageStream:
    """One overlapped KV pass, the KV counterpart of
    :class:`AsyncPageStream` with the same exposed / hidden split.
    ``fence(full_blocks)`` takes the *current* completed-block spans, so
    blocks that filled during the compute window are demand-fetched
    before the join."""

    def __init__(self, table: KVPageTable, full_blocks: Dict[int, int]):
        self._table = table
        self._begun = {int(s): int(n) for s, n in full_blocks.items()}
        self._futures: List[Tuple[int, Future]] = []
        self._marks: List[Future] = []
        self._result: Optional[Dict[int, Dict[str, torch.Tensor]]] = None
        self._closed = False
        self.swap_s = 0.0
        self.window_s = 0.0
        self.exposed_s = 0.0
        self.hidden_s = 0.0
        self._t_last_done: Optional[float] = None
        self._t_begin = time.perf_counter()
        pages = self._page_list(self._begun)
        pool = table.pool
        if pool is not None and pages:
            # the guard brackets the pass's execution on the worker
            self._marks.append(
                table._fetch_exec.submit(pool._pass_begin, table.name))
        self._submit(pages)
        if pool is not None and pages:
            self._marks.append(
                table._fetch_exec.submit(pool._pass_end, table.name))
        if not self._futures:
            # nothing streamed in the window: hidden stays 0
            self._t_last_done = self._t_begin

    def _page_list(self, full_blocks: Dict[int, int],
                   already: Optional[Dict[int, int]] = None) -> List[int]:
        out = []
        for slot in sorted(full_blocks):
            lo = 0 if already is None else already.get(slot, 0)
            for blk in range(lo, full_blocks[slot]):
                out.append(self._table.page_index(slot, blk))
        return out

    def _submit(self, pages: List[int], track: bool = True) -> None:
        t = self._table
        if not pages:
            return
        t._log("kv", t.name, tuple((p, t.page_nbytes) for p in pages))
        for p in pages:
            fut = t._fetch_exec.submit(t._fetch_block, p)
            if track:
                # only the begin batch stamps the stream-ready time: the
                # fence's demand fetches land wholly in exposed
                fut.add_done_callback(self._mark_done)
            self._futures.append((p, fut))

    def _mark_done(self, _fut) -> None:
        self._t_last_done = time.perf_counter()

    @property
    def done(self) -> bool:
        return self._result is not None or self._closed

    def fence(self, full_blocks: Optional[Dict[int, int]] = None,
              timeout_s: Optional[float] = None
              ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Join the pass: demand-fetch blocks completed since begin, wait
        for every page, record the exposed / hidden split, and return
        ``{page_index: {"k": rows, "v": rows}}`` for the engine to
        scatter.  Idempotent.  ``timeout_s`` bounds the total wait; on
        expiry PageFetchTimeout is raised and the pass stays resumable
        (demand fetches submitted here are not submitted again)."""
        if self._closed:
            raise RuntimeError("fence() after close(): the pass was "
                               "cancelled")
        if self._result is not None:
            return self._result
        t_fence = time.perf_counter()
        if full_blocks is not None:
            self._submit(self._page_list(full_blocks, already=self._begun),
                         track=False)
            for slot, n in full_blocks.items():
                self._begun[int(slot)] = max(self._begun.get(int(slot), 0),
                                             int(n))
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for n_done, (p, fut) in enumerate(self._futures):
            try:
                remaining = (None if timeout_s is None else
                             max(0.0, timeout_s - (time.perf_counter()
                                                   - t_fence)))
                out[p] = fut.result(timeout=remaining)
            except FuturesTimeout:
                self._table.fault_counters["fetch_timeouts"] += 1
                raise PageFetchTimeout(
                    model=self._table.name, timeout_s=timeout_s,
                    pending=len(self._futures) - n_done) from None
        # the worker waited on each block's copy event: the rows are on the
        # device; hand them to the compute stream that scatters them
        if self._table._copy_stream is not None:
            stream = torch.cuda.current_stream(self._table.device)
            for rows in out.values():
                for t in rows.values():
                    t.record_stream(stream)
        t_join = time.perf_counter()
        t_ready = (self._t_last_done if self._t_last_done is not None
                   else t_join)
        self.window_s = t_fence - self._t_begin
        self.exposed_s = t_join - t_fence
        self.hidden_s = min(max(t_ready - self._t_begin, 0.0),
                            self.window_s)
        self.swap_s = self.hidden_s + self.exposed_s
        self._futures.clear()
        self._result = out
        return out

    def close(self) -> None:
        """Cancel what has not started, drain what has (a fetch error of
        the abandoned pass is raised here), release the pool's guard; a
        no-op on a fenced pass, and idempotent."""
        try:
            _drain([f for _p, f in self._futures] + self._marks)
        finally:
            self._futures.clear()
            self._marks.clear()
            if self._result is None:
                self._closed = True
            if self._table.pool is not None:
                self._table.pool._pass_end(self._table.name)

    def __enter__(self) -> "KVPageStream":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def kv_pass_counters(page_nbytes: Dict[str, Sequence[Any]],
                     budget_bytes: Optional[int],
                     events: Sequence[Tuple],
                     resident_slots: int = 2) -> Dict[str, Dict[str, int]]:
    """Static per-member counters of a pool whose members mix weight
    stores and KV page tables: the replay of its event log
    (:attr:`SharedPagePool.events`, or a pool-less
    :attr:`KVPageTable.events`) through the runtime's own lookup / admit
    / evict / invalidate sequence.  ``page_nbytes`` maps each *weight*
    member to its page sizes in access order (device-byte ints, or
    ``(device, wire, raw)`` triples; KV batches carry their sizes inline).
    The cache charges device bytes, every replayed swap adds wire / raw
    bytes to ``bytes_wire`` / ``bytes_raw``.  ``budget_bytes=None`` models
    a pool-less table: no cache, every fetch swaps."""
    cache: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
    live_bytes = 0
    out: Dict[str, Dict[str, int]] = {}

    def sizes3(entry) -> Tuple[int, int, int]:
        if isinstance(entry, (tuple, list)):
            dev, wire, raw = entry
            return int(dev), int(wire), int(raw)
        nb = int(entry)
        return nb, nb, nb

    def member(m: str) -> Dict[str, int]:
        return out.setdefault(m, dict(swaps=0, misses=0, pool_hits=0,
                                      evicted=0, dropped=0,
                                      bytes_wire=0, bytes_raw=0))

    def fetch(model: str, idx: int, size) -> None:
        nonlocal live_bytes
        nb, wire, raw = sizes3(size)
        key = (model, idx)
        if budget_bytes is not None and key in cache:
            cache.move_to_end(key)
            member(model)["pool_hits"] += 1
            return
        member(model)["swaps"] += 1
        member(model)["bytes_wire"] += wire
        member(model)["bytes_raw"] += raw
        if budget_bytes is None or nb > budget_bytes:
            return                  # mirrors admit's never-fits pre-check
        for victim in list(cache.keys()):
            if live_bytes + nb <= budget_bytes:
                break
            if victim[0] == model:
                continue
            live_bytes -= cache.pop(victim)
            member(victim[0])["evicted"] += 1
        if live_bytes + nb <= budget_bytes:
            cache[key] = nb
            live_bytes += nb

    for event in events:
        kind, model = event[0], event[1]
        if kind == "pass":
            m = member(model)
            sizes = page_nbytes[model]
            live: set = set()
            inflight: set = set()
            for e in make_schedule(len(sizes), resident_slots):
                if e.page in live:
                    pass
                elif e.page in inflight:
                    inflight.discard(e.page)
                    live.add(e.page)
                else:
                    m["misses"] += 1
                    fetch(model, e.page, sizes[e.page])
                    live.add(e.page)
                if e.prefetch_next is not None and e.prefetch_next not in live:
                    inflight.add(e.prefetch_next)
                    fetch(model, e.prefetch_next, sizes[e.prefetch_next])
                if e.evicts is not None:
                    live.discard(e.evicts)
        elif kind == "kv":
            m = member(model)
            for page, nb in event[2]:
                before = m["pool_hits"]
                fetch(model, int(page), nb)
                if m["pool_hits"] == before:
                    m["misses"] += 1     # every non-pooled KV fetch swaps
        elif kind == "kvdrop":
            for page in event[2]:
                nb = cache.pop((model, int(page)), None)
                if nb is not None:
                    live_bytes -= nb
                    member(model)["dropped"] += 1
        else:
            raise ValueError(f"unknown pool event kind {kind!r}")
    return out


def thread_packed(tree: Any, params: Dict[str, PackedParam],
                  prefix: str = "") -> Any:
    """``tree`` with each packed leaf group named in ``params`` (by path)
    pointing at that PackedParam's packed / scale tensors; the rest of the
    tree is shared, not copied."""
    if not isinstance(tree, dict):
        return tree
    if prefix in params and "packed" in tree:
        p = params[prefix]
        return {**tree, "packed": p.packed, "scale": p.scale}
    return {k: thread_packed(v, params, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}


def packed_tree_store(tree: Any, plan: Optional[PlacementPlan] = None
                      ) -> WeightStore:
    """:class:`WeightStore` view over a ``freeze_for_serving`` packed tree:
    one PackedParam per ``{"packed", "scale"}`` group, keyed by its path
    (for the stacked LM tree one entry per parameter group across all
    depths), the other leaves as passthrough.  As in the reference, the
    last dim of ``orig_shape`` is the carrier width times the packing
    factor."""
    leaves = flatten_tree(tree)
    params: Dict[str, PackedParam] = {}
    passthrough: Dict[str, Any] = {}
    for key, leaf in leaves.items():
        if key.endswith("/packed"):
            base = key[:-len("/packed")]
            bits = plan.bits_for(base) if plan is not None else 8
            orig_shape = (tuple(leaf.shape[:-1])
                          + (int(leaf.shape[-1]) * (8 // bits),))
            params[base] = PackedParam(packed=leaf,
                                       scale=leaves[base + "/scale"],
                                       bits=bits, orig_shape=orig_shape)
        elif (key.endswith("/scale")
                and key[:-len("/scale")] + "/packed" in leaves):
            continue
        else:
            passthrough[key] = leaf
    return WeightStore(params=params, passthrough=passthrough)
