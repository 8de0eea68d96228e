"""Software-assisted virtual weight paging (paper §II-B2), on one device.

Ports the single-device weight part of ``repro/core/paging.py``: ``Page``,
``page_sizes``, ``page_crc`` and ``build_pages`` (``:56-208``); the static
schedule (``PageScheduleEntry``, ``StallModel``, ``make_schedule``,
``validate_schedule``, ``:210-297``); the host wire images (``HostParam``,
``encode_host_param``, ``page_roundtrip_param``, ``page_crc_of_buffers``,
``retry_fetch``, ``:572-739``); ``HostPagedStore``, ``PageStream`` and
``AsyncPageStream`` (``:741-1229``); ``pass_counters`` (``:1231-1259``);
``thread_packed`` and ``packed_tree_store`` (``:2179-2229``).

Packed weights whose plan placement is ``paged`` live on the host in their
page *wire* encoding ("background flash"); every pass streams them to the
device, page by page, in a static access order, each page CRC-checked over
its wire bytes before it is installed.  A re-encoded int8 page of a
``wire_serve`` plan goes to the device as it crossed the wire, packed
levels with one scale per 32 weights, and the blockscale kernel multiplies
it from that form; every other page is decoded on the host first.

On a CUDA device each host image is pinned once, when the store is built
(the images are numpy views of page-locked memory).  The fetch worker
copies a page with ``non_blocking=True`` on a side CUDA stream, records an
event and waits on it before the page's future completes, so a fenced page
is on the device and ``fence``'s exposed / hidden split keeps its meaning.
The device tensors are allocated on the side stream; when a pass hands a
page over (``fence``, or the sync stream's yield) they are marked
(``record_stream``) for the stream current then, so the caching allocator
cannot give their memory to the next copy while compute still reads it.

Not ported here, each raising where the API reaches it: the shared page
pool of several tenants (``SharedPagePool``, ``pool=``: ROADMAP A8), the
mesh-sharded stores (A11) and KV-cache paging (``KVPageTable`` and its
stream: A7).  The reference's tracer hooks wait for the tracer (A5).
"""

from __future__ import annotations

import dataclasses
import time
import zlib
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
    ``store.fault_counters``."""
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
            else:
                store.fault_counters["checksum_failures"] += 1
                store.fault_counters["refetches"] += 1
            attempt += 1
            if attempt >= max_attempts:
                raise PageFetchError(model=store.name, page=idx,
                                     attempts=attempt, last_error=e) from e
            store.fault_counters["retries"] += 1
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

    ``faults`` (a FaultPlan or FaultInjector) puts every fetch attempt
    under seeded fault injection with CRC-verified retry.  ``device``
    defaults to ``cuda`` and raises without a card.
    """

    def __init__(self, store: WeightStore, page_bytes: int,
                 device: DeviceLike = None,
                 plan: Optional[PlacementPlan] = None,
                 pool: Optional[Any] = None, name: str = "default",
                 faults: FaultsArg = None):
        if pool is not None:
            raise NotImplementedError("a page pool shared by several "
                                      "stores arrives with tenancy "
                                      "(ROADMAP A8)")
        self.plan = plan
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
        self._pool = ThreadPoolExecutor(max_workers=1)
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

    def _fetch_page(self, idx: int) -> Dict[str, PackedParam]:
        if self._closed:
            raise CancelledError(f"{self.name}: store closed before fetch "
                                 f"of page {idx} started")
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
        stream's copies only after that stream's work on them is done."""
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
        self._pool.shutdown(wait=wait, cancel_futures=not wait)

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
                    self._inflight[e.prefetch_next] = st._pool.submit(
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
    (``swap_s``, ``window_s``)."""

    def __init__(self, store: HostPagedStore, resident_slots: int = 2):
        self._store = store
        self._result: Optional[Dict[str, PackedParam]] = None
        self._closed = False
        self.swap_s = 0.0
        self.window_s = 0.0
        self.exposed_s = 0.0
        self.hidden_s = 0.0
        self._t_ready: Optional[float] = None   # last fetch completion
        self._t_begin = time.perf_counter()
        self._futures: List[Tuple[int, Future]] = []
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
                    (e.page, store._pool.submit(store._fetch_page, e.page)))
                live.add(e.page)
            if e.prefetch_next is not None and e.prefetch_next not in live:
                inflight.add(e.prefetch_next)
                self._futures.append(
                    (e.prefetch_next,
                     store._pool.submit(store._fetch_page, e.prefetch_next)))
            if e.evicts is not None:
                live.discard(e.evicts)
        if self._futures:
            self._futures[-1][1].add_done_callback(self._mark_ready)
        else:
            self._t_ready = self._t_begin

    def _mark_ready(self, _fut) -> None:
        self._t_ready = time.perf_counter()

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
        the abandoned pass is raised here); a no-op on a fenced pass, and
        idempotent."""
        _drain([f for _i, f in self._futures])
        self._futures.clear()
        if self._result is None:
            self._closed = True

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
