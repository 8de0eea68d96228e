"""Deterministic fault injection for the paged-weight I/O layer.

A copy of ``repro/core/faults.py`` (which imports only ``hashlib``): the
typed paging errors, ``FaultPlan``, ``FaultInjector``, ``as_injector`` and
``merge_fault_counters``.  The paper's At-MRAM path gets integrity and
bounded latency from the hardware (ECC-protected MRAM reads); the software
page cache (``core/paging.HostPagedStore``) has to earn the same
guarantees, and this module is its adversary: a seeded, replayable fault
model for host->device page fetches.

Every fault decision is a pure function of ``(seed, kind, model, page,
attempt)`` (a blake2s hash), so a :class:`FaultPlan` replays exactly, and
the port gives the reference's fault sequence for the same seed.

Fault kinds
-----------
``fail``     transient fetch failure (the worker raises; the store retries
             with deterministic exponential backoff).
``bitflip``  wire-payload corruption (one bit of the fetched copy flips;
             the CRC32 stamped by ``build_pages`` catches it before the
             page is installed and the store re-fetches from host).
``spike``    one-off latency spike on the fetch worker thread.
``stuck``    a permanently-slow page: *every* attempt sleeps ``stuck_s``,
             modelling a degraded lane.  Used to exercise fetch
             deadlines (``fence(timeout_s=...)``) and tick deferral.

Transient faults (fail/bitflip/spike) are only injected while
``attempt < max_faulty_attempts``, which bounds the damage below the
store's ``max_attempts`` retry budget and makes eventual success a
structural guarantee rather than a probabilistic one.  Stuck delays are
exempt -- they model a slow lane, not a transient error, and fire on
every attempt so only a fetch deadline can route around them.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple, Union


# --------------------------------------------------------------------------
# Typed paging errors.
#
# Callers need to distinguish programming errors (a schedule that evicts an
# in-use page) from fault-path errors (a fetch that exhausted its retry
# budget).  Everything derives from PagingError so "anything the paging
# layer can raise" is one except clause.
# --------------------------------------------------------------------------


class PagingError(Exception):
    """Base class for all paged-weight I/O errors."""


class ScheduleError(PagingError):
    """A page schedule violates its own invariants (programming error)."""

    def __init__(self, message: str, *, page: Optional[int] = None,
                 model: Optional[str] = None):
        self.page = page
        self.model = model
        super().__init__(message)


class PageFetchError(PagingError):
    """A page fetch exhausted its retry budget."""

    def __init__(self, *, model: str, page: int, attempts: int,
                 last_error: Optional[BaseException] = None):
        self.model = model
        self.page = page
        self.attempts = attempts
        self.last_error = last_error
        detail = f": {last_error}" if last_error is not None else ""
        super().__init__(
            f"page fetch failed for model={model!r} page={page} "
            f"after {attempts} attempts{detail}")


class PageChecksumError(PagingError):
    """Fetched wire bytes fail CRC32 verification (caught pre-install)."""

    def __init__(self, *, model: str, page: int, expected: int, got: int):
        self.model = model
        self.page = page
        self.expected = expected
        self.got = got
        super().__init__(
            f"page checksum mismatch for model={model!r} page={page}: "
            f"expected {expected:#010x}, got {got:#010x}")


class PageFetchTimeout(PagingError):
    """A fence exceeded its I/O deadline; the pass is left resumable."""

    def __init__(self, *, model: str, timeout_s: float,
                 pending: Optional[int] = None):
        self.model = model
        self.timeout_s = timeout_s
        self.pending = pending
        extra = f" ({pending} fetches pending)" if pending is not None else ""
        super().__init__(
            f"fence for model={model!r} exceeded fetch deadline of "
            f"{timeout_s * 1e3:.1f} ms{extra}")


class TransientFetchFault(PagingError):
    """An injected transient fetch failure (internal; always retried)."""

    def __init__(self, *, model: str, page: int, attempt: int):
        self.model = model
        self.page = page
        self.attempt = attempt
        super().__init__(
            f"injected transient fetch fault: model={model!r} "
            f"page={page} attempt={attempt}")


# --------------------------------------------------------------------------
# Fault plan + injector.
# --------------------------------------------------------------------------

# Store-level fault reaction counters (HostPagedStore / KVPageTable each
# keep one dict of these; the scheduler adds "deferred_ticks" on top when
# the metrics `faults` section is assembled).
FAULT_COUNTER_KEYS: Tuple[str, ...] = (
    "injected", "retries", "checksum_failures", "refetches",
    "fetch_timeouts",
)


def new_fault_counters() -> Dict[str, int]:
    return {k: 0 for k in FAULT_COUNTER_KEYS}


@dataclass(frozen=True)
class FaultPlan:
    """Seeded description of which faults to inject, and the retry budget.

    Rates are per (model, page, attempt) fetch; ``stuck_pages`` lists
    ``(model, page)`` pairs whose every fetch attempt sleeps ``stuck_s``.
    """

    seed: int = 0
    fail_rate: float = 0.0
    bitflip_rate: float = 0.0
    spike_rate: float = 0.0
    spike_s: float = 0.002
    stuck_pages: Tuple[Tuple[str, int], ...] = ()
    stuck_s: float = 0.05
    # Transient faults only fire while attempt < max_faulty_attempts, so a
    # retry budget of max_attempts > max_faulty_attempts always succeeds.
    max_faulty_attempts: int = 2
    max_attempts: int = 4
    backoff_s: float = 0.0005
    backoff_cap_s: float = 0.01

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.max_faulty_attempts >= self.max_attempts:
            raise ValueError(
                "max_faulty_attempts must be < max_attempts so a fetch "
                "within the retry budget is guaranteed to succeed")
        for rate in (self.fail_rate, self.bitflip_rate, self.spike_rate):
            if not 0.0 <= rate <= 1.0:
                raise ValueError("fault rates must be in [0, 1]")
        object.__setattr__(self, "stuck_pages",
                           tuple((str(m), int(p)) for m, p in self.stuck_pages))

    def backoff(self, attempt: int) -> float:
        """Deterministic exponential backoff before retry `attempt`."""
        return min(self.backoff_s * (2 ** max(0, attempt - 1)),
                   self.backoff_cap_s)


class FaultInjector:
    """Applies a :class:`FaultPlan` to individual fetch attempts.

    Stateless beyond the plan (decisions are pure hashes), so one injector
    can be shared across several stores (e.g. a tenant's weight pager and
    its KV table).  The *stores* keep the fault counters
    (:func:`new_fault_counters`) -- the injector only decides and acts.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._stuck = frozenset(plan.stuck_pages)

    # -- deterministic decisions ------------------------------------------

    def _unit(self, kind: str, model: str, page: int, attempt: int) -> float:
        """Uniform [0, 1) value, pure in (seed, kind, model, page, attempt).

        blake2s rather than crc32: CRC is linear, so near-identical keys
        (same page, next attempt) produce correlated values and low rates
        would never fire; a cryptographic mix gives proper avalanche."""
        key = f"{self.plan.seed}:{kind}:{model}:{page}:{attempt}".encode()
        word = hashlib.blake2s(key, digest_size=4).digest()
        return int.from_bytes(word, "little") / 2.0 ** 32

    def _transient(self, kind: str, rate: float, model: str, page: int,
                   attempt: int) -> bool:
        if rate <= 0.0 or attempt >= self.plan.max_faulty_attempts:
            return False
        return self._unit(kind, model, page, attempt) < rate

    # -- injection hooks (called from the store's fetch worker) -----------

    def pre_fetch(self, model: str, page: int, attempt: int) -> int:
        """Latency faults + transient failures, before any bytes move.

        Sleeps for spikes/stuck lanes; raises :class:`TransientFetchFault`
        for an injected failure.  Runs on the fetch worker thread, so the
        sleeps model real I/O latency seen by ``fence()``.  Returns the
        number of *latency* faults injected (the caller folds it into its
        ``injected`` counter; an injected failure is counted by catching
        the raise).  Stuck-lane delays are a standing property of the
        page, not an injected event, and are not counted.
        """
        injected = 0
        delay = 0.0
        if (model, page) in self._stuck:
            delay += self.plan.stuck_s
        if self._transient("spike", self.plan.spike_rate, model, page, attempt):
            injected += 1
            delay += self.plan.spike_s
        if delay > 0.0:
            time.sleep(delay)
        if self._transient("fail", self.plan.fail_rate, model, page, attempt):
            raise TransientFetchFault(model=model, page=page, attempt=attempt)
        return injected

    def corrupt(self, model: str, page: int, attempt: int,
                buf: bytes) -> Optional[bytes]:
        """Maybe flip one bit of `buf`; returns the corrupted copy or None.

        The caller must apply the corruption to a *transient* copy of the
        wire bytes -- never to the pristine host store -- so a re-fetch
        observes clean data.
        """
        if not buf or not self._transient("bitflip", self.plan.bitflip_rate,
                                          model, page, attempt):
            return None
        bit = int(self._unit("bitpos", model, page, attempt) * len(buf) * 8)
        bit = min(bit, len(buf) * 8 - 1)
        out = bytearray(buf)
        out[bit // 8] ^= 1 << (bit % 8)
        return bytes(out)


FaultsArg = Union[None, FaultPlan, FaultInjector]


def as_injector(faults: FaultsArg) -> Optional[FaultInjector]:
    """Normalise a ``faults=`` argument: plan -> fresh injector, pass through."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    raise TypeError(f"faults must be a FaultPlan or FaultInjector, "
                    f"got {type(faults).__name__}")


def merge_fault_counters(parts: Iterable[Dict[str, int]]) -> Dict[str, int]:
    """Sum fault-counter dicts (missing keys count as zero)."""
    out = new_fault_counters()
    for part in parts:
        for k in FAULT_COUNTER_KEYS:
            out[k] += int(part.get(k, 0))
    return out
