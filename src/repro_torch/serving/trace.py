"""Chrome-trace span instrumentation for the serving tick pipeline
(reference: ``repro/serving/trace.py``, copied: it uses only the stdlib).

The timeline view of serving: a zero-dependency span tracer whose output is
Chrome Trace Event Format JSON (``chrome://tracing`` or Perfetto).  Every
tick's fence -> admit -> begin -> compute phases, every per-page
host->device fetch, every preemption / admission verdict and the
closed-form stall prediction (:func:`repro_torch.core.memsys.overlap_stall`)
render as parallel tracks.

  * **no-op when absent**: every instrumented hot path guards on
    ``tracer is None`` (the default), so the untraced tick loop pays one
    attribute load and a branch and allocates nothing;
  * **thread-safe**: page fetches run on the pager's worker thread while
    the scheduler emits from the tick loop; one lock serializes event
    append and track registration;
  * **monotonic clock**: timestamps come from ``time.perf_counter`` (via
    :data:`now`, the one canonical timestamp helper of the serving stack)
    and are exported as microseconds relative to tracer construction.

``span`` emits ``B``/``E`` pairs (single-emitter tracks: scheduler
phases), ``complete`` one ``X`` event with an explicit duration
(worker-thread page fetches, the retro-dated stall spans), ``instant``
``i`` (admission verdicts, preemptions), ``counter`` ``C``.  Track names
become ``thread_name`` metadata, one tid per track.  A swap's ``page`` span
on the ``io`` track carries ``nbytes`` (device footprint), ``wire_nbytes``
(what the link moved) and ``encoding``.

:func:`validate` asserts structural validity (every ``B`` has a matching
``E``, ``B``/``E``/``i`` timestamps monotonic per track, non-negative ``X``
durations); :func:`doc_tracks`, :func:`span_durations` and
:func:`instant_count` are the query helpers that reconcile a trace with the
metrics document.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: The canonical monotonic timestamp source for the serving stack.
#: ``engine`` and ``sched`` stamp through this single alias
#: instead of sprinkling their own ``time.perf_counter`` bracketing
#: (identity is preserved — ``now is time.perf_counter`` — so clock-
#: domain checks like ``clock is not time.perf_counter`` still hold).
now: Callable[[], float] = time.perf_counter


class Stopwatch:
    """The one ``t0 = clock(); ...; dt = clock() - t0`` bracketing
    helper.  Use as a context manager (``with Stopwatch() as sw: ...;
    sw.elapsed_s``) or via :meth:`start`/:meth:`stop`; the clock is
    injectable for virtual-time benches."""

    __slots__ = ("clock", "t0_s", "elapsed_s")

    def __init__(self, clock: Callable[[], float] = now):
        self.clock = clock
        self.t0_s = 0.0
        self.elapsed_s = 0.0

    def start(self) -> "Stopwatch":
        self.t0_s = self.clock()
        return self

    def stop(self) -> float:
        self.elapsed_s = self.clock() - self.t0_s
        return self.elapsed_s

    def __enter__(self) -> "Stopwatch":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


class _NullSpan:
    """The reusable disabled span: one module-wide instance, zero
    allocations per use (class attributes, empty ``__slots__``)."""

    __slots__ = ()
    t0_s = 0.0
    dur_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """One live ``B``/``E`` pair.  After ``__exit__``, :attr:`dur_s`
    holds the measured duration, so a consumer reads its step time from
    the span instead of keeping its own bracketing."""

    __slots__ = ("_tracer", "name", "track", "args", "t0_s", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0_s = 0.0
        self.dur_s = 0.0

    def __enter__(self) -> "Span":
        self.t0_s = self._tracer.clock()
        self._tracer._emit("B", self.name, self.track, self.t0_s,
                           self.args)
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer.clock()
        self.dur_s = t1 - self.t0_s
        self._tracer._emit("E", self.name, self.track, t1, None)
        return False


class Tracer:
    """Collects trace events and renders Chrome Trace Event JSON.

    ``clock`` must be monotonic (default :data:`now` ==
    ``time.perf_counter``); timestamps are exported in microseconds
    relative to construction.  ``enabled=False`` turns every emit
    method into an immediate return and :meth:`span` into the shared
    no-allocation null span — the programmatic off switch (the serving
    hot paths additionally guard on ``tracer is None`` so the default
    un-traced run never even reaches these methods)."""

    def __init__(self, clock: Callable[[], float] = now,
                 enabled: bool = True, pid: int = 0):
        self.clock = clock
        self.enabled = bool(enabled)
        self.pid = int(pid)
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[str, int] = {}
        self._t0 = clock()

    # -- internals ------------------------------------------------------------
    def _ts_us(self, t_s: float) -> float:
        return (t_s - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        """Track name -> tid, registering (and emitting the
        ``thread_name`` metadata event) on first use.  Caller holds the
        lock."""
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
            self._events.append(dict(name="thread_name", ph="M",
                                     pid=self.pid, tid=tid,
                                     args=dict(name=track)))
        return tid

    def _emit(self, ph: str, name: str, track: str, t_s: float,
              args: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            ev: Dict[str, Any] = dict(name=name, ph=ph, pid=self.pid,
                                      tid=self._tid(track),
                                      ts=self._ts_us(t_s))
            if ph == "i":
                ev["s"] = "t"          # thread-scoped instant
            if args:
                ev["args"] = args
            self._events.append(ev)

    # -- emit API -------------------------------------------------------------
    def span(self, name: str, track: str = "main", **args):
        """A ``with``-able duration span on ``track``.  Enter emits
        ``B``, exit emits ``E`` and records ``dur_s``.  Spans on one
        track must nest (single-emitter tracks); concurrent emitters
        should use :meth:`complete` instead."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, track, args or None)

    def instant(self, name: str, track: str = "main", **args) -> None:
        """A zero-duration marker (``i``): admission verdicts,
        preemptions, evictions, straggler flags."""
        if not self.enabled:
            return
        self._emit("i", name, track, self.clock(), args or None)

    def counter(self, name: str, track: str = "main", **values) -> None:
        """A counter sample (``C``) — Perfetto renders each key of
        ``values`` as a stacked series (e.g. pool occupancy bytes)."""
        if not self.enabled:
            return
        self._emit("C", name, track, self.clock(), values)

    def complete(self, name: str, dur_s: float, track: str = "main",
                 end_offset_s: float = 0.0, **args) -> None:
        """One already-finished span (``X``) ending ``end_offset_s``
        seconds before *now* with duration ``dur_s`` — the shape for
        worker-thread page fetches (measured locally, emitted once
        done) and for retro-dating stall spans whose window closed
        before the accounting ran."""
        if not self.enabled:
            return
        t1 = self.clock() - end_offset_s
        with self._lock:
            ev: Dict[str, Any] = dict(
                name=name, ph="X", pid=self.pid, tid=self._tid(track),
                ts=self._ts_us(t1 - max(dur_s, 0.0)),
                dur=max(dur_s, 0.0) * 1e6)
            if args:
                ev["args"] = args
            self._events.append(ev)

    def now(self) -> float:
        """The tracer's clock — instrumented code stamps through this so
        span math stays in one clock domain."""
        return self.clock()

    # -- introspection / export ----------------------------------------------
    @property
    def event_count(self) -> int:
        """Emitted events, excluding track-name metadata."""
        with self._lock:
            return sum(1 for e in self._events if e["ph"] != "M")

    @property
    def track_names(self) -> List[str]:
        with self._lock:
            return list(self._tids)

    def summary(self) -> Dict[str, Any]:
        return dict(events=self.event_count, tracks=self.track_names)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"traceEvents": [dict(e) for e in self._events],
                    "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")

    def validate(self) -> Dict[str, Any]:
        return validate(self.to_dict())


# ---------------------------------------------------------------------------
# validation + query helpers (what CI and the reconciliation tests run)
# ---------------------------------------------------------------------------

_KNOWN_PH = ("B", "E", "X", "i", "C", "M")


def validate(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Assert ``doc`` is structurally valid Chrome Trace Event JSON:

      * a dict with a ``traceEvents`` list, every event carrying
        ``name``/``ph``/``pid``/``tid`` (plus ``ts`` for non-metadata);
      * every ``B`` closed by a matching same-name ``E`` on its
        (pid, tid) track, properly nested;
      * ``B``/``E``/``i`` timestamps non-decreasing per track (the
        single-emitter invariant; ``X`` events are retro-dated by
        design and are only required to have non-negative durations).

    Returns the document unchanged; raises ValueError naming the first
    violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace document: missing 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' is not a list")
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    last_ts: Dict[Tuple[Any, Any], float] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i} missing {k!r}")
        ph = ev["ph"]
        if ph not in _KNOWN_PH:
            raise ValueError(f"event {i} has unknown ph {ph!r}")
        if ph == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"event {i} ({ev['name']!r}) missing 'ts'")
        key = (ev["pid"], ev["tid"])
        if ph in ("B", "E", "i"):
            # 1 ns slack: float µs round-trips through JSON
            if ev["ts"] + 1e-3 < last_ts.get(key, float("-inf")):
                raise ValueError(
                    f"event {i} ({ev['name']!r}): ts went backwards on "
                    f"track {key}")
            last_ts[key] = max(last_ts.get(key, float("-inf")), ev["ts"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: 'E' {ev['name']!r} "
                                 f"without an open 'B' on track {key}")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(f"event {i}: 'E' {ev['name']!r} closes "
                                 f"'B' {top!r} on track {key}")
        elif ph == "X":
            if ev.get("dur", 0.0) < 0.0:
                raise ValueError(f"event {i} ({ev['name']!r}): negative "
                                 f"'X' duration")
    for key, stack in stacks.items():
        if stack:
            raise ValueError(f"unclosed 'B' events {stack} on track {key}")
    return doc


def doc_tracks(doc: Dict[str, Any]) -> List[str]:
    """Track names in tid registration order, from the ``thread_name``
    metadata events."""
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            out.append(ev.get("args", {}).get("name", ""))
    return out


def _track_tids(doc: Dict[str, Any], track: Optional[str]
                ) -> Optional[set]:
    if track is None:
        return None
    return {ev["tid"] for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"
            and ev.get("args", {}).get("name") == track}


def span_durations(doc: Dict[str, Any], name: str,
                   track: Optional[str] = None) -> List[float]:
    """Durations (seconds) of every completed span called ``name`` —
    matched ``B``/``E`` pairs and ``X`` events alike, optionally
    restricted to one track."""
    tids = _track_tids(doc, track)
    out: List[float] = []
    open_b: Dict[Tuple[Any, Any], List[Tuple[str, float]]] = {}
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M" or (tids is not None and ev.get("tid") not in tids):
            continue
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X" and ev["name"] == name:
            out.append(ev.get("dur", 0.0) / 1e6)
        elif ph == "B":
            open_b.setdefault(key, []).append((ev["name"], ev["ts"]))
        elif ph == "E":
            stack = open_b.get(key)
            if stack:
                b_name, b_ts = stack.pop()
                if b_name == name:
                    out.append((ev["ts"] - b_ts) / 1e6)
    return out


def instant_count(doc: Dict[str, Any], name: str,
                  track: Optional[str] = None) -> int:
    """How many ``i`` events called ``name`` the trace holds."""
    tids = _track_tids(doc, track)
    return sum(1 for ev in doc.get("traceEvents", [])
               if ev.get("ph") == "i" and ev.get("name") == name
               and (tids is None or ev.get("tid") in tids))
