"""Flight recorder: cross-thread latency attribution for the serving
hot path (the per-event sibling of the aggregate phase counters, and
the cross-thread extension of the reference's query tracer + slow-query
log: lib/querytracer sees one query's own spans, this sees what ELSE the
process was doing while the query ran).

Always-on, low-overhead: every thread that records owns a private
fixed-capacity ring of (t0, dur, name, ctx, arg) event slots.  The ring
arrays are preallocated at first use; the record path is index
arithmetic + five slot stores + one integer bump — no allocation, no
lock, no syscall.  Writers never synchronize with readers: a capture
snapshots each ring's write cursor and walks backward, and any slot the
writer overtook mid-read is discarded by re-checking the cursor (the
classic seqlock-reader discipline, per-slot granularity is one event so
a torn event can only be dropped, never misattributed).

Event model: COMPLETE spans (Chrome trace ``"ph": "X"``) recorded at
END time — callers time the region themselves (they already do, for the
phase counters) and call :func:`rec` once.  Instant events
(``"ph": "i"``) mark decisions (cache inplace/rebuild, merge-gate
yields).  Timestamps are ``time.perf_counter()`` floats — one monotonic
clock shared by every thread, so cross-thread overlap is meaningful.

Cross-thread attribution: a serving thread opens a *flight context*
(:func:`set_ctx`, an integer id per refresh/query); utils/workpool
propagates the submitting thread's ctx to its pool workers around each
task, so fetch/decode spans executed on workers carry the query's ctx
and :func:`ctx_events` can reassemble one query's work from every
thread's ring (the per-phase split the slow-query log records).

Capture: :meth:`FlightRecorder.capture` merges the live window of all
thread rings into one Chrome trace-event-format JSON object
(Perfetto/chrome://tracing-loadable) and keeps it in a bounded ring of
recent captures served at ``/api/v1/status/flight``.  The serving layer
triggers a capture when a refresh exceeds ``VM_SLOW_REFRESH_MS``;
anything can trigger one on demand.

``VM_FLIGHTREC=0`` is the escape hatch: :func:`rec`/:func:`instant`
return after one global-flag check and captures return empty.

Self-metrics: ``vm_flight_captures_total``,
``vm_flight_dropped_events_total`` (ring-overwritten events noticed at
capture time), ``vm_flight_events_total`` is deliberately absent — a
per-event counter bump would double the record cost.

The port's copy of ``victoriametrics_tpu/utils/flightrec.py``, whole.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["enabled", "rec", "instant", "span", "new_ctx", "set_ctx",
           "get_ctx", "ctx_events", "clear_ctx", "RECORDER",
           "FlightRecorder", "reconfigure"]

#: ring capacity per thread (events); power of two for mask arithmetic
_DEFAULT_CAP = 1 << 13


def _env_enabled() -> bool:
    return os.environ.get("VM_FLIGHTREC", "1") != "0"


def _env_cap() -> int:
    try:
        n = int(os.environ.get("VM_FLIGHTREC_EVENTS", "0"))
    except ValueError:
        n = 0
    if n <= 0:
        return _DEFAULT_CAP
    # round up to a power of two (the record path uses `& mask`)
    return 1 << max(n - 1, 1).bit_length()


_ENABLED = _env_enabled()


def enabled() -> bool:
    """True when the recorder is on (``VM_FLIGHTREC`` != 0)."""
    return _ENABLED


def reconfigure() -> None:
    """Re-read ``VM_FLIGHTREC`` (tests flip the env var mid-process;
    production reads it once at import)."""
    global _ENABLED
    _ENABLED = _env_enabled()


class _Ring:
    """One thread's event ring.  Only the owner thread writes; capture
    threads read racily and validate against the cursor afterward.

    Slots are parallel preallocated lists (not tuples): a record is five
    slot stores + one cursor bump, allocating nothing."""

    __slots__ = ("t0", "dur", "name", "ctx", "arg", "i", "w", "cap",
                 "mask", "tid", "tname", "taken", "thread")

    def __init__(self, cap: int, thread: threading.Thread):
        self.t0 = [0.0] * cap
        self.dur = [0.0] * cap
        self.name = [""] * cap
        self.ctx = [0] * cap
        self.arg = [None] * cap
        self.i = 0          # monotonic write cursor (slot = i & mask)
        self.w = -1         # cursor mid-store marker: w == i <=> in rec()
        self.cap = cap
        self.mask = cap - 1
        self.tid = thread.ident or 0
        self.tname = thread.name
        self.taken = 0      # first cursor NOT yet included in a capture
        self.thread = thread    # liveness probe for ring reclamation

    def newest_t0(self) -> float:
        """t0 of the most recent event (0.0 when empty); racy read, only
        meaningful for DEAD owners (no concurrent writer)."""
        if self.i == 0:
            return 0.0
        return self.t0[(self.i - 1) & self.mask]

    def snapshot(self, min_t0: float) -> list[tuple]:
        """Racy read of the live window: events with t0 >= min_t0, oldest
        first.  Slots overwritten while reading are re-checked against the
        advanced cursor and dropped (seqlock-reader discipline)."""
        end = self.i
        lo = max(end - self.cap, 0)
        out = []
        t0s, durs, names, ctxs, args = (self.t0, self.dur, self.name,
                                        self.ctx, self.arg)
        mask = self.mask
        for k in range(lo, end):
            j = k & mask
            t0 = t0s[j]
            if t0 < min_t0:
                continue
            out.append((t0, durs[j], names[j], ctxs[j], args[j], k))
        # validate: any slot the writer lapped during the walk holds a
        # NEWER event than its cursor position promised — discard those.
        # STRICT bound: the writer stores the five slots BEFORE bumping
        # the cursor, so the slot at cursor (i - cap) may be mid-store
        # (torn) while i still reads one low — drop it too.  Costs at
        # most the single oldest event of an idle full ring; keeps the
        # "can drop, never misattribute" guarantee.
        min_keep = self.i - self.cap
        if min_keep >= lo:
            out = [e for e in out if e[5] > min_keep]
        return out


_tls = threading.local()

# every ring ever created (threads die, their last events remain
# capturable); appended under _rings_lock, iterated lock-free by capture
_rings: list[_Ring] = []
_rings_lock = threading.Lock()

_ctx_counter = [0]
_ctx_lock = threading.Lock()


def _prune_dead_rings(min_t0: float) -> None:
    """Drop rings whose owner thread died AND whose newest event has
    aged out of the capture window.  Without this, one ring per
    recording thread (e.g. per-connection HTTP handler threads) leaks
    forever; with it, a dead thread's last events stay capturable for
    the window and the ring list stays bounded by live threads +
    recently-dead ones.  Caller holds _rings_lock."""
    keep = [r for r in _rings
            if r.thread.is_alive() or r.newest_t0() >= min_t0]
    if len(keep) != len(_rings):
        _rings[:] = keep


def _prune_window_s() -> float:
    try:
        return float(os.environ.get("VM_FLIGHT_WINDOW_S", "60"))
    except ValueError:
        return 60.0


def _new_ring() -> _Ring:
    ring = _Ring(_env_cap(), threading.current_thread())
    with _rings_lock:
        _prune_dead_rings(time.perf_counter() - _prune_window_s())
        _rings.append(ring)
    return ring


def rec(name: str, t0: float, dur: float, arg=None) -> None:
    """Record one complete span [t0, t0+dur) (perf_counter seconds) on
    the calling thread's ring.  The hot-path primitive: one flag check,
    one TLS lookup, five slot stores, one cursor bump."""
    if not _ENABLED:
        return
    ring = getattr(_tls, "ring", None)
    if ring is None:
        ring = _tls.ring = _new_ring()
    i = ring.i
    # w == i marks this slot mid-store: the gc hook (which can fire
    # DURING these stores — the cursor bump's int allocation can
    # trigger a collection) checks it and stands down instead of
    # interleaving a second event into the same slot
    ring.w = i
    j = i & ring.mask
    ring.t0[j] = t0
    ring.dur[j] = dur
    ring.name[j] = name
    ring.ctx[j] = getattr(_tls, "ctx", 0)
    ring.arg[j] = arg
    ring.i = i + 1


def instant(name: str, arg=None) -> None:
    """Record a zero-duration marker (a decision, not a region)."""
    if not _ENABLED:
        return
    rec(name, time.perf_counter(), 0.0, arg)


class _Span:
    """``with flightrec.span("name"):`` — times the body and records one
    complete event on exit (even when the body raises)."""

    __slots__ = ("name", "arg", "t0")

    def __init__(self, name: str, arg=None):
        self.name = name
        self.arg = arg

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec(self.name, self.t0, time.perf_counter() - self.t0, self.arg)
        return False


def span(name: str, arg=None) -> _Span:
    return _Span(name, arg)


# -- flight context (cross-thread query attribution) --------------------------

def new_ctx() -> int:
    """Fresh nonzero context id for one query/refresh."""
    with _ctx_lock:
        _ctx_counter[0] += 1
        return _ctx_counter[0]


def set_ctx(ctx: int) -> int:
    """Install `ctx` as the calling thread's flight context; returns the
    previous one (callers restore it).  utils/workpool calls this around
    each task with the submitter's ctx."""
    prev = getattr(_tls, "ctx", 0)
    _tls.ctx = ctx
    return prev


def get_ctx() -> int:
    return getattr(_tls, "ctx", 0)


def clear_ctx() -> None:
    _tls.ctx = 0


def note_capture(cap_id: int) -> None:
    """Thread-local hand-off: the serving layer notes the capture id a
    slow refresh just produced so the HTTP handler (same thread, outer
    frame) can attach it to the slow-query record."""
    _tls.noted_capture = cap_id


def take_noted_capture() -> int | None:
    cap_id = getattr(_tls, "noted_capture", None)
    _tls.noted_capture = None
    return cap_id


def ctx_events(ctx: int, window_s: float = 120.0) -> list[tuple]:
    """Every live ring event carrying `ctx`, merged across threads and
    sorted by t0: (t0, dur, name, tid).  The slow-query log uses this to
    compute a per-phase split for ONE query even though the phase spans
    ran on several pool workers."""
    if ctx == 0:
        return []
    min_t0 = time.perf_counter() - window_s
    with _rings_lock:
        rings = list(_rings)
    out = []
    for ring in rings:
        for t0, dur, name, c, _arg, _k in ring.snapshot(min_t0):
            if c == ctx:
                out.append((t0, dur, name, ring.tid))
    out.sort(key=lambda e: e[0])
    return out


def phase_split(ctx: int, window_s: float = 120.0) -> dict[str, float]:
    """Per-name span seconds for one flight context (the slow-query
    log's per-phase split), summed across every thread that worked on
    the query."""
    split: dict[str, float] = {}
    for _t0, dur, name, _tid in ctx_events(ctx, window_s):
        if dur > 0.0:
            split[name] = split.get(name, 0.0) + dur
    return split


# -- capture ------------------------------------------------------------------

class FlightRecorder:
    """Owner of the bounded capture ring.  One process-wide instance
    (:data:`RECORDER`); tests may build private ones (they share the
    thread rings — captures differ only in their retention ring)."""

    def __init__(self, max_captures: int | None = None):
        if max_captures is None:
            try:
                max_captures = int(os.environ.get("VM_FLIGHT_CAPTURES", "8"))
            except ValueError:
                max_captures = 8
        import collections
        self._lock = threading.Lock()
        # builds serialize on their own lock so a serving-path
        # capture(defer_build=True) — which only needs _lock for the
        # id/append — never stalls behind a retrieval building traces
        self._build_lock = threading.Lock()
        self._captures: "collections.deque[dict]" = collections.deque(
            maxlen=max(max_captures, 1))
        self._next_id = 0
        from . import metrics as metricslib
        self._captures_total = metricslib.REGISTRY.counter(
            "vm_flight_captures_total")
        self._dropped_total = metricslib.REGISTRY.counter(
            "vm_flight_dropped_events_total")

    # .. capture ..............................................................

    def capture(self, reason: str, window_s: float | None = None,
                meta: dict | None = None,
                defer_build: bool = False) -> dict | None:
        """Merge the live window of every thread ring into one Chrome
        trace-event JSON object and retain it.  Returns the capture
        record (meta + ``"trace"``), or None when the recorder is off.

        ``defer_build=True`` (the slow-refresh trigger path) does only
        the part that races the writers — snapshotting the rings — and
        postpones building the trace dicts and attribution summary until
        first retrieval, so the cost charged to the slow refresh itself
        (and to the latency its trigger is measuring — the observer
        effect) is the raw slot copy, not the JSON assembly."""
        if not _ENABLED:
            return None
        if window_s is None:
            window_s = _prune_window_s()
        now = time.perf_counter()
        min_t0 = now - window_s
        with _rings_lock:
            # reclaim dead-thread rings past the RETENTION window (not
            # this capture's, which may be narrower)
            _prune_dead_rings(
                now - max(window_s, _prune_window_s()))
            rings = list(_rings)
        snaps = []
        dropped = 0
        for ring in rings:
            snap = ring.snapshot(min_t0)
            # overwritten-before-capture accounting: cursor positions
            # below (i - cap) that no capture ever included are gone.
            # ring.taken is only ever touched by captures — serialize
            # the read-modify-write under _rings_lock so two concurrent
            # captures can't double-count the same lost events
            with _rings_lock:
                lost_floor = ring.i - ring.cap
                if lost_floor > ring.taken:
                    dropped += lost_floor - ring.taken
                    ring.taken = lost_floor
                if snap:
                    # first-uncaptured, hence the +1: snap[-1][5] itself
                    # WAS captured — counting it as lost on the next
                    # wrap would report drops on a lossless system
                    ring.taken = max(ring.taken, snap[-1][5] + 1)
            if snap:
                # tid/tname, not the ring itself: holding the ring would
                # keep a dead thread's slot arrays alive past the prune
                snaps.append((ring.tid, ring.tname, snap))
        if dropped:
            self._dropped_total.inc(dropped)
        from . import fasttime
        cap = {
            "reason": reason,
            "unix_ms": fasttime.unix_ms(),
            "window_s": window_s,
            "n_events": sum(len(s) for _t, _n, s in snaps),
            "n_threads": len(snaps),
            "_raw": (snaps, now),
        }
        if meta:
            cap.update(meta)
        with self._lock:
            self._next_id += 1
            cap["id"] = self._next_id
            self._captures.append(cap)
        self._captures_total.inc()
        if not defer_build:
            self._build(cap)
        return cap

    def _build(self, cap: dict) -> None:
        """Turn a capture's raw ring snapshots into ``cap["trace"]`` +
        ``cap["summary"]`` (idempotent; concurrent retrievals serialize
        on the build lock, so the loser waits and then sees the winner's
        finished build instead of a half-written capture)."""
        with self._build_lock:
            raw = cap.pop("_raw", None)
            if raw is None:
                return
            snaps, now = raw
            # trace timestamps are µs relative to the window start, so
            # the Perfetto timeline starts at ~0 regardless of process
            # uptime.  Global min over ALL events: rings are in
            # COMPLETION order (spans record at end time), so a ring's
            # first entry is not its earliest t0 — an enclosing span
            # lands after its children and would otherwise get a
            # negative ts
            epoch = min((e[0] for _tid, _tn, snap in snaps for e in snap),
                        default=now)
            trace_events = []
            pid = os.getpid()
            for tid, tname, snap in snaps:
                trace_events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
                for t0, dur, name, ctx, arg, _k in snap:
                    ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
                          "ts": round((t0 - epoch) * 1e6, 1),
                          "dur": round(dur * 1e6, 1)}
                    if dur == 0.0:
                        ev["ph"] = "i"
                        ev["s"] = "t"
                        del ev["dur"]
                    args = {}
                    if ctx:
                        args["ctx"] = ctx
                    if arg is not None:
                        args["arg"] = arg
                    if args:
                        ev["args"] = args
                    trace_events.append(ev)
            trace_events.sort(key=lambda e: e.get("ts", 0.0))
            cap["trace"] = {"traceEvents": trace_events,
                            "displayTimeUnit": "ms"}
            cap["summary"] = summarize(
                trace_events, focus_ctx=cap.get("ctx", 0))

    # .. retrieval ............................................................

    def total(self) -> int:
        """Monotonic count of captures ever taken (ids are 1..total);
        unlike ``len(list())`` it is not bounded by the retention ring."""
        with self._lock:
            return self._next_id

    def list(self) -> list[dict]:
        """Capture metadata, newest first (everything but the trace)."""
        with self._lock:
            caps = list(self._captures)
        for c in caps:
            self._build(c)
        return [{k: v for k, v in c.items() if k != "trace"}
                for c in reversed(caps)]

    def get(self, cap_id: int) -> dict | None:
        with self._lock:
            found = None
            for c in self._captures:
                if c["id"] == cap_id:
                    found = c
                    break
        if found is not None:
            self._build(found)
        return found

    def clear(self) -> None:
        with self._lock:
            self._captures.clear()


def summarize(trace_events: list[dict], focus_ctx: int = 0) -> dict:
    """Attribution summary of one capture: total span ms by event name,
    plus — when the capture contains serve:refresh spans — the slowest
    refresh and the background work overlapping it by category (the
    "which work overlapped the slow refresh" answer, precomputed so the
    JSON artifact and the HTTP list are readable without Perfetto).

    `focus_ctx` pins WHICH refresh gets the overlap treatment: a
    slow-refresh-triggered capture passes the triggering refresh's
    flight context so the summary explains THAT refresh, not whatever
    bigger serve span (e.g. the cold first eval) shares the window.
    0 (on-demand captures) falls back to the slowest serve span."""
    by_name: dict[str, float] = {}
    serves = []
    for ev in trace_events:
        if ev["ph"] != "X":
            continue
        dur = ev.get("dur", 0.0)
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + dur
        if ev["name"] == "serve:refresh":
            serves.append(ev)
    out = {"span_ms_by_name": {k: round(v / 1e3, 3)
                               for k, v in sorted(by_name.items())}}
    if focus_ctx:
        focused = [e for e in serves
                   if e.get("args", {}).get("ctx", 0) == focus_ctx]
        serves = focused or serves
    if serves:
        slow = max(serves, key=lambda e: e["dur"])
        s0, s1 = slow["ts"], slow["ts"] + slow["dur"]
        sctx = slow.get("args", {}).get("ctx", 0)
        overlap: dict[str, list] = {}
        waiting: dict[str, list] = {}
        for ev in trace_events:
            if ev["ph"] != "X" or ev is slow:
                continue
            # overlap of [ts, ts+dur) with the slow serve window,
            # excluding the serve's own work (same ctx) — what's left is
            # the INTERFERING work the refresh had to share cores with.
            # ctx-only, NOT tid: ambient work that ran ON the serve
            # thread (a gc pause, a foreign pool task the blocked serve
            # thread helped with) carries ctx 0 / another ctx and IS
            # part of the latency story
            if ev.get("args", {}).get("ctx", 0) == sctx:
                continue
            lo = max(ev["ts"], s0)
            hi = min(ev["ts"] + ev.get("dur", 0.0), s1)
            if hi <= lo:
                continue
            name = ev["name"]
            # pure waits are DEFERENCE, not interference: a merge
            # sleeping in the serve-priority yield (or queued at a gate)
            # consumed no CPU during the refresh — charging it as
            # "merge overlap" would invert the attribution.  Reported
            # separately so the deference is still visible.  (lock:*
            # waits stay in the overlap buckets: a thread stalled on a
            # lock a serve-path thread holds IS part of the story.)
            if name.endswith((":queue_wait", ":gate_wait", ":yield")):
                waiting.setdefault(name, []).append((lo, hi))
                continue
            cat = name.split(":", 1)[0]
            overlap.setdefault(cat, []).append((lo, hi))
        # interval UNION per bucket, not a sum: nested spans (the
        # flush:table fan span contains its workers' flush:part spans)
        # and repeated waits would otherwise report more overlap than
        # the refresh's own duration.  The number is wall-clock coverage
        # ("merge work was running for X of the refresh's Y ms"), not
        # cpu-seconds.
        out["slow_refresh"] = {
            "ms": round(slow["dur"] / 1e3, 3),
            "ctx": sctx,
            "arg": slow.get("args", {}).get("arg"),
            "overlap_ms_by_category": {
                k: round(_union(v) / 1e3, 3)
                for k, v in sorted(overlap.items())},
            "waiting_ms_by_name": {
                k: round(_union(v) / 1e3, 3)
                for k, v in sorted(waiting.items())},
        }
    return out


def _union(intervals: list) -> float:
    """Total length of the union of [lo, hi) intervals."""
    total = 0.0
    cur_lo = cur_hi = None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        elif hi > cur_hi:
            cur_hi = hi
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


#: the process-wide recorder behind /api/v1/status/flight
RECORDER = FlightRecorder()


def slow_refresh_threshold_ms() -> float:
    """``VM_SLOW_REFRESH_MS``: refreshes slower than this trigger a
    flight capture on the serving path (0 disables the trigger; the
    default 1000ms only fires on genuinely pathological refreshes —
    bench.py lowers it adaptively around its measured baseline)."""
    try:
        return float(os.environ.get("VM_SLOW_REFRESH_MS", "1000"))
    except ValueError:
        return 1000.0


# -- gc visibility ------------------------------------------------------------

def _gc_hook(t0: float, dur: float, gen) -> None:
    # gc callbacks fire on whatever thread triggered the collection —
    # possibly INSIDE rec()'s slot stores, or inside a _rings_lock
    # critical section (ring creation / capture allocate).  Recording
    # would then tear the in-progress slot or self-deadlock taking the
    # non-reentrant lock from _new_ring, so: only record when this
    # thread already owns a ring and is not mid-record.  (A nested
    # collection can't fire inside THIS rec — gc suppresses reentrant
    # collections while callbacks run.)
    if not _ENABLED:
        return
    ring = getattr(_tls, "ring", None)
    if ring is None or ring.w == ring.i:
        return
    # ctx 0, not the thread's current query ctx: a gc pause is ambient
    # process work, and charging it to the query would hide it from the
    # capture summary's interference buckets (own-ctx work is excluded)
    prev = getattr(_tls, "ctx", 0)
    _tls.ctx = 0
    try:
        rec(f"gc:gen{gen}", t0, dur)
    finally:
        _tls.ctx = prev


def install_gc_events() -> None:
    """Record every gc collection as a flight span on the thread that
    triggered it (gc pauses are a serving-latency suspect).  Piggybacks
    on utils/metrics' single gc callback — the one timing of each
    collection feeds both vm_gc_pause_seconds_total and the timeline."""
    from . import metrics as metricslib
    if _gc_hook not in metricslib.gc_pause_hooks:
        metricslib.gc_pause_hooks.append(_gc_hook)


install_gc_events()
