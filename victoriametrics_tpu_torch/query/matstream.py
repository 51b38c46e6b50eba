"""Materialized query streams + subscription push (the cross-query
amortization plane).

Every distinct range expression registers here as ONE materialized
stream, keyed by its canonical expression text (the same canonical form
the rollup-result cache keys on).  One evaluator per stream advances the
expression's ring-cache entry O(new samples) per interval — regardless
of how many dashboards subscribe — and every subscriber receives the
suffix DELTA of the window instead of re-issuing ``query_range``:
storage reads per interval are O(distinct expressions), not
O(subscribers).

Frames (JSON dicts, also the SSE payloads of ``/api/v1/watch``):

- ``snapshot`` — the full current window, exactly the polled
  ``query_range`` result shape (``result`` entries of ``{"metric": ...,
  "values": [[t_seconds, value_string], ...]}`` with NaN points
  omitted).  Sent on (re)subscribe and whenever delta semantics cannot
  be guaranteed.
- ``delta`` — the window advanced: the client drops every stored point
  with ``t < startMs`` or ``t >= newStartMs`` and inserts the frame's
  points.  ``newStartMs`` is computed by DIFFING the fresh evaluation
  against the committed state, so replace-region semantics hold even
  when the volatile tail (OFFSET_MS) was recomputed — reassembled state
  is bit-equal to a poll by construction.
- ``error`` — the advance failed (deadline, shed load, ...); loud, and
  the next good frame is a resync snapshot.

Decline contract (mirrors the device-residency plane's): a
PARTIAL interval (storage node down mid-fan-out) is never committed —
subscribers get a partial-flagged snapshot, ``vm_matstream_declines_
total`` ticks, and the next clean advance resyncs.  Slow subscribers
are bounded: each subscription holds a small frame queue
(``VM_MATSTREAM_QUEUE``); overflow drops the backlog and enqueues one
resync snapshot (drop-and-resync, never unbounded memory).

No background threads: subscribers PUMP their stream cooperatively —
``next_frame`` advances the stream when its interval is due (first
caller wins the advance lock; everyone else gets the fanned frame), so
an idle stream costs nothing and the deterministic scheduler sees plain
lock/queue seams.

``VM_MATSTREAM=0`` disables the plane (``/api/v1/watch`` answers 503,
``subscribe`` raises, the vmalert shared-instant memo degrades to
per-rule evaluation) — the escape hatch AND the equality oracle: pushed
frames must reassemble bit-equal to the polled path.

The port's copy of ``victoriametrics_tpu/query/matstream.py``, whole.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time as _time
import weakref

import numpy as np

from ..devtools.locktrace import make_lock
from ..utils import costacc, fasttime, flightrec
from ..utils import metrics as metricslib
from .format_value import fmt_value

_instances: "weakref.WeakSet[MatStreamRegistry]" = weakref.WeakSet()

metricslib.REGISTRY.gauge(
    "vm_matstream_streams",
    callback=lambda: sum(r.stream_count() for r in list(_instances)))
metricslib.REGISTRY.gauge(
    "vm_matstream_subscribers",
    callback=lambda: sum(r.subscriber_count() for r in list(_instances)))
_FRAMES = metricslib.REGISTRY.counter("vm_matstream_frames_sent_total")
#: evaluations SAVED by sharing: (subscribers - 1) per fanned frame plus
#: every shared-instant memo hit (vmalert rules sharing one expression)
_REUSE = metricslib.REGISTRY.counter("vm_matstream_fanout_reuse_total")
_DECLINES = metricslib.REGISTRY.counter("vm_matstream_declines_total")
_DROPS = metricslib.REGISTRY.counter("vm_matstream_dropped_frames_total")
_EVALS = metricslib.REGISTRY.counter("vm_matstream_evals_total")
#: reconnect/resume accounting: a hit replays only the missed suffix
#: frames; a miss (unknown/too-old token) degrades LOUDLY to a full
#: resync snapshot
_RESUMES = metricslib.REGISTRY.counter("vm_matstream_resumes_total")
_RESUME_MISSES = metricslib.REGISTRY.counter(
    "vm_matstream_resume_misses_total")


def enabled() -> bool:
    return os.environ.get("VM_MATSTREAM", "1") != "0"


def queue_limit() -> int:
    try:
        return max(int(os.environ.get("VM_MATSTREAM_QUEUE", "8")), 1)
    except ValueError:
        return 8


def max_streams() -> int:
    try:
        return max(int(os.environ.get("VM_MATSTREAM_MAX", "256")), 1)
    except ValueError:
        return 256


class MatStreamDisabled(RuntimeError):
    pass


class MatStreamLimitError(RuntimeError):
    pass


class _State:
    """One committed evaluation of the stream's window."""

    __slots__ = ("start", "end", "step", "raws", "metas", "vals", "idx")

    def __init__(self, start, end, step, raws, metas, vals):
        self.start = start
        self.end = end
        self.step = step
        self.raws = raws            # list[bytes]
        self.metas = metas          # list[dict], parallel
        self.vals = vals            # (S, T) float64, owned copy
        self.idx = {r: s for s, r in enumerate(raws)}


def _series_entries(state: _State, from_ts: int) -> list[dict]:
    """``query_range``-shaped result entries for points >= from_ts (NaN
    omitted, series with no surviving points omitted) — the polled
    response serialization, bit for bit."""
    i0 = max(0, (from_ts - state.start + state.step - 1) // state.step)
    if from_ts <= state.start:
        i0 = 0
    grid = (np.arange(state.start + i0 * state.step, state.end + 1,
                      state.step, dtype=np.int64) / 1e3)
    out = []
    for s, meta in enumerate(state.metas):
        v = state.vals[s, i0:]
        pts = [[float(t), fmt_value(x)] for t, x in zip(grid, v)
               if not math.isnan(x)]
        if pts:
            out.append({"metric": meta, "values": pts})
    return out


def _diff_new_start(old: _State | None, new: _State) -> int:
    """First timestamp whose content differs between the committed state
    and the fresh evaluation — everything >= it goes into the delta
    frame (replace-region semantics).  Clamped so the fresh columns past
    the old coverage always count."""
    if old is None or old.step != new.step or \
            (new.start - old.start) % new.step != 0:
        return new.start
    step = new.step
    ov_lo = max(old.start, new.start)
    ov_hi = min(old.end, new.end)
    if ov_hi < ov_lo:
        return new.start
    fresh = min(ov_hi + step, old.end + step)
    o0 = (ov_lo - old.start) // step
    n0 = (ov_lo - new.start) // step
    T = (ov_hi - ov_lo) // step + 1
    changed = np.zeros(T, dtype=bool)
    common_o: list[int] = []
    common_n: list[int] = []
    for raw, nrow in new.idx.items():
        orow = old.idx.get(raw)
        if orow is None:
            # appeared: every non-NaN point of the new row is a change
            changed |= ~np.isnan(new.vals[nrow, n0:n0 + T])
        else:
            common_o.append(orow)
            common_n.append(nrow)
    for raw, orow in old.idx.items():
        if raw not in new.idx:
            # vanished: every point the old row HAD must be dropped
            changed |= ~np.isnan(old.vals[orow, o0:o0 + T])
    if common_o:
        a = old.vals[np.asarray(common_o)][:, o0:o0 + T]
        b = new.vals[np.asarray(common_n)][:, n0:n0 + T]
        neq = ~((a == b) | (np.isnan(a) & np.isnan(b)))
        changed |= neq.any(axis=0)
    nz = np.flatnonzero(changed)
    first = ov_lo + int(nz[0]) * step if nz.size else fresh
    return min(first, fresh)


class Subscription:
    """One subscriber's bounded frame queue.  ``next_frame`` is the only
    consumer API; producers run under the stream lock."""

    def __init__(self, stream: "MatStream"):
        self.stream = stream
        self.q: "queue.Queue[dict]" = queue.Queue(maxsize=queue_limit())
        #: next frame must be a full snapshot (cold subscribe, overflow
        #: resync, after an error/partial decline).  Written only under
        #: stream._lock.
        self.need_snapshot = True
        self.dropped = 0
        self.closed = False

    def next_frame(self, timeout_s: float = 30.0,
                   now_ms: int | None = None) -> dict | None:
        """Pop the next frame, cooperatively advancing the stream when
        its interval is due.  ``None`` on timeout (caller heartbeats) or
        when closed.  Tests pass a pinned ``now_ms`` for determinism;
        live callers leave it None (wall clock, re-read per wait)."""
        deadline = _time.monotonic() + max(timeout_s, 0.0)
        while True:
            try:
                return self.q.get_nowait()
            except queue.Empty:
                pass
            if self.closed:
                return None
            now = now_ms if now_ms is not None else fasttime.unix_ms()
            if self.stream.maybe_advance(now):
                continue
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return None
            # wake early enough to pump the next interval on time
            wait = min(remaining, max(self.stream.step / 4e3, 0.05), 1.0)
            try:
                return self.q.get(timeout=wait)
            except queue.Empty:
                continue

    def close(self) -> None:
        self.stream._unsubscribe(self)


_EPOCH_COUNTER = __import__("itertools").count(1)


class MatStream:
    """One materialized expression: canonical query text + (step,
    window, tenant), its committed window state, and its subscribers."""

    def __init__(self, registry: "MatStreamRegistry", q: str, step: int,
                 duration: int, tenant: tuple):
        self.registry = registry
        self.q = q                  # canonical expression text
        self.step = step
        self.duration = duration
        self.tenant = tenant
        self._lock = make_lock("query.MatStream._lock")
        self._advance_lock = make_lock("query.MatStream._advance_lock")
        self._state: _State | None = None
        self._subs: list[Subscription] = []
        #: resume-token namespace: a token from another stream
        #: incarnation (evicted + re-created, process restart) must
        #: never replay against this one's seq space
        self.epoch = f"{fasttime.unix_ms():x}.{next(_EPOCH_COUNTER):x}"
        #: the last few fanned frames, (seq, frame), for reconnect
        #: resume (bounded by VM_MATSTREAM_QUEUE like subscriber queues)
        self._recent: list[tuple[int, dict]] = []
        #: instant-share verdict (see MatStreamRegistry.instant_vector):
        #: None = unvalidated, True = the committed tail column is
        #: bit-equal to a legacy instant eval at the same ts, False =
        #: proven divergent for this expression/step — never share.
        #: A True verdict is REVALIDATED every Nth share (the Nth call
        #: pays the legacy eval and re-compares), bounding how long a
        #: workload change — e.g. late-arriving samples inside the
        #: window — could serve diverging shares
        self.instant_share: bool | None = None
        self._share_hits = 0
        self.seq = 0
        self.evals = 0
        self.declines = 0
        self.frames_sent = 0
        self.last_samples_scanned = 0
        self.last_error = ""
        self._cost_totals: dict = {}
        self.created_at = fasttime.unix_seconds()

    # -- subscriber management (under self._lock) -------------------------

    def subscribe(self, resume: str | None = None) -> Subscription:
        """``resume`` is a token from a previous subscription's frames
        (``Last-Event-ID``/``resume=``): when it names THIS stream
        incarnation and every frame after it is still retained, the
        subscriber receives only the missed suffix frames; anything
        else — foreign epoch, too-old seq, malformed — degrades loudly
        to a full resync snapshot (vm_matstream_resume_misses_total)."""
        sub = Subscription(self)
        with self._lock:
            self._subs.append(sub)
            if resume:
                if self._try_resume(sub, resume):
                    _RESUMES.inc()
                    return sub
                _RESUME_MISSES.inc()
                flightrec.instant("matstream:resume_miss",
                                  arg=self.q[:120])
                if self._state is not None:
                    self._offer(sub, None,
                                [self._snapshot_frame(resync=True)])
                    sub.need_snapshot = False
                return sub
            if self._state is not None:
                # cold subscribe replays the CURRENT window from the
                # committed state — no evaluation, no storage read
                self._offer(sub, None, [self._snapshot_frame()])
                sub.need_snapshot = False
        return sub

    def _try_resume(self, sub: Subscription, token: str) -> bool:
        """Replay the missed suffix frames for a valid token (under
        self._lock).  Valid = same epoch AND every seq in (token_seq,
        self.seq] still retained — the client's reassembled state at
        token_seq is then a correct base for the retained deltas."""
        epoch, _, seq_s = token.rpartition(":")
        if epoch != self.epoch or not seq_s.isdigit():
            return False
        seq = int(seq_s)
        if seq > self.seq:
            return False
        # a token naming a PARTIAL snapshot frame means the client's
        # window holds the uncommitted partial values (the one fanned
        # frame that mutates client state away from the committed
        # line) — deltas diffed against the committed state would
        # leave its prefix silently divergent, so resync instead
        at = next((f for s, f in self._recent if s == seq), None)
        if at is not None and at.get("partial"):
            return False
        if seq == self.seq:
            sub.need_snapshot = False  # nothing missed: deltas continue
            return True
        missed = [f for s, f in self._recent if s > seq]
        if len(missed) != self.seq - seq:
            return False  # gap: retained ring no longer covers the token
        if any(f.get("type") != "delta" for f in missed):
            # the missed suffix crosses a decline (error frame or
            # partial snapshot): live subscribers were resynced with a
            # FRESH snapshot after it, but the retained ring holds the
            # raw delta that was diffed against the COMMITTED state —
            # replaying it onto a client that applied the partial
            # values would leave a silently divergent prefix.  Degrade
            # to the snapshot+resync path instead.
            return False
        sub.need_snapshot = False
        self._offer(sub, self._snapshot_frame, missed)
        return True

    def resume_token(self, frame: dict) -> str:
        """The SSE event id for one frame of this stream."""
        with self._lock:
            return f"{self.epoch}:{frame.get('seq', self.seq)}"

    def _unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            sub.closed = True
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    def _snapshot_frame(self, partial: bool = False,
                        resync: bool = False) -> dict:
        st = self._state
        f = {"type": "snapshot", "seq": self.seq, "query": self.q,
             "startMs": st.start, "endMs": st.end, "stepMs": st.step,
             "result": _series_entries(st, st.start)}
        if partial:
            f["partial"] = True
        if resync:
            f["resync"] = True
        return f

    def _offer(self, sub: Subscription, snapshot_fn, frames: list[dict]):
        """Enqueue frames for one subscriber; bounded queue overflow
        drops the backlog and resyncs with one snapshot."""
        for f in frames:
            if sub.need_snapshot and f.get("type") == "delta":
                if snapshot_fn is None:
                    continue
                f = snapshot_fn()
                sub.need_snapshot = False
            try:
                sub.q.put_nowait(f)
                self.frames_sent += 1
                _FRAMES.inc()
            except queue.Full:
                # drop-and-resync: clear the backlog, then enqueue ONE
                # resync snapshot (the queue is empty now, so this
                # cannot overflow) — a slow subscriber catches up from
                # the current window instead of replaying stale deltas
                n = 0
                while True:
                    try:
                        sub.q.get_nowait()
                        n += 1
                    except queue.Empty:
                        break
                sub.dropped += n + 1
                _DROPS.inc(n + 1)
                sub.need_snapshot = True
                flightrec.instant("matstream:drop", arg=self.q[:120])
                if snapshot_fn is not None:
                    try:
                        sub.q.put_nowait(self._mark_resync(snapshot_fn()))
                        sub.need_snapshot = False
                        self.frames_sent += 1
                        _FRAMES.inc()
                    except queue.Full:  # pragma: no cover — just drained
                        pass

    @staticmethod
    def _mark_resync(frame: dict) -> dict:
        f = dict(frame)
        f["resync"] = True
        return f

    def _fanout(self, frames: list[dict], snapshot_fn, resync_all: bool):
        # retain for reconnect resume BEFORE fanning (a subscriber that
        # drops mid-fan can resume into the frame it just missed)
        for f in frames:
            self._recent.append((self.seq, f))
        del self._recent[:-queue_limit()]
        subs = self._subs
        for sub in subs:
            if resync_all:
                sub.need_snapshot = True
            self._offer(sub, snapshot_fn, frames)
        if len(subs) > 1 and frames:
            _REUSE.inc(len(subs) - 1)

    # -- the evaluator -----------------------------------------------------

    def due(self, now_ms: int) -> bool:
        end = (now_ms // self.step) * self.step
        # racy-by-design fast path: _state is only rebound while BOTH
        # _advance_lock and _lock are held, and maybe_advance re-checks
        # due() after taking _advance_lock — a stale ref here costs one
        # redundant check, never a double advance
        st = self._state  # vmt: disable=VMT015
        return st is None or end > st.end

    def maybe_advance(self, now_ms: int) -> bool:
        """Advance to the interval `now_ms` falls in, if due and nobody
        else is already evaluating.  Returns True when THIS call
        advanced (frames were fanned out)."""
        if not self.due(now_ms):
            return False
        if not self._advance_lock.acquire(False):
            return False
        try:
            if not self.due(now_ms):
                return False
            self._advance(now_ms)
            return True
        finally:
            self._advance_lock.release()

    def _advance(self, now_ms: int) -> None:
        """One shared evaluation -> one frame -> every subscriber.
        Runs under _advance_lock."""
        end = (now_ms // self.step) * self.step
        start = end - self.duration
        api = self.registry.api
        # fleet prepass: ONE fused mesh launch serves every due
        # device-resident stream this interval; the eval below then hits
        # the fleet's result table instead of launching its own kernel.
        # The first due stream of the interval pays the (single) launch
        # for the whole fleet; the rest find fresh results and no-op.
        from . import fleet as _fleet
        _fleet.prepass(api, now_ms)
        t0 = _time.perf_counter()
        ec = api._ec(start, end, self.step, self.tenant)
        if hasattr(api.storage, "reset_partial"):
            api.storage.reset_partial()
        err: Exception | None = None
        rows: list = []
        try:
            with api.gate:
                rows = api._exec_range_cached(ec, self.q, now_ms)
        except Exception as e:  # noqa: BLE001 — fanned as an error frame
            err = e
        _EVALS.inc()
        partial = bool(getattr(api.storage, "last_partial", False))
        dur = _time.perf_counter() - t0
        flightrec.rec("matstream:advance", t0, dur, arg=self.q[:200])
        summary = ec._cost.summary()
        costacc.record_usage(self.tenant, ec._cost, summary=summary)
        with self._lock:
            self._fold_cost(summary)
            # stats land under _lock so usage_row's locked reads never
            # tear against the advance (the advance itself is already
            # serialized by _advance_lock)
            self.evals += 1
            self.last_samples_scanned = ec.samples_scanned
            self.seq += 1
            if err is not None:
                # loud: the failure reaches every subscriber, and the
                # next good advance resyncs from a snapshot
                self.last_error = str(err)
                self.declines += 1
                _DECLINES.inc()
                flightrec.instant("matstream:decline", arg=str(err)[:120])
                self._fanout([{"type": "error", "seq": self.seq,
                               "query": self.q, "error": str(err)}],
                             None, resync_all=True)
                return
            self.last_error = ""
            new_state = self._build_state(ec, rows)
            if partial:
                # decline: never commit a partial interval — serve it
                # loudly as a partial snapshot and resync when clean
                # (the device-residency plane's rebuild-path contract)
                self.declines += 1
                _DECLINES.inc()
                flightrec.instant("matstream:decline", arg="partial")
                prev, self._state = self._state, new_state
                frame = self._snapshot_frame(partial=True)
                self._state = prev
                self._fanout([frame], None, resync_all=True)
                return
            old = self._state
            self._state = new_state
            new_start = _diff_new_start(old, new_state)
            frame = {"type": "delta", "seq": self.seq, "query": self.q,
                     "startMs": new_state.start, "endMs": new_state.end,
                     "stepMs": new_state.step, "newStartMs": new_start,
                     "result": _series_entries(new_state, new_start)}
            self._fanout([frame], self._snapshot_frame,
                         resync_all=False)

    def _build_state(self, ec, rows) -> _State:
        T = ec.n_points
        raws, metas = [], []
        vals = np.full((len(rows), T), np.nan)
        for s, r in enumerate(rows):
            raws.append(r.raw if r.raw is not None
                        else r.metric_name.marshal())
            metas.append(r.metric_name.to_dict())
            v = r.values
            # rows from the cached executor are window-exact; be
            # defensive about short rows anyway (suffix producers)
            vals[s, T - min(v.size, T):] = v[-T:]
        return _State(ec.start, ec.end, ec.step, raws, metas, vals)

    def _fold_cost(self, summary: dict) -> None:
        t = self._cost_totals
        for k in ("samplesScanned", "bytesRead", "cpuMs", "deviceBytes",
                  "rpcBytes"):
            t[k] = t.get(k, 0) + summary.get(k, 0)
        # this stream's rows-share of the fused fleet launch (query.fleet
        # laps the split into the eval's tracker on take()): the shares
        # across streams sum to the launch totals, so usage rows stay an
        # exact decomposition of device wall time
        by = summary.get("wallMsByPhase") or {}
        for row, phase in (("deviceExecMs", "device:execute"),
                           ("deviceUploadMs", "device:upload")):
            t[row] = round(t.get(row, 0) + by.get(phase, 0.0), 3)

    # -- introspection -----------------------------------------------------

    def instant_rows_from_state(self, ts_ms: int) -> list[dict] | None:
        """Datasource-shaped rows derived from the committed window's
        LAST column — the shared-instant candidate for rule groups
        evaluating this stream's expression at exactly the committed
        end (None otherwise).  Value formatting mirrors instant_vector
        (float(fmt_value(v))), so a validated share is bit-equal to the
        legacy poll path."""
        with self._lock:
            st = self._state
            if st is None or st.end != ts_ms:
                return None
            out = []
            for s, meta in enumerate(st.metas):
                v = st.vals[s, -1]
                if math.isnan(v):
                    continue
                out.append({"metric": meta, "value": float(fmt_value(v)),
                            "ts": ts_ms / 1e3})
            return out

    def usage_row(self) -> dict:
        with self._lock:
            row = {"query": self.q, "tenant": f"{self.tenant[0]}:"
                   f"{self.tenant[1]}", "stepMs": self.step,
                   "windowMs": self.duration,
                   "subscribers": len(self._subs), "evals": self.evals,
                   "framesSent": self.frames_sent,
                   "declines": self.declines,
                   "lastSamplesScanned": self.last_samples_scanned}
            row.update({k: (round(v, 3) if isinstance(v, float) else v)
                        for k, v in self._cost_totals.items()})
            if self.last_error:
                row["lastError"] = self.last_error
            return row

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)


class MatStreamRegistry:
    """Per-serving-instance stream table + the shared-instant memo the
    colocated vmalert rule engine routes through."""

    _INSTANT_MEMO_MAX = 512
    #: every Nth validated share re-runs the legacy eval and
    #: re-compares (see MatStream.instant_share)
    _SHARE_REVALIDATE_N = 16

    def __init__(self, api):
        # the owning PrometheusAPI (cached range executor + gate + _ec);
        # plain backref — the API owns the registry for its lifetime
        self.api = api
        self._lock = make_lock("query.MatStreamRegistry._lock")
        self._streams: dict[tuple, MatStream] = {}
        from collections import OrderedDict
        self._instant_memo: "OrderedDict[tuple, list]" = OrderedDict()
        self.instant_evals = 0
        self.instant_reuse = 0
        _instances.add(self)

    # -- range streams -----------------------------------------------------

    def canonical(self, q: str) -> str:
        """Canonical expression text — the stream identity AND the text
        handed to the cached executor, so spelling variants of one
        expression share a single stream and ring-cache entry."""
        from .exec import parse_cached
        return str(parse_cached(q))

    def subscribe(self, q: str, step: int, duration: int,
                  tenant: tuple = (0, 0),
                  resume: str | None = None) -> Subscription:
        if not enabled():
            raise MatStreamDisabled(
                "materialized streams disabled (VM_MATSTREAM=0)")
        canonical = self.canonical(q)
        if step <= 0:
            raise ValueError("step must be positive")
        duration = max(-(-int(duration) // step) * step, step)
        key = (tenant, canonical, step, duration)
        with self._lock:
            st = self._streams.get(key)
            if st is None:
                if len(self._streams) >= max_streams():
                    self._evict_locked()
                if len(self._streams) >= max_streams():
                    raise MatStreamLimitError(
                        f"too many materialized streams "
                        f"({max_streams()}); raise VM_MATSTREAM_MAX or "
                        f"unsubscribe idle watchers")
                st = MatStream(self, canonical, step, duration, tenant)
                self._streams[key] = st
            # subscribe WHILE holding the registry lock (registry ->
            # stream lock order, nested nowhere else): releasing first
            # would let a concurrent at-capacity subscribe evict this
            # still-subscriber-less stream and orphan the subscription
            # (two live streams for one key = duplicate evaluations)
            return st.subscribe(resume=resume)

    def _evict_locked(self) -> None:
        """Drop the oldest subscriber-less stream (its warm state is
        re-creatable from the ring cache)."""
        for key, st in list(self._streams.items()):
            if st.subscriber_count() == 0:
                del self._streams[key]
                return

    def advance_due(self, now_ms: int | None = None) -> int:
        """Advance every due stream once (bench/test caller; HTTP
        subscribers normally pump their own streams).  Returns how many
        streams advanced."""
        now = now_ms if now_ms is not None else fasttime.unix_ms()
        n = 0
        for st in self.streams():
            if st.maybe_advance(now):
                n += 1
        return n

    def streams(self) -> list[MatStream]:
        with self._lock:
            return list(self._streams.values())

    def stream_count(self) -> int:
        with self._lock:
            return len(self._streams)

    def subscriber_count(self) -> int:
        return sum(s.subscriber_count() for s in self.streams())

    def usage_rows(self) -> list[dict]:
        rows = [s.usage_row() for s in self.streams()]
        rows.sort(key=lambda r: -r.get("cpuMs", 0))
        return rows

    def instant_stats(self) -> dict:
        with self._lock:
            return {"evals": self.instant_evals,
                    "reuse": self.instant_reuse}

    # -- shared instant evaluation (vmalert rule groups) -------------------

    def _instant_candidate(self, tenant, canonical, ts_ms):
        """A RANGE stream over the same (tenant, expression) whose
        committed window ends exactly at ts_ms — its tail column is the
        shared-instant candidate (None, None when no stream/state
        lines up or sharing is proven divergent)."""
        with self._lock:
            streams = [st for k, st in self._streams.items()
                       if k[0] == tenant and k[1] == canonical]
        for st in streams:
            if st.instant_share is False:
                continue
            rows = st.instant_rows_from_state(ts_ms)
            if rows is not None:
                return st, rows
        return None, None

    def instant_vector(self, q: str, ts_ms: int,
                       tenant: tuple = (0, 0)) -> list[dict]:
        """One instant evaluation per distinct (expression, timestamp),
        fanned to every caller — recording/alerting rules sharing a
        selector pay one fetch+rollup.  Returns datasource-shaped rows
        (``{"metric", "value", "ts"}``), identical to the legacy HTTP
        poll path by construction (same executor, same value
        formatting).  With VM_MATSTREAM=0 the memo is bypassed: every
        caller evaluates itself (the legacy behavior, the oracle).

        Rule groups and RANGE streams over ONE expression also share:
        when a stream's committed window ends exactly at ts_ms, its
        tail column serves the instant — after a one-time
        validate-then-trust check (the first such call still runs the
        legacy eval and compares bit-for-bit; a divergent expression —
        e.g. one whose default rollup window depends on the grid step —
        pins ``instant_share=False`` and never shares again).  A
        validated hit costs zero evaluations and zero storage reads."""
        share = enabled()
        canonical = self.canonical(q)
        key = (tenant, canonical, ts_ms)
        cand_stream = cand_rows = None
        if share:
            with self._lock:
                hit = self._instant_memo.get(key)
                if hit is not None:
                    self._instant_memo.move_to_end(key)
                    self.instant_reuse += 1
                    _REUSE.inc()
                    return hit
            cand_stream, cand_rows = self._instant_candidate(
                tenant, canonical, ts_ms)
            if cand_stream is not None and cand_stream.instant_share:
                cand_stream._share_hits += 1
                if cand_stream._share_hits % self._SHARE_REVALIDATE_N:
                    _REUSE.inc()
                    flightrec.instant("matstream:instant_share",
                                      arg=canonical[:120])
                    with self._lock:
                        self.instant_reuse += 1
                        self._instant_memo[key] = cand_rows
                        while len(self._instant_memo) > \
                                self._INSTANT_MEMO_MAX:
                            self._instant_memo.popitem(last=False)
                    return cand_rows
                # every Nth share falls through to the legacy eval and
                # re-compares below — a workload change (late samples
                # inside the window) is caught within N shares
                cand_stream.instant_share = None
        from .exec import exec_query
        api = self.api
        ec = api._ec(ts_ms, ts_ms, 300_000, tenant)
        if hasattr(api.storage, "reset_partial"):
            api.storage.reset_partial()
        t0 = _time.perf_counter()
        with api.gate:
            rows = exec_query(ec, canonical)
        flightrec.rec("matstream:instant", t0,
                      _time.perf_counter() - t0, arg=canonical[:200])
        with self._lock:
            # under _lock like the instant_reuse increments above: the
            # memo is shared by every instant caller (HTTP, rule groups,
            # the SLO pump), so the miss counter races without it
            self.instant_evals += 1
        _EVALS.inc()
        costacc.record_usage(tenant, ec._cost)
        out = []
        for r in rows:
            v = r.values[-1]
            if math.isnan(v):
                continue
            # float(fmt_value(v)) mirrors the HTTP responder exactly:
            # the legacy datasource parses the formatted string
            out.append({"metric": r.metric_name.to_dict(),
                        "value": float(fmt_value(v)), "ts": ts_ms / 1e3})
        if cand_stream is not None and cand_stream.instant_share is None:
            # validate-then-trust: this legacy eval ran anyway — record
            # whether the stream's tail column matches it bit-for-bit
            # (order-insensitive: rules treat the result as a vector)
            import json as _json

            def _k(rows):
                return sorted(_json.dumps(r, sort_keys=True)
                              for r in rows)
            cand_stream.instant_share = _k(cand_rows) == _k(out)
        if share:
            with self._lock:
                self._instant_memo[key] = out
                while len(self._instant_memo) > self._INSTANT_MEMO_MAX:
                    self._instant_memo.popitem(last=False)
        return out


_ENC_LOCK = make_lock("query.matstream._ENC_LOCK")
_ENC_RING: list = []          # [(frame dict, encoded bytes)] newest last
_ENC_RING_MAX = 16


def encode_frame(frame: dict) -> bytes:
    """JSON-encode one frame ONCE process-wide: frames are shared dicts
    fanned to every subscriber, so N watchers of one stream must not
    pay N serializations of the same (possibly window-sized) payload.
    Identity-keyed ring memo, bounded to the last few frames (streams
    produce one frame per interval; anything older has been sent)."""
    import json as _json
    with _ENC_LOCK:
        for fr, b in _ENC_RING:
            if fr is frame:
                return b
    b = _json.dumps(frame).encode()
    with _ENC_LOCK:
        _ENC_RING.append((frame, b))
        while len(_ENC_RING) > _ENC_RING_MAX:
            _ENC_RING.pop(0)
    return b


class StreamClient:
    """Client-side frame reassembly (tests + tools/watch.sh): applies
    snapshot/delta frames and yields the polled ``query_range`` result
    shape — the bit-equality oracle's comparator."""

    def __init__(self):
        self._series: dict[str, dict] = {}   # key -> {"metric", pts}
        self.window: tuple | None = None
        self.partial = False
        self.errors: list[str] = []

    @staticmethod
    def _key(metric: dict) -> str:
        import json as _json
        return _json.dumps(metric, sort_keys=True)

    def apply(self, frame: dict) -> None:
        t = frame.get("type")
        if t == "error":
            self.errors.append(frame.get("error", ""))
            return
        if t == "snapshot":
            self._series = {}
            for ent in frame["result"]:
                self._series[self._key(ent["metric"])] = {
                    "metric": ent["metric"],
                    "pts": {p[0]: p[1] for p in ent["values"]}}
            self.window = (frame["startMs"], frame["endMs"],
                           frame["stepMs"])
            self.partial = bool(frame.get("partial"))
            return
        if t != "delta":
            raise ValueError(f"unknown frame type {t!r}")
        start_s = frame["startMs"] / 1e3
        ns_s = frame["newStartMs"] / 1e3
        for ent in self._series.values():
            ent["pts"] = {ts: v for ts, v in ent["pts"].items()
                          if start_s <= ts < ns_s}
        for ent in frame["result"]:
            k = self._key(ent["metric"])
            cur = self._series.get(k)
            if cur is None:
                cur = self._series[k] = {"metric": ent["metric"],
                                         "pts": {}}
            for ts, v in ent["values"]:
                cur["pts"][ts] = v
        self._series = {k: e for k, e in self._series.items() if e["pts"]}
        self.window = (frame["startMs"], frame["endMs"], frame["stepMs"])
        self.partial = False

    def result(self) -> list[dict]:
        out = []
        for k in sorted(self._series):
            e = self._series[k]
            out.append({"metric": e["metric"],
                        "values": [[ts, e["pts"][ts]]
                                   for ts in sorted(e["pts"])]})
        return out
