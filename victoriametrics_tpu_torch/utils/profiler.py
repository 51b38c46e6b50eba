"""Continuous sampling profiler (the profile half of the cost-and-
profile observability plane; the reference ships pprof on every app —
this is the always-on Python analog: answer "where is the CPU going
right now" WITHOUT a pre-armed capture).

A single daemon thread samples ``sys._current_frames()`` at
``VM_PROFILE_HZ`` (default 10, deliberately low: one stack walk per
thread per 100ms is invisible next to a ~100ms refresh) and folds each
thread's stack into a bounded aggregate keyed by THREAD ROLE (pool
worker, http handler, merge, ...) — a role is the thread name with its
instance counter stripped, so 8 pool workers fold into one row.

Bounded memory by construction: at most ``VM_PROFILE_MAX_STACKS``
distinct folded stacks (default 5000; later novel stacks fold into a
per-role ``(other)`` bucket and count ``dropped``), stacks truncated at
``VM_PROFILE_MAX_DEPTH`` frames.  ``VM_PROFILE_HZ=0`` disables the
profiler entirely — no thread is ever created, every surface answers
"disabled".

Renderings:

- collapsed-stack text (``role;frame;frame count`` lines — the
  flamegraph.pl / speedscope-paste format)
- speedscope JSON (``"type": "sampled"`` profiles, one per role,
  loadable at https://www.speedscope.app)

both served at ``/api/v1/status/profile`` on vmsingle, vmselect AND
vmstorage; the vmselect endpoint additionally fans ``profile_v1`` out
to its storage nodes and merges the per-node snapshots with node tags
(the quarantineReport_v1 pattern), so one URL answers for the whole
cluster.

Self-metrics: ``vm_profiler_samples_total``,
``vm_profiler_sample_seconds_total`` (time spent inside the sampler —
the overhead, measurable), ``vm_profiler_stacks`` (live aggregate
size), ``vm_profiler_dropped_stacks_total``.

The port's copy of ``victoriametrics_tpu/utils/profiler.py``, whole.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

from . import metrics as metricslib

_SAMPLES_TOTAL = metricslib.REGISTRY.counter("vm_profiler_samples_total")
_SAMPLE_SECONDS = metricslib.REGISTRY.float_counter(
    "vm_profiler_sample_seconds_total")
_DROPPED_TOTAL = metricslib.REGISTRY.counter(
    "vm_profiler_dropped_stacks_total")


def configured_hz() -> float:
    """``VM_PROFILE_HZ`` (default 10; <=0 disables), re-read per call so
    tests and operators flip it without a restart."""
    try:
        return float(os.environ.get("VM_PROFILE_HZ", "10"))
    except ValueError:
        return 10.0


def _max_stacks() -> int:
    try:
        return max(int(os.environ.get("VM_PROFILE_MAX_STACKS", "5000")), 16)
    except ValueError:
        return 5000


def _max_depth() -> int:
    try:
        return max(int(os.environ.get("VM_PROFILE_MAX_DEPTH", "64")), 4)
    except ValueError:
        return 64


_THREAD_FN_RE = re.compile(r"^Thread-\d+\s+\((.+)\)$")
_TRAILING_NUM_RE = re.compile(r"[-_]\d+$")


def thread_role(name: str) -> str:
    """Fold a thread name into its role: strip per-instance counters so
    every pool worker / HTTP handler aggregates into one row."""
    m = _THREAD_FN_RE.match(name)
    if m:
        return m.group(1)
    return _TRAILING_NUM_RE.sub("", name) or "unnamed"


def _frame_label(code) -> str:
    fn = code.co_filename
    # keep the last two path segments: enough to disambiguate, short
    # enough for folded lines
    parts = fn.replace("\\", "/").rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) > 1 else fn
    return f"{short}:{code.co_name}"


class SampleProfiler:
    """Folded-stack aggregator + its sampling thread."""

    def __init__(self):
        self._lock = threading.Lock()
        # (role, stack_tuple) -> count; stack root->leaf
        self._stacks: dict[tuple, int] = {}
        self._samples = 0
        self._dropped = 0
        self._started_at = 0.0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def ensure_started(self) -> bool:
        """Start the sampling thread if ``VM_PROFILE_HZ`` > 0; returns
        whether the profiler is (now) running.  HZ<=0 NEVER creates a
        thread — the documented no-op contract."""
        if configured_hz() <= 0:
            return False
        with self._lock:
            if self.running():
                return True
            # rebound only here, under _lock; _run reads the ref once at
            # thread start — the Event handed to a dying thread is never
            # reused for the next one, so a stale read cannot unstop it
            self._stop = threading.Event()  # vmt: disable=VMT015
            if not self._started_at:
                self._started_at = time.monotonic()
            # service thread by design (daemon, joined in stop());
            # the work pool is for query work, not a periodic sampler
            self._thread = threading.Thread(  # vmt: disable=VMT011
                target=self._run, name="vm-profiler", daemon=True)
            self._thread.start()
            return True

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            self._stop.set()
            t.join(timeout=5)

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._samples = 0
            self._dropped = 0
            self._started_at = time.monotonic() if self.running() else 0.0

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            hz = configured_hz()
            if hz <= 0:  # flipped off live: park cheaply
                if self._stop.wait(0.5):
                    return
                continue
            t0 = time.perf_counter()
            try:
                self.take_sample(skip={me})
            except Exception as e:
                # the sampler must never die; one log line per failure,
                # no re-raise

                from . import logger
                logger.errorf("profiler sample failed: %s", e)
            dt = time.perf_counter() - t0
            _SAMPLE_SECONDS.inc(dt)
            if self._stop.wait(max(1.0 / hz - dt, 0.001)):
                return

    # -- sampling ----------------------------------------------------------

    def take_sample(self, skip: set | None = None) -> int:
        """One sampling pass over every live thread; returns the number
        of thread stacks folded in (exposed for tests and for one-shot
        sampling without the background thread)."""
        depth = _max_depth()
        names = {t.ident: t.name for t in threading.enumerate()}
        n = 0
        frames = sys._current_frames()
        for tid, frame in frames.items():
            if skip and tid in skip:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < depth:
                stack.append(_frame_label(f.f_code))
                f = f.f_back
            stack.reverse()  # root -> leaf (folded-stack convention)
            role = thread_role(names.get(tid, f"tid-{tid}"))
            self._ingest(role, tuple(stack))
            n += 1
        del frames
        _SAMPLES_TOTAL.inc()
        with self._lock:
            self._samples += 1
        return n

    def _ingest(self, role: str, stack: tuple) -> None:
        """Fold one (role, stack) observation in, bounded: novel stacks
        past the cap collapse into the role's ``(other)`` bucket."""
        key = (role, stack)
        with self._lock:
            c = self._stacks.get(key)
            if c is not None:
                self._stacks[key] = c + 1
                return
            if len(self._stacks) >= _max_stacks():
                key = (role, ("(other)",))
                self._dropped += 1
                _DROPPED_TOTAL.inc()
                # the overflow bucket itself may be the one new key a
                # full table still admits (one per role, bounded by the
                # role count, not by traffic)
            self._stacks[key] = self._stacks.get(key, 0) + 1

    # -- snapshots / renderings -------------------------------------------

    def snapshot(self, node: str | None = None, reset: bool = False) -> dict:
        """The merge/wire shape: meta + the folded-stack table.  `node`
        tags the snapshot for cluster merges."""
        hz = configured_hz()
        with self._lock:
            elapsed = (time.monotonic() - self._started_at
                       if self._started_at else 0.0)
            out = {
                "node": node,
                "configuredHz": hz,
                "samples": self._samples,
                "elapsedSeconds": round(elapsed, 3),
                "approxHz": round(self._samples / elapsed, 3)
                if elapsed > 0 else 0.0,
                "droppedStacks": self._dropped,
                "stacks": [{"role": r, "stack": list(st), "count": c}
                           for (r, st), c in self._stacks.items()],
            }
            if reset:
                self._stacks.clear()
                self._samples = 0
                self._dropped = 0
                self._started_at = (time.monotonic() if self.running()
                                    else 0.0)
        return out


#: process-wide profiler (one sampling thread per process)
PROFILER = SampleProfiler()

metricslib.REGISTRY.gauge("vm_profiler_stacks",
                          callback=lambda: len(PROFILER._stacks))


def ensure_started() -> bool:
    return PROFILER.ensure_started()


# -- multi-snapshot renderings (local + fanned-out node snapshots) -----------


def _tagged_rows(snapshots: list[dict]):
    """(group_label, stack, count) rows; group = role, prefixed with the
    node tag for tagged (fanned-out) snapshots."""
    for snap in snapshots:
        node = snap.get("node")
        for row in snap.get("stacks", ()):
            group = row["role"] if not node else f"{node}/{row['role']}"
            yield group, row["stack"], int(row["count"])


def collapsed(snapshots: list[dict]) -> str:
    """Folded-stack text: ``group;frame;frame count`` per line, counts
    merged across snapshots, heaviest stack first."""
    acc: dict[tuple, int] = {}
    for group, stack, count in _tagged_rows(snapshots):
        key = (group, tuple(stack))
        acc[key] = acc.get(key, 0) + count
    lines = [";".join((g,) + st) + f" {c}"
             for (g, st), c in sorted(acc.items(),
                                      key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines) + ("\n" if lines else "")


def speedscope(snapshots: list[dict], name: str = "vmtpu profile") -> dict:
    """speedscope file (https://www.speedscope.app/file-format-schema):
    one ``sampled`` profile per (node/)role, weights = sample counts."""
    frame_idx: dict[str, int] = {}
    frames: list[dict] = []

    def fidx(label: str) -> int:
        i = frame_idx.get(label)
        if i is None:
            i = frame_idx[label] = len(frames)
            frames.append({"name": label})
        return i

    groups: dict[str, tuple[list, list]] = {}
    for group, stack, count in _tagged_rows(snapshots):
        samples, weights = groups.setdefault(group, ([], []))
        samples.append([fidx(f) for f in stack])
        weights.append(count)
    profiles = []
    for group in sorted(groups):
        samples, weights = groups[group]
        total = sum(weights)
        profiles.append({"type": "sampled", "name": group, "unit": "none",
                         "startValue": 0, "endValue": total,
                         "samples": samples, "weights": weights})
    return {"$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "name": name,
            "activeProfileIndex": 0,
            "exporter": "victoriametrics_tpu/utils/profiler"}


def handle_http(req, Response, storage=None, local_node: str | None = None):
    """The shared ``/api/v1/status/profile`` handler (vmsingle/vmselect/
    vmstorage): 503 when disabled; ``?format=collapsed`` (default) /
    ``speedscope`` / ``raw``; ``?reset=1`` clears the aggregates after
    rendering.  With a `storage` exposing ``profile_report`` (the
    vmselect ClusterStorage) the local snapshot is merged with the
    per-node fan-out, node-tagged."""
    if configured_hz() <= 0:
        return Response.error(
            "continuous profiler disabled (VM_PROFILE_HZ=0)", 503,
            "unavailable")
    PROFILER.ensure_started()
    reset = req.arg("reset") == "1"
    snaps = [PROFILER.snapshot(node=local_node, reset=reset)]
    partial = False
    if storage is not None and \
            getattr(storage, "profile_report", None) is not None:
        try:
            if getattr(storage, "reset_partial", None) is not None:
                storage.reset_partial()
            # reset propagates through profile_v1 so ?reset=1 opens a
            # fresh window on every node, not only this process
            snaps.extend(storage.profile_report(reset=reset))
            partial = bool(getattr(storage, "last_partial", False))
        except Exception as e:  # noqa: BLE001 — degraded, never a 500
            from . import logger
            logger.errorf("profile fan-out failed: %s", e)
            partial = True
    fmt = req.arg("format") or "collapsed"
    if fmt == "speedscope":
        return Response.json(speedscope(snaps))
    if fmt == "raw":
        return Response.json({"status": "success",
                              "partial": partial,
                              "data": snaps})
    return Response.text(collapsed(snaps))
