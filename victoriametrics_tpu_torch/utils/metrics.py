"""Process-wide self-metrics registry (reference
vendor/github.com/VictoriaMetrics/metrics: Counter/FloatCounter/Gauge +
the vmrange Histogram of histogram.go, and WritePrometheus exposition).

Metrics are keyed by their FULL name including labels, exactly like the
reference library::

    REGISTRY.counter('vm_rpc_calls_total{method="search_v1"}').inc()
    REGISTRY.histogram('vm_request_duration_seconds{path="/api/v1/query"}')\
        .update(dt)

Histograms reuse the storage engine's own vmrange bucketing
(query/vmhistogram.py), so self-metrics use the same exposition the data
plane stores: ``<name>_bucket{...,vmrange="l...u"}``, ``<name>_sum``,
``<name>_count``.  ``write_prometheus()`` renders the whole registry as
parseable Prometheus text (``# TYPE`` lines, escaped label values) plus
``process_*`` gauges (RSS, open fds, threads, CPU, uptime).

One process = one registry (``REGISTRY``); tests may build private
``MetricsRegistry`` instances.

The port's copy of ``victoriametrics_tpu/utils/metrics.py`` (whole), with
two readers the port's device engine and ``chip_smoke.py`` use:
``Histogram.buckets()`` and ``MetricsRegistry.snapshot()``.  It keeps the
JAX package's metric names (``vm_device_bytes_{uploaded,downloaded}_total``,
``vm_tpu_kernel_duration_seconds{kernel,phase}``, ``vm_device_window_*``,
``vm_cache_*{type="tpu/tile_cache"}``) so dashboards read both engines the
same way.
"""

from __future__ import annotations

import os
import re
import threading

from ..query import vmhistogram
from . import fasttime

_NAME_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:.]*(\{([a-zA-Z_][a-zA-Z0-9_]*="'
    r'([^"\\]|\\.)*",?)*\})?$')

_started_at = fasttime.unix_seconds()


def uptime_seconds() -> float:
    """Seconds since this process's registry was imported (the
    vm_app_uptime_seconds / health-report clock)."""
    return fasttime.unix_seconds() - _started_at


# -- name formatting ---------------------------------------------------------

def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash, quote, LF)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def format_name(base: str, labels: dict | None = None) -> str:
    """``format_name("m", {"a": "b"})`` -> ``m{a="b"}`` with values
    escaped; labels render in insertion order (callers pass stable dicts
    so identical series always produce the identical registry key)."""
    if not labels:
        return base
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return f"{base}{{{inner}}}"


def split_name(full: str) -> tuple[str, str]:
    """``m{a="b"}`` -> ``("m", 'a="b"')``; ``m`` -> ``("m", "")``."""
    i = full.find("{")
    if i < 0:
        return full, ""
    return full[:i], full[i + 1:full.rindex("}")]


def _join_labels(*parts: str) -> str:
    inner = ",".join(p for p in parts if p)
    return f"{{{inner}}}" if inner else ""


# -- metric kinds ------------------------------------------------------------

class Counter:
    """Monotonic integer counter."""

    type_name = "counter"
    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def get(self) -> int:
        with self._lock:
            return self._v

    def set(self, v: int) -> None:
        with self._lock:
            self._v = v

    def _samples(self):
        yield self.name, _fmt_number(self.get())


class FloatCounter(Counter):
    """Monotonic float counter (e.g. accumulated seconds)."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name)
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n


class Gauge:
    """Instantaneous value: either callback-driven (read at exposition
    time) or set()/inc()/dec()-driven."""

    type_name = "gauge"
    __slots__ = ("name", "callback", "_lock", "_v")

    def __init__(self, name: str, callback=None):
        self.name = name
        self.callback = callback
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._v -= n

    def get(self) -> float:
        if self.callback is not None:
            try:
                return float(self.callback())
            except Exception:  # noqa: BLE001 — exposition must never fail
                return float("nan")
        with self._lock:
            return self._v

    def _samples(self):
        yield self.name, _fmt_number(self.get())


class Histogram:
    """VictoriaMetrics-native histogram: log-spaced vmrange buckets
    (18/decade, query/vmhistogram.py) storing only non-empty buckets,
    plus _sum and _count series.  NaN and negative values are skipped,
    matching the reference (histogram.go:85)."""

    type_name = "histogram"
    __slots__ = ("name", "_lock", "_buckets", "_sum", "_count")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._buckets: dict[str, int] = {}
        self._sum = 0.0
        self._count = 0

    def update(self, v: float) -> None:
        r = vmhistogram.vmrange_for(float(v))
        if r is None:
            return
        with self._lock:
            self._buckets[r] = self._buckets.get(r, 0) + 1
            self._sum += v
            self._count += 1

    def update_duration(self, start_monotonic: float) -> None:
        import time
        self.update(time.perf_counter() - start_monotonic)

    def buckets(self) -> dict[str, int]:
        """{vmrange label: observations} of the non-empty buckets."""
        with self._lock:
            return dict(self._buckets)

    def get_count(self) -> int:
        with self._lock:
            return self._count

    def get_sum(self) -> float:
        with self._lock:
            return self._sum

    def _samples(self):
        base, labels = split_name(self.name)
        with self._lock:
            buckets = sorted(self._buckets.items())
            total, cnt = self._sum, self._count
        if not cnt:
            return
        for rng, n in buckets:
            yield (f"{base}_bucket"
                   + _join_labels(labels, f'vmrange="{rng}"'), str(n))
        yield f"{base}_sum" + _join_labels(labels), _fmt_number(total)
        yield f"{base}_count" + _join_labels(labels), str(cnt)


def _fmt_number(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


# -- registry ----------------------------------------------------------------

class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: list = []

    def _get_or_create(self, name: str, cls, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def float_counter(self, name: str) -> FloatCounter:
        return self._get_or_create(name, FloatCounter)

    def gauge(self, name: str, callback=None) -> Gauge:
        g = self._get_or_create(name, Gauge, callback=callback)
        if callback is not None and g.callback is None:
            g.callback = callback
        return g

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def register_collector(self, fn) -> None:
        """fn() -> dict of full-name -> value, rendered untyped at
        exposition time (the bridge for legacy ``.metrics()`` dicts)."""
        with self._lock:
            self._collectors.append(fn)

    def _collect(self, extra: dict | None = None,
                 include_process: bool = True):
        """The one collection pass both exposition AND the self-scrape
        plane share: yields ``(family, type, name, value_str)`` for
        every sample — registered metrics, ``register_collector``
        collectors, a one-shot ``extra`` dict, process_* gauges."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            fam = split_name(m.name)[0]
            for name, value in m._samples():
                yield fam, m.type_name, name, value
        merged: dict[str, object] = {}
        for fn in collectors:
            try:
                merged.update(fn())
            except Exception:  # noqa: BLE001 — exposition must never fail
                continue
        if extra:
            merged.update(extra)
        for name, value in merged.items():
            fam = split_name(name)[0]
            kind = "counter" if fam.endswith("_total") else "gauge"
            yield fam, kind, name, _fmt_number(value)
        if include_process:
            for name, value in _process_metrics():
                fam = split_name(name)[0]
                kind = "counter" if fam.endswith("_total") else "gauge"
                yield fam, kind, name, _fmt_number(value)

    def collect_values(self, extra: dict | None = None,
                       include_process: bool = True
                       ) -> list[tuple[str, float]]:
        """Structured snapshot for the self-scrape plane:
        ``[(full_sample_name, float_value), ...]`` from the same
        collection pass ``write_prometheus`` renders — NOT a text
        round-trip.  Unparseable collector values are skipped (the
        text path would have rendered them verbatim; the ingest path
        needs numbers)."""
        out = []
        for _fam, _kind, name, value in self._collect(
                extra, include_process):
            try:
                out.append((name, float(value)))
            except (TypeError, ValueError):
                continue
        return out

    def snapshot(self) -> dict[str, float]:
        """{name: value} for counters and gauges; histograms contribute
        ``<name>_sum`` and ``<name>_count``."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, float] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                base, brace, labels = name.partition("{")
                out[f"{base}_sum{brace}{labels}"] = m.get_sum()
                out[f"{base}_count{brace}{labels}"] = m.get_count()
            else:
                # a metric's value read, not a queue's get
                out[name] = m.get()  # vmt: disable=VMT012
        return out

    def write_prometheus(self, extra: dict | None = None,
                         include_process: bool = True) -> str:
        """Render the registry as Prometheus text exposition.  ``extra``
        merges a one-shot dict of full-name -> value (e.g. a storage
        engine's ``.metrics()``); collectors registered via
        ``register_collector`` are read every call."""
        samples: list[tuple[str, str, str]] = []  # (family, name, value)
        types: dict[str, str] = {}
        for fam, kind, name, value in self._collect(extra, include_process):
            types.setdefault(fam, kind)
            samples.append((fam, name, value))
        samples.sort()
        out = []
        prev_fam = None
        for fam, name, value in samples:
            if fam != prev_fam:
                out.append(f"# TYPE {fam} {types.get(fam, 'gauge')}")
                prev_fam = fam
            out.append(f"{name} {value}")
        return "\n".join(out) + "\n" if out else ""


def _process_metrics():
    """process_* gauges (reference metrics.WriteProcessMetrics) + gc
    visibility (go_gc_* analog): per-generation collection counts read
    straight from the collector, so GC can be ruled in/out as a serving
    latency-variance source from /metrics alone (pause seconds come from
    the callback below — gc exposes no cumulative pause clock)."""
    import gc
    for gen, st in enumerate(gc.get_stats()):
        yield (f'vm_gc_collections_total{{gen="{gen}"}}',
               st.get("collections", 0))
        yield (f'vm_gc_collected_objects_total{{gen="{gen}"}}',
               st.get("collected", 0))
    yield "process_start_time_seconds", int(_started_at)
    yield "vm_app_uptime_seconds", round(uptime_seconds(), 3)
    # identity/info metrics (reference lib/buildinfo): constant-1 gauge
    # carrying the version labels, plus the start timestamp — the fleet
    # inventory the self-scrape plane's job=/instance= series hang off
    from . import buildinfo
    yield (f'vm_app_version{{version="{buildinfo.version()}",'
           f'short_version="{buildinfo.short_version()}"}}', 1)
    yield "vm_app_start_timestamp", int(_started_at)
    yield "process_num_threads", threading.active_count()
    try:
        t = os.times()
        yield "process_cpu_seconds_total", round(t.user + t.system, 3)
    except OSError:
        pass
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        page = os.sysconf("SC_PAGE_SIZE")
        yield "process_virtual_memory_bytes", int(parts[0]) * page
        yield "process_resident_memory_bytes", int(parts[1]) * page
    except (OSError, IndexError, ValueError):
        # non-Linux: RSS via resource (kilobytes on Linux, bytes on mac)
        try:
            import resource
            import sys
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            if sys.platform != "darwin":
                rss *= 1024
            yield "process_resident_memory_bytes", rss
        except (ImportError, OSError):
            yield "process_resident_memory_bytes", 0
    try:
        yield "process_open_fds", len(os.listdir("/proc/self/fd"))
    except OSError:
        pass


REGISTRY = MetricsRegistry()


# -- gc pause accounting ------------------------------------------------------

_GC_PAUSE = REGISTRY.float_counter("vm_gc_pause_seconds_total")
_gc_pause_t0 = [0.0]

#: (t0, dur_s, generation) observers invoked after each collection —
#: utils/flightrec appends one to land gc pauses on the flight timeline
#: without registering a SECOND gc callback that re-times the same
#: collection
gc_pause_hooks: list = []

# bound at import, NOT imported inside the callback: gc callbacks still
# fire during interpreter shutdown, when `import time` raises
# "import of time halted"
from time import perf_counter as _gc_clock  # noqa: E402


def _gc_pause_callback(phase: str, info: dict) -> None:
    # the collecting thread holds the GIL for the whole collection, so
    # start/stop pair up on one thread and a plain slot is race-free
    if phase == "start":
        _gc_pause_t0[0] = _gc_clock()
    elif phase == "stop" and _gc_pause_t0[0]:
        t0 = _gc_pause_t0[0]
        _gc_pause_t0[0] = 0.0
        dur = _gc_clock() - t0
        _GC_PAUSE.inc(dur)
        for hook in gc_pause_hooks:
            hook(t0, dur, info.get("generation", "?"))


def install_gc_metrics() -> None:
    """Accumulate gc collection pauses into vm_gc_pause_seconds_total
    (idempotent; installed at import — the counter must cover the whole
    process lifetime to be comparable with serving latency)."""
    import gc
    if _gc_pause_callback not in gc.callbacks:
        gc.callbacks.append(_gc_pause_callback)


install_gc_metrics()


def ingest_phase(phase: str) -> FloatCounter:
    """Per-phase write-path attribution counter (the ingest twin of the
    read path's ``vm_fetch_phase_seconds_total``): seconds spent in one
    stage of the ingestion pipeline.  Phases: ``resolve`` (raw key ->
    TSID), ``register`` (per-day index registration), ``append``
    (partition pending append), ``flush`` (part encode+fsync), ``merge``
    (background part merges).  Shared by storage/partition/mergeset and
    read by bench.py's per-refresh split."""
    return REGISTRY.float_counter(
        f'vm_ingest_phase_seconds_total{{phase="{phase}"}}')


# -- exposition utilities ----------------------------------------------------

def _sample_name_end(line: str) -> int:
    """Index of the first space separating the sample name (with its
    optional label set) from the value — quote-aware, so spaces inside
    label values never split the name."""
    in_q = False
    i = 0
    n = len(line)
    while i < n:
        c = line[i]
        if in_q:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_q = False
        elif c == '"':
            in_q = True
        elif c in " \t":
            return i
        i += 1
    return -1


def splice_extra_labels(text: str, extra_labels: str) -> str:
    """Insert ``extra_labels`` (e.g. ``job="vm",instance="h:80"``) into
    every sample line of a Prometheus exposition.  Quote-aware: label
    values containing spaces or braces survive (the reference's
    addExtraLabels, vendor/.../metrics/push.go:236)."""
    if not extra_labels:
        return text
    out = []
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            out.append(line)
            continue
        sp = _sample_name_end(line)
        if sp < 0:
            out.append(line)
            continue
        name, rest = line[:sp], line[sp + 1:]
        brace = name.find("{")
        if brace >= 0 and name.endswith("}"):
            inner = name[brace + 1:-1]
            name = name[:brace] + _join_labels(extra_labels, inner)
        else:
            name = name + "{" + extra_labels + "}"
        out.append(f"{name} {rest}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")
