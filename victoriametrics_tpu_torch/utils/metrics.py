"""Minimal process-wide self-metrics registry.

The port keeps the JAX package's metric names
(``vm_device_bytes_{uploaded,downloaded}_total``,
``vm_tpu_kernel_duration_seconds{kernel,phase}``, ``vm_device_window_*``,
``vm_cache_*{type="tpu/tile_cache"}``) so dashboards read both engines the
same way.  This is the small subset of ``victoriametrics_tpu/utils/
metrics.py`` the device engine and the storage need: integer and float
counters, gauges (set, or read from a callback), histograms with the
storage's own vmrange buckets (``query/vmhistogram.py``) beside their
``_sum``/``_count`` pair, the gc pause counter with its observer hooks
(``gc_pause_hooks``, which ``utils/flightrec`` appends to), and the ingest
phase counters.  Metrics are keyed by their full name including labels.
(The Prometheus text exposition and the process metrics come with the
HTTP layer.)
"""

from __future__ import annotations

import threading
import time

from ..query import vmhistogram


def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash, quote, LF)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def format_name(base: str, labels: dict | None = None) -> str:
    """``format_name("m", {"a": "b"})`` -> ``m{a="b"}`` with values
    escaped; labels render in insertion order."""
    if not labels:
        return base
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return f"{base}{{{inner}}}"


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._v += n

    def get(self):
        with self._lock:
            return self._v

    def set(self, v) -> None:
        with self._lock:
            self._v = v


class FloatCounter(Counter):
    """Monotonic float counter (e.g. accumulated seconds)."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name)
        self._v = 0.0


class Gauge:
    """Instantaneous value: read from a callback at exposition time, or
    driven by set()/inc()/dec()."""

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
            return float(self.callback())
        with self._lock:
            return self._v


class Histogram:
    """VictoriaMetrics-native histogram: log-spaced vmrange buckets
    (18/decade, query/vmhistogram.py) storing only non-empty buckets,
    plus the sum and count.  NaN and negative values are skipped,
    matching the reference (histogram.go:85)."""

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

    def buckets(self) -> dict[str, int]:
        """{vmrange label: observations} of the non-empty buckets."""
        with self._lock:
            return dict(self._buckets)

    def update_duration(self, start_monotonic: float) -> None:
        self.update(time.perf_counter() - start_monotonic)

    def get_count(self) -> int:
        with self._lock:
            return self._count

    def get_sum(self) -> float:
        with self._lock:
            return self._sum


class MetricsRegistry:
    """Name -> metric map; creating an existing name returns the same
    object, so modules may register at import time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, name: str, make):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, lambda: Counter(name))

    def float_counter(self, name: str) -> FloatCounter:
        return self._get_or_create(name, lambda: FloatCounter(name))

    def gauge(self, name: str, callback=None) -> Gauge:
        g = self._get_or_create(name, lambda: Gauge(name, callback))
        if callback is not None and g.callback is None:
            g.callback = callback
        return g

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name))

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
                out[name] = m.get()
        return out


REGISTRY = MetricsRegistry()


# -- gc pause accounting ------------------------------------------------------

_GC_PAUSE = REGISTRY.float_counter("vm_gc_pause_seconds_total")
_gc_pause_t0 = [0.0]

#: (t0, dur_s, generation) observers invoked after each collection:
#: utils/flightrec appends one to land gc pauses on the flight timeline
#: without registering a second gc callback that re-times the same
#: collection
gc_pause_hooks: list = []

# bound at import, not imported inside the callback: gc callbacks still
# fire during interpreter shutdown, when `import time` raises
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
    (idempotent; installed at import, so the counter covers the whole
    process lifetime)."""
    import gc
    if _gc_pause_callback not in gc.callbacks:
        gc.callbacks.append(_gc_pause_callback)


install_gc_metrics()


def ingest_phase(phase: str) -> FloatCounter:
    """Seconds spent in one stage of the write path: ``resolve`` (raw key
    -> TSID), ``register`` (per-day index registration), ``append``
    (partition pending append), ``flush`` (part encode + fsync), ``merge``
    (background part merges)."""
    return REGISTRY.float_counter(
        f'vm_ingest_phase_seconds_total{{phase="{phase}"}}')
