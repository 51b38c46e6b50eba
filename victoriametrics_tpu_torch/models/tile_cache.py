"""Device-resident tile cache, the upload seam and link accounting.

Port of ``victoriametrics_tpu/models/tile_cache.py``.  Packed (series,
sample) tiles stay in device memory between queries (``TileCache``, an
LRU by bytes); rolling windows are registered in ``DeviceWindowCache``.
Every host->device and device->host byte of the engine goes through
``timed_transfer``, which counts it in ``vm_device_bytes_uploaded_total`` /
``vm_device_bytes_downloaded_total`` and times it in
``vm_device_transfer_duration_seconds{span}``.

``chunked_device_put`` stages a host array through pinned buffers of at
most ``UPLOAD_CHUNK_BYTES`` and copies each with ``non_blocking=True``, so
filling the next staging buffer overlaps the previous DMA.  PyTorch's
pinned-memory allocator records the copy's stream event on each staging
block and does not reuse the block before the copy has finished, so the
source stays alive until its copy is ordered.  The put ends with a stream
synchronisation, so the span times the whole transfer.  Arrays of at most
``DIRECT_PUT_BYTES`` (a rolling refresh's new columns) skip the staging:
PyTorch's own copy from pageable memory is cheaper there than allocating a
pinned block, while staging wins on large arrays.  ``chip_smoke.py``
times both paths at a refresh's size and at cold-upload sizes (on one
H100 80GB HBM3 at 700 W: a refresh's 0.82 MB of columns 0.16 ms direct vs
0.36 ms staged; 2.17 GB of cold planes 98 ms staged vs 385 ms direct).
"""

from __future__ import annotations

import collections
import os
import time
import weakref

import numpy as np
import torch

from ..devtools.locktrace import make_lock
from ..devtools.racetrace import traced_fields
from ..utils import costacc as _costacc
from ..utils import flightrec as _flightrec
from ..utils import metrics as metricslib

UPLOAD_CHUNK_BYTES = 64 << 20
DIRECT_PUT_BYTES = 1 << 20

_BYTES_UPLOADED = metricslib.REGISTRY.counter(
    "vm_device_bytes_uploaded_total")
_BYTES_DOWNLOADED = metricslib.REGISTRY.counter(
    "vm_device_bytes_downloaded_total")


def count_upload(nbytes: int) -> None:
    _BYTES_UPLOADED.inc(int(nbytes))
    _costacc.add_device(up=int(nbytes))


def count_download(nbytes: int) -> None:
    _BYTES_DOWNLOADED.inc(int(nbytes))
    _costacc.add_device(down=int(nbytes))


def bytes_uploaded() -> int:
    return _BYTES_UPLOADED.get()


def timed_transfer(span: str, nbytes: int, fn):
    """Run one H2D/D2H transfer `fn`, counting its bytes and its wall time
    — the one place every device:upload / device:download goes through.
    The wall time also goes to the flight recorder (transfers of 1 MiB
    and more, as the reference records them) and to the query's cost
    tracker, as link time with no CPU."""
    (count_upload if span == "device:upload" else count_download)(nbytes)
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        dt = time.perf_counter() - t0
        metricslib.REGISTRY.histogram(metricslib.format_name(
            "vm_device_transfer_duration_seconds", {"span": span})).update(
            dt)
        if nbytes >= (1 << 20):
            _flightrec.rec(span, t0, dt, arg=nbytes)
        tr = _costacc.current()
        if tr is not None:
            tr.lap(span, dt, 0.0)


def chunked_device_put(x: np.ndarray, device) -> torch.Tensor:
    """Host array -> a tensor of its own on `device` (a copy even on the
    CPU: the rolling append writes into resident tiles in place)."""
    x = np.ascontiguousarray(x)
    return timed_transfer("device:upload", x.nbytes,
                          lambda: _device_put(x, torch.device(device)))


def _device_put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    if device.type != "cuda":
        return torch.from_numpy(x).clone()
    if x.nbytes <= DIRECT_PUT_BYTES:
        return direct_put(x, device)
    return staged_put(x, device)


def direct_put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """One synchronous copy from pageable host memory."""
    return torch.from_numpy(x).to(device)


def staged_put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy through pinned staging buffers of at most UPLOAD_CHUNK_BYTES,
    each sent with non_blocking=True; ends with a stream synchronisation."""
    src = torch.from_numpy(x)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    rows = src.shape[0] if src.dim() else 1
    row_bytes = max(x.nbytes // max(rows, 1), 1)
    step = max(1, UPLOAD_CHUNK_BYTES // row_bytes)
    flat_src = src.reshape(rows, -1)
    flat_out = out.reshape(rows, -1)
    for i in range(0, rows, step):
        part = flat_src[i:i + step]
        staged = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
        staged.copy_(part)
        flat_out[i:i + step].copy_(staged, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return out


# cache self-metrics; gauges sum over every live TileCache
_instances: "weakref.WeakSet[TileCache]" = weakref.WeakSet()
_CACHE_REQUESTS = metricslib.REGISTRY.counter(
    'vm_cache_requests_total{type="tpu/tile_cache"}')
_CACHE_MISSES = metricslib.REGISTRY.counter(
    'vm_cache_misses_total{type="tpu/tile_cache"}')
metricslib.REGISTRY.gauge(
    'vm_cache_size_bytes{type="tpu/tile_cache"}',
    callback=lambda: sum(c.size_bytes for c in list(_instances)))
metricslib.REGISTRY.gauge(
    'vm_cache_entries{type="tpu/tile_cache"}',
    callback=lambda: sum(c.entry_count() for c in list(_instances)))

# device-resident window health: hits = refreshes served from a resident
# window, evictions = windows dropped by the LRU bound, compactions =
# on-device window slides instead of a full re-upload
_WINDOW_HITS = metricslib.REGISTRY.counter(
    "vm_device_window_cache_hits_total")
_WINDOW_EVICTIONS = metricslib.REGISTRY.counter(
    "vm_device_window_cache_evictions_total")
_WINDOW_COMPACTIONS = metricslib.REGISTRY.counter(
    "vm_device_window_compactions_total")


def device_resident_enabled() -> bool:
    """Device data residency on?  VM_DEVICE_RESIDENT=0 turns off every
    resident-window reuse path, so each query re-uploads its full window
    (the full-upload escape hatch and the residency equality oracle)."""
    return os.environ.get("VM_DEVICE_RESIDENT", "1") != "0"


def count_window_hit() -> None:
    _WINDOW_HITS.inc()


def count_window_compaction() -> None:
    _WINDOW_COMPACTIONS.inc()


class DeviceWindowCache:
    """Host-side registry of device-resident rolling windows: each entry
    pins one query shape's RollingTile and its group layout, so a rolling
    refresh uploads only its new columns.  Entry-count LRU; evictions tick
    vm_device_window_cache_evictions_total."""

    def __init__(self, cap: int = 256):
        self.cap = max(int(cap), 1)
        self._lock = make_lock("models.DeviceWindowCache._lock")
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        with self._lock:
            v = self._entries.get(key)
            if v is not None:
                self._entries.move_to_end(key)
            return v

    def peek(self, key):
        """The entry under `key` without refreshing its LRU position."""
        with self._lock:
            return self._entries.get(key)

    def put(self, key, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)
                _WINDOW_EVICTIONS.inc()

    def invalidate(self, key=None) -> None:
        with self._lock:
            if key is None:
                self._entries.clear()
            else:
                self._entries.pop(key, None)


def tiles_nbytes(tiles) -> int:
    """Device bytes of a tile tuple; a series-sharded entry (a list of
    per-shard tensors) counts the bytes of every shard."""
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else tiles_nbytes(t) if isinstance(t, (list, tuple)) else 0
               for t in tiles)


@traced_fields("_entries", "_sizes", "_bytes")
class TileCache:
    """LRU byte-bounded cache of device-resident tile tuples."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._lock = make_lock("models.TileCache._lock")
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        _instances.add(self)

    def get(self, key):
        _CACHE_REQUESTS.inc()
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return self._entries[key]
        _CACHE_MISSES.inc()
        return None

    def put_device(self, key, tiles):
        """Retain an already-device-resident tile tuple.  A tuple larger
        than the whole budget is returned but not retained."""
        size = tiles_nbytes(tiles)
        if size > self.capacity:
            self.invalidate(key)
            return tiles
        with self._lock:
            if key in self._entries:
                self._bytes -= self._sizes.pop(key)
                del self._entries[key]
            while self._bytes + size > self.capacity and self._entries:
                old, _ = self._entries.popitem(last=False)
                self._bytes -= self._sizes.pop(old)
            self._entries[key] = tiles
            self._sizes[key] = size
            self._bytes += size
        return tiles

    def invalidate(self, key=None):
        with self._lock:
            if key is None:
                self._entries.clear()
                self._sizes.clear()
                self._bytes = 0
            elif key in self._entries:
                self._bytes -= self._sizes.pop(key)
                del self._entries[key]

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return self._bytes
