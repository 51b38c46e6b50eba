"""Compact nearest-delta2 planes: host packing, the device decode (K1) and
the fused decode + rollup (B12).

The cold upload ships second-order deltas quantized to the narrowest
integer plane that fits (int8/int16/int32), about 2-5 bytes per sample
instead of the 12 of a dense (int32 ts, float64 value) tile, and rebuilds
the tile on the card with two cumulative sums per row.  Port of
``victoriametrics_tpu/ops/device_decode.py``: ``pack_delta_planes`` is the
same host code (same arrays, dtype for dtype, float64 scale);
``decode_tiles`` launches ``csrc/decode.cu`` (both planes of a row in one
launch, chunked by ``k1_plan``) for CUDA tensors and runs its plain
PyTorch version for CPU tensors; ``decode_and_rollup`` decodes each
row and rolls it up in one kernel (``csrc/rollup.cu`` decode_rollup),
never writing the decoded [S, n] tile.

Overflow safety: a tile is only eligible when every intermediate
(mantissa, delta) fits int32; otherwise ``pack_delta_planes`` returns None
and the caller packs a dense tile.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import kernels
from .device_rollup import (FUNC_CODES, MIN_TS_NONE, num_steps,
                            rollup_tile_plain)
from .rollup_np import RollupConfig

TS_PAD = np.int32(2**31 - 1)


@dataclasses.dataclass
class DeltaPlanes:
    """Host-built compact tile; every field a numpy array."""
    ts_first: np.ndarray    # int32 [S], relative to start_ms
    ts_fdelta: np.ndarray   # int32 [S]
    ts_d2: np.ndarray       # int8/int16/int32 [S, max(N-2,1)]
    val_first: np.ndarray   # int32 [S] mantissas
    val_fdelta: np.ndarray  # int32 [S]
    val_d2: np.ndarray      # int8/int16/int32 [S, max(N-2,1)]
    scale: np.ndarray       # float64 [S] = 10^exponent
    counts: np.ndarray      # int32 [S]

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes
                   for f in dataclasses.fields(self))


def _narrowest_plane(d2: np.ndarray):
    if d2.size == 0:
        return np.int8
    m = np.abs(d2).max()
    if m < 127:
        return np.int8
    if m < 32767:
        return np.int16
    return np.int32


def pack_delta_planes(series, start_ms: int) -> DeltaPlanes | None:
    """series: [(ts_ms int64[], mantissas int64[], exponent)] — returns None
    when any series needs >int32 intermediates (caller falls back)."""
    S = len(series)
    if S == 0:
        return None
    counts = np.array([len(t) for t, _, _ in series], dtype=np.int32)
    if (counts < 1).any():
        return None
    N = int(counts.max())
    ts_first = np.zeros(S, dtype=np.int64)
    ts_fd = np.zeros(S, dtype=np.int64)
    val_first = np.zeros(S, dtype=np.int64)
    val_fd = np.zeros(S, dtype=np.int64)
    scale = np.ones(S, dtype=np.float64)
    ts_d2 = np.zeros((S, max(N - 2, 1)), dtype=np.int64)
    val_d2 = np.zeros((S, max(N - 2, 1)), dtype=np.int64)
    for i, (ts, m, exp) in enumerate(series):
        rel = np.asarray(ts, dtype=np.int64) - start_ms
        m = np.asarray(m, dtype=np.int64)
        if rel.size and (np.abs(rel).max() >= 2**31 or
                         np.abs(m).max() >= 2**31):
            return None
        ts_first[i] = rel[0]
        val_first[i] = m[0]
        scale[i] = np.float64(10.0) ** exp
        if rel.size >= 2:
            td = np.diff(rel)
            vd = np.diff(m)
            if np.abs(td).max() >= 2**31 or np.abs(vd).max() >= 2**31:
                return None
            ts_fd[i] = td[0]
            val_fd[i] = vd[0]
            if rel.size >= 3:
                t2 = np.diff(td)
                v2 = np.diff(vd)
                if np.abs(t2).max() >= 2**31 or np.abs(v2).max() >= 2**31:
                    return None
                ts_d2[i, :t2.size] = t2
                val_d2[i, :v2.size] = v2
    return DeltaPlanes(
        ts_first=ts_first.astype(np.int32),
        ts_fdelta=ts_fd.astype(np.int32),
        ts_d2=ts_d2.astype(_narrowest_plane(ts_d2)),
        val_first=val_first.astype(np.int32),
        val_fdelta=val_fd.astype(np.int32),
        val_d2=val_d2.astype(_narrowest_plane(val_d2)),
        scale=scale,
        counts=counts,
    )


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (two's
    complement wraparound, as the reference's int32 cumsum)."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def _reconstruct_plain(first, fdelta, d2, n: int) -> torch.Tensor:
    """x[j] = first + sum_{k<j} d1[k], d1 = cumsum([fdelta, d2...]), in
    wrapping int32 arithmetic (computed in int64, wrapped per sum)."""
    S = first.shape[0]
    a = torch.zeros((S, n), dtype=torch.int64, device=first.device)
    if n >= 2:
        a[:, 1] = fdelta.to(torch.int64)
    if n >= 3:
        a[:, 2:] = d2[:, :n - 2].to(torch.int64)
    b = _wrap_int32(torch.cumsum(a, dim=1))
    x = _wrap_int32(first.to(torch.int64)[:, None] + torch.cumsum(b, dim=1))
    return x.to(torch.int32)


def decode_tiles_plain(ts_first, ts_fd, ts_d2, val_first, val_fd, val_d2,
                       scale, counts, n: int):
    """Plain PyTorch version of the K1 kernel: the same function with
    ``torch.cumsum``."""
    ts = _reconstruct_plain(ts_first, ts_fd, ts_d2, n)
    valid = torch.arange(n, device=ts.device)[None, :] < counts[:, None]
    ts = torch.where(valid, ts, torch.tensor(int(TS_PAD), dtype=torch.int32,
                                             device=ts.device))
    mant = _reconstruct_plain(val_first, val_fd, val_d2, n)
    vals = mant.to(torch.float64) * scale.to(torch.float64)[:, None]
    return ts, vals


# an H100 SM's shared memory in bytes (k1_plan's default; a launch reads
# the card's own), and the runtime's share of each resident block
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
# K1's static shared memory: its block scans' warp sums (8 uint2)
K1_STATIC_SMEM = 64

#: K1's launch: columns a chunk, dynamic shared bytes a block
K1Plan = collections.namedtuple("K1Plan", "chunk smem")


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def k1_smem(chunk: int, ts_bytes: int, val_bytes: int) -> int:
    """K1's workspace for a chunk of `chunk` columns with d2 planes of
    `ts_bytes` and `val_bytes` a column (csrc/decode.cu ts_ws + val_ws +
    raw_ws x 2; the launch refuses a size that differs): the ts with 3
    words of alignment slack, the values with 1, each plane's staged d2
    words with 32 bytes over."""
    return (_round16(4 * (chunk + 3)) + _round16(8 * (chunk + 1)) +
            _round16(chunk * ts_bytes + 32) + _round16(chunk * val_bytes + 32))


@functools.lru_cache(maxsize=None)
def k1_plan(n: int, ts_bytes: int, val_bytes: int,
            smem_per_sm: int = SMEM_PER_SM) -> K1Plan:
    """K1's chunk for rows of n columns on an SM of `smem_per_sm` shared
    bytes: the whole row where two blocks of its workspace fit an SM (the
    full width's 7232 columns of int16 and int8 planes: 108 KB), else the
    fewest chunks that do, of equal width rounded up to a multiple of 32
    columns, carried chunk to chunk.  The launch runs as many blocks as
    the card's occupancy query lets reside."""
    room = smem_per_sm // 2 - SMEM_RESERVED - K1_STATIC_SMEM
    chunk = max(int(n), 1)
    if k1_smem(chunk, ts_bytes, val_bytes) > room:
        widest = room // (12 + ts_bytes + val_bytes) // 32 * 32
        while k1_smem(widest, ts_bytes, val_bytes) > room:
            widest -= 32
        chunks = -(-chunk // widest)
        chunk = -(-chunk // (32 * chunks)) * 32
    return K1Plan(chunk, k1_smem(chunk, ts_bytes, val_bytes))


def decode_tiles(ts_first, ts_fd, ts_d2, val_first, val_fd, val_d2, scale,
                 counts, n: int):
    """Decode delta planes -> (ts int32 [S, n], vals float64 [S, n]).

    The d2 planes must hold at least n - 2 columns (the engine pads them
    with zeros up to the tile capacity).  ts is TS_PAD past each row's
    count; the values past it are the planes' linear continuation, which
    every kernel masks by counts."""
    args = (ts_first, ts_fd, ts_d2, val_first, val_fd, val_d2, scale, counts)
    dev = kernels.placement(*args)
    S = int(counts.shape[0])
    n = int(n)
    for name, d2 in (("ts_d2", ts_d2), ("val_d2", val_d2)):
        if d2.dim() != 2 or d2.shape[0] != S or d2.shape[1] < n - 2:
            raise ValueError(f"{name}: need [S, >= n-2] = [{S}, >= {n - 2}],"
                             f" got {tuple(d2.shape)}")
        if d2.dtype not in (torch.int8, torch.int16, torch.int32):
            raise TypeError(f"{name}: int8/int16/int32 plane, got {d2.dtype}")
    if dev.type == "cpu":
        return decode_tiles_plain(*args, n)
    for name, t in (("ts_first", ts_first), ("ts_fdelta", ts_fd),
                    ("val_first", val_first), ("val_fdelta", val_fd),
                    ("counts", counts)):
        kernels.require(t, name, torch.int32, (S,))
    kernels.require(scale, "scale", torch.float64, (S,))
    for name, d2 in (("ts_d2", ts_d2), ("val_d2", val_d2)):
        kernels.require(d2, name, d2.dtype, tuple(d2.shape))
    plan = k1_plan(n, ts_d2.element_size(), val_d2.element_size(),
                   kernels.smem_per_sm(dev))
    h = kernels.lib("decode")
    ts = torch.empty((S, n), dtype=torch.int32, device=dev)
    vals = torch.empty((S, n), dtype=torch.float64, device=dev)
    kernels.check(h, h.vm_decode_tiles(
        ts_first.data_ptr(), ts_fd.data_ptr(), ts_d2.data_ptr(),
        ts_d2.element_size(), ts_d2.shape[1], val_first.data_ptr(),
        val_fd.data_ptr(), val_d2.data_ptr(), val_d2.element_size(),
        val_d2.shape[1], scale.data_ptr(), counts.data_ptr(), S, n,
        plan.chunk, plan.smem, ts.data_ptr(), vals.data_ptr(),
        kernels.stream_of(dev)), "decode_tiles")
    kernels.LAUNCHES["decode_tiles"] += 1
    return ts, vals


def decode_and_rollup_plain(func: str, ts_first, ts_fd, ts_d2, val_first,
                            val_fd, val_d2, scale, counts, cfg: RollupConfig,
                            n: int) -> torch.Tensor:
    """Plain version of B12: decode_tiles_plain, then rollup_tile_plain."""
    ts, vals = decode_tiles_plain(ts_first, ts_fd, ts_d2, val_first, val_fd,
                                  val_d2, scale, counts, n)
    return rollup_tile_plain(func, ts, vals, counts, cfg)


def decode_and_rollup(func: str, ts_first, ts_fd, ts_d2, val_first, val_fd,
                      val_d2, scale, counts, cfg: RollupConfig, n: int,
                      force_global: bool = False) -> torch.Tensor:
    """B12: fused decode + rollup of delta planes -> float64 [S, T].

    The kernel decodes each row with K1's arithmetic and rolls it up with
    B5's series pass, so its output equals decode_tiles -> rollup_tile bit
    for bit, without the decoded tile.  A decoded row (12 B per column)
    lives in shared memory up to the card's opt-in limit, else in a
    global scratch slot of each resident block; `force_global` takes the
    scratch path at any width (to test it)."""
    if func not in FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {func!r}")
    args = (ts_first, ts_fd, ts_d2, val_first, val_fd, val_d2, scale, counts)
    dev = kernels.placement(*args)
    S = int(counts.shape[0])
    n = int(n)
    for name, d2 in (("ts_d2", ts_d2), ("val_d2", val_d2)):
        if d2.dim() != 2 or d2.shape[0] != S or d2.shape[1] < n - 2:
            raise ValueError(f"{name}: need [S, >= n-2] = [{S}, >= {n - 2}],"
                             f" got {tuple(d2.shape)}")
        if d2.dtype not in (torch.int8, torch.int16, torch.int32):
            raise TypeError(f"{name}: int8/int16/int32 plane, got {d2.dtype}")
    if dev.type == "cpu":
        return decode_and_rollup_plain(func, *args, cfg, n)
    for name, t in (("ts_first", ts_first), ("ts_fdelta", ts_fd),
                    ("val_first", val_first), ("val_fdelta", val_fd),
                    ("counts", counts)):
        kernels.require(t, name, torch.int32, (S,))
    kernels.require(scale, "scale", torch.float64, (S,))
    for name, d2 in (("ts_d2", ts_d2), ("val_d2", val_d2)):
        kernels.require(d2, name, d2.dtype, tuple(d2.shape))
    T = num_steps(cfg)
    h = kernels.lib("rollup")
    code = FUNC_CODES[func]
    blocks = ctypes.c_int(0)
    nbytes = ctypes.c_longlong(0)
    kernels.check(h, h.vm_decode_rollup_plan(
        S, n, code, int(bool(force_global)), ctypes.byref(blocks),
        ctypes.byref(nbytes)), "decode_and_rollup (plan)")
    scratch = torch.empty(max(nbytes.value, 8), dtype=torch.uint8,
                          device=dev)
    out = torch.empty((S, T), dtype=torch.float64, device=dev)
    kernels.check(h, h.vm_decode_rollup(
        ts_first.data_ptr(), ts_fd.data_ptr(), ts_d2.data_ptr(),
        ts_d2.element_size(), ts_d2.shape[1], val_first.data_ptr(),
        val_fd.data_ptr(), val_d2.data_ptr(), val_d2.element_size(),
        val_d2.shape[1], scale.data_ptr(), counts.data_ptr(), S, n, T,
        int(MIN_TS_NONE), cfg.step, cfg.lookback, float(cfg.start) / 1e3,
        int(cfg.start >= cfg.end), code, int(bool(force_global)),
        scratch.data_ptr(), out.data_ptr(), kernels.stream_of(dev)),
        "decode_and_rollup")
    del scratch  # lives until the launch is queued
    kernels.LAUNCHES["decode_and_rollup"] += 1
    return out
