"""Lossy nearest-delta codecs (reference lib/encoding/nearest_delta.go:15,83
and nearest_delta2.go:15,53); the port's own copy of
``victoriametrics_tpu/ops/nearest_delta.py``.

nearest-delta: store first value + per-sample deltas rounded to keep only the
top `precision_bits` binary digits of each delta (gauges).
nearest-delta2: the same over second-order deltas (counters / timestamps,
which are near-linear so double deltas are tiny).

precision_bits is 1..64; 64 means lossless and runs as a pure vector op.
Lossy encode (<64) uses error feedback — each delta is taken against the
*reconstructed* previous value so rounding error never accumulates — which is
a sequential dependency, kept as a host loop (it is opt-in, off the default
path; the C++ host kernel later replaces it). Decode is always a (double)
prefix sum — the shape the K1 kernel runs on the card
(ops/device_decode.py, csrc/decode.cu).
"""

from __future__ import annotations

import numpy as np

from .varint import bit_len_u64


def round_to_precision_bits(d: np.ndarray, precision_bits: int) -> np.ndarray:
    """Zero out low bits of each delta so only precision_bits significant
    binary digits remain (truncation toward zero, like the reference)."""
    d = np.asarray(d, dtype=np.int64)
    if precision_bits >= 64:
        return d
    absd = np.abs(d).astype(np.uint64)
    bits = bit_len_u64(absd)
    drop = np.maximum(bits - precision_bits, 0).astype(np.uint64)
    rounded = ((absd >> drop) << drop).astype(np.int64)
    return np.where(d < 0, -rounded, rounded)


def _wrap64(x: int) -> int:
    """Wrap an unbounded Python int to two's-complement int64 (the lossy
    encode loops must match the wrapping array arithmetic of the lossless
    path when sentinel mantissas sit near the int64 bounds)."""
    return ((x + (1 << 63)) & ((1 << 64) - 1)) - (1 << 63)


def _round_scalar(d: int, precision_bits: int) -> int:
    if precision_bits >= 64:
        return d
    absd = abs(d)
    drop = max(absd.bit_length() - precision_bits, 0)
    rounded = (absd >> drop) << drop
    return -rounded if d < 0 else rounded


def nearest_delta_encode(values: np.ndarray, precision_bits: int
                         ) -> tuple[int, np.ndarray]:
    """Returns (first_value, deltas[1:]) with error feedback when lossy."""
    v = np.asarray(values, dtype=np.int64)
    if v.size == 0:
        raise ValueError("nearest_delta: empty input")
    if precision_bits >= 64:
        return int(v[0]), (v[1:] - v[:-1])
    out = np.empty(v.size - 1, dtype=np.int64)
    rec = int(v[0])
    for i in range(1, v.size):
        d = _round_scalar(_wrap64(int(v[i]) - rec), precision_bits)
        rec = _wrap64(rec + d)
        out[i - 1] = d
    return int(v[0]), out


def nearest_delta_decode(first: int, deltas: np.ndarray) -> np.ndarray:
    out = np.empty(deltas.size + 1, dtype=np.int64)
    out[0] = first
    np.cumsum(deltas, out=out[1:])
    out[1:] += first
    return out


def nearest_delta2_encode(values: np.ndarray, precision_bits: int
                          ) -> tuple[int, int, np.ndarray]:
    """Returns (first_value, first_delta, second deltas) with error feedback."""
    v = np.asarray(values, dtype=np.int64)
    if v.size < 2:
        raise ValueError("nearest_delta2: need >= 2 values")
    if precision_bits >= 64:
        d1 = v[1:] - v[:-1]  # wrapping int64 (sentinels near the bounds)
        return int(v[0]), int(d1[0]), (d1[1:] - d1[:-1])
    out = np.empty(v.size - 2, dtype=np.int64)
    first_delta = _wrap64(int(v[1]) - int(v[0]))
    rec = int(v[1])
    rec_d = first_delta
    for i in range(2, v.size):
        d2 = _round_scalar(_wrap64(int(v[i]) - rec - rec_d), precision_bits)
        rec_d = _wrap64(rec_d + d2)
        rec = _wrap64(rec + rec_d)
        out[i - 2] = d2
    return int(v[0]), first_delta, out


def nearest_delta2_decode(first: int, first_delta: int, d2: np.ndarray) -> np.ndarray:
    d1 = np.empty(d2.size + 1, dtype=np.int64)
    d1[0] = first_delta
    np.cumsum(d2, out=d1[1:])
    d1[1:] += first_delta
    out = np.empty(d1.size + 1, dtype=np.int64)
    out[0] = first
    np.cumsum(d1, out=out[1:])
    out[1:] += first
    return out
