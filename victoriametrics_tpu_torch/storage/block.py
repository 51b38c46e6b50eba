"""Data blocks: up to 8k rows of one series, separately-encoded timestamp and
value columns (reference lib/storage/block.go:14-22, block_header.go:19).

A Block is the unit moving through parts, merges, RPC and the TPU packer:
  timestamps: int64 unix ms, non-decreasing
  values:     int64 decimal mantissas sharing `scale` (ops.decimal)
Header carries the codec metadata and the payload offsets inside the part's
timestamps.bin / values.bin.

The port's copy of ``victoriametrics_tpu/storage/block.py``, whole.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops import decimal as dec
from ..ops import encoding as enc
from .tsid import TSID

MAX_ROWS_PER_BLOCK = 8192

# tsid(32) min_ts max_ts rows scale prec ts_mt val_mt ts_first val_first
# ts_off ts_size val_off val_size
_HDR = struct.Struct(">32sqqIhBBBqqQIQI")


class BlockHeader:
    __slots__ = ("tsid", "min_ts", "max_ts", "rows", "scale", "precision_bits",
                 "ts_marshal_type", "val_marshal_type", "ts_first",
                 "val_first", "ts_offset", "ts_size", "val_offset", "val_size")

    SIZE = _HDR.size

    def marshal(self) -> bytes:
        return _HDR.pack(
            self.tsid.marshal(), self.min_ts, self.max_ts, self.rows,
            self.scale, self.precision_bits, int(self.ts_marshal_type),
            int(self.val_marshal_type), self.ts_first, self.val_first,
            self.ts_offset, self.ts_size, self.val_offset, self.val_size)

    @classmethod
    def unmarshal(cls, data: bytes, offset: int = 0) -> "BlockHeader":
        (tsid_b, min_ts, max_ts, rows, scale, prec, ts_mt, val_mt, ts_first,
         val_first, ts_off, ts_size, val_off, val_size) = _HDR.unpack_from(
            data, offset)
        h = cls()
        h.tsid = TSID.unmarshal(tsid_b)
        h.min_ts, h.max_ts, h.rows = min_ts, max_ts, rows
        h.scale, h.precision_bits = scale, prec
        h.ts_marshal_type = enc.MarshalType(ts_mt)
        h.val_marshal_type = enc.MarshalType(val_mt)
        h.ts_first, h.val_first = ts_first, val_first
        h.ts_offset, h.ts_size = ts_off, ts_size
        h.val_offset, h.val_size = val_off, val_size
        return h


class Block:
    """Decoded (in-RAM) block."""

    __slots__ = ("tsid", "timestamps", "values", "scale", "precision_bits",
                 "_floats", "_has_stale")

    def __init__(self, tsid: TSID, timestamps: np.ndarray, values: np.ndarray,
                 scale: int, precision_bits: int = 64):
        self.tsid = tsid
        self.timestamps = timestamps
        self.values = values  # int64 mantissas
        self.scale = scale
        self.precision_bits = precision_bits
        self._floats = None
        self._has_stale = None

    @classmethod
    def from_floats(cls, tsid: TSID, timestamps: np.ndarray,
                    float_values: np.ndarray, precision_bits: int = 64) -> "Block":
        m, e = dec.float_to_decimal(np.asarray(float_values, dtype=np.float64))
        return cls(tsid, np.asarray(timestamps, dtype=np.int64), m, e,
                   precision_bits)

    def float_values(self) -> np.ndarray:
        # memoized: blocks live in the part block cache across queries
        if self._floats is None:
            f = dec.decimal_to_float(self.values, self.scale)
            f.setflags(write=False)
            self._floats = f
        return self._floats

    def has_stale(self) -> bool:
        """Whether any value is a staleness-marker NaN — memoized alongside
        the float decode so warm queries skip the per-query stale scan."""
        if self._has_stale is None:
            self._has_stale = bool(
                dec.is_stale_nan(self.float_values()).any())
        return self._has_stale

    @property
    def rows(self) -> int:
        return int(self.timestamps.size)

    def marshal(self) -> tuple[BlockHeader, bytes, bytes]:
        """Returns (header-without-offsets, ts_payload, val_payload)."""
        if not 0 < self.rows <= MAX_ROWS_PER_BLOCK:
            raise ValueError(f"block rows {self.rows} out of range")
        ts_data, ts_mt, ts_first = enc.marshal_timestamps(
            self.timestamps, 64)
        val_data, val_mt, val_first = enc.marshal_values(
            self.values, self.precision_bits)
        h = BlockHeader()
        h.tsid = self.tsid
        h.min_ts = int(self.timestamps[0])
        h.max_ts = int(self.timestamps[-1])
        h.rows = self.rows
        h.scale = self.scale
        h.precision_bits = self.precision_bits
        h.ts_marshal_type = ts_mt
        h.val_marshal_type = val_mt
        h.ts_first = ts_first
        h.val_first = val_first
        h.ts_offset = h.val_offset = 0
        h.ts_size = len(ts_data)
        h.val_size = len(val_data)
        return h, ts_data, val_data

    @classmethod
    def unmarshal(cls, h: BlockHeader, ts_data: bytes, val_data: bytes) -> "Block":
        ts = enc.unmarshal_timestamps(ts_data, h.ts_marshal_type, h.ts_first,
                                      h.rows)
        vals = enc.unmarshal_values(val_data, h.val_marshal_type, h.val_first,
                                    h.rows)
        return cls(h.tsid, ts, vals, h.scale, h.precision_bits)


def rows_to_blocks(tsid: TSID, timestamps: np.ndarray, values_f: np.ndarray,
                   precision_bits: int = 64):
    """Split one series' sorted rows into <=8k-row blocks."""
    n = timestamps.size
    for i in range(0, n, MAX_ROWS_PER_BLOCK):
        j = min(i + MAX_ROWS_PER_BLOCK, n)
        yield Block.from_floats(tsid, timestamps[i:j], values_f[i:j],
                                precision_bits)
