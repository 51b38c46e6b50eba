"""Prometheus TSDB block reader (+ minimal writer for tests).

Implements the on-disk TSDB block format (the reference vmctl's
prometheus mode reads these via prometheus/tsdb; format spec:
prometheus/tsdb/docs/format/{index,chunks}.md):

  block/
    meta.json
    index          magic 0xBAAAD700 v2: symbols, series (16-byte aligned,
                   label symbol-refs + chunk metas), TOC at the tail
    chunks/000001  magic 0x85BD40DD v1: uvarint len, encoding byte
                   (1 = XOR), Gorilla bitstream, crc32c

XOR chunks hold (timestamp-ms, float64) samples with delta-of-delta
timestamps (prefix codes 0 / 10+14b / 110+17b / 1110+20b / 1111+64b) and
leading/trailing-aware value XOR — decoded here with a whole-chunk int
bitreader, no per-bit Python.

read_block() yields (labels dict, ts_ms int64[], values float64[]) per
series; verify_block() walks every structure and CRC and returns a
report (the vmctl verify-block mode).

The port's copy of ``victoriametrics_tpu/utils/promtsdb.py``, whole:
the blocks it writes are the reference's byte for byte, since a
user's Prometheus data directory is the input."""

from __future__ import annotations

import json
import os
import struct

import numpy as np

INDEX_MAGIC = 0xBAAAD700
CHUNKS_MAGIC = 0x85BD40DD


# -- crc32 Castagnoli (TSDB uses crc32c, not zlib's IEEE) -------------------

def _make_crc32c_table():
    poly = 0x82F63B78
    tbl = np.empty(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl[i] = c
    return tbl


def _make_crc32c_tables8():
    """Slicing-by-8 tables: 8 bytes consumed per loop iteration (~6x a
    per-byte loop in pure Python; real blocks carry hundreds of MB of
    chunk data through verify-block)."""
    t0 = _make_crc32c_table().tolist()
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[i] & 0xFF] ^ (prev[i] >> 8)
                       for i in range(256)])
    return tables


_CRC32C_T = _make_crc32c_tables8()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC32C_T
    n8 = len(data) // 8 * 8
    i = 0
    while i < n8:
        crc ^= int.from_bytes(data[i:i + 4], "little")
        b4 = data[i + 4]
        b5 = data[i + 5]
        b6 = data[i + 6]
        b7 = data[i + 7]
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF] ^
               t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF] ^
               t3[b4] ^ t2[b5] ^ t1[b6] ^ t0[b7])
        i += 8
    for b in data[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- varints ----------------------------------------------------------------

def _uvarint(b: bytes, i: int) -> tuple[int, int]:
    shift = x = 0
    while True:
        c = b[i]
        i += 1
        x |= (c & 0x7F) << shift
        if not c & 0x80:
            return x, i
        shift += 7


def _varint(b: bytes, i: int) -> tuple[int, int]:
    u, i = _uvarint(b, i)
    return (u >> 1) ^ -(u & 1), i


def _put_uvarint(x: int) -> bytes:
    out = bytearray()
    while True:
        c = x & 0x7F
        x >>= 7
        if x:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _put_varint(x: int) -> bytes:
    # zigzag encode (Go binary.PutVarint); Python's arithmetic shift
    # makes the branchless form exact for negatives too
    return _put_uvarint((x << 1) ^ (x >> 63))


# -- bit reader over the whole chunk ----------------------------------------

class _BitReader:
    """MSB-first bitstream (prometheus/tsdb bstream)."""

    __slots__ = ("val", "nbits", "pos")

    def __init__(self, data: bytes):
        self.val = int.from_bytes(data, "big")
        self.nbits = len(data) * 8
        self.pos = 0

    def bits(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.val >> (self.nbits - p - n)) & ((1 << n) - 1)

    def bit(self) -> int:
        return self.bits(1)


def decode_xor_chunk(data: bytes):
    """(ts int64[], vals float64[]) from one XOR chunk payload."""
    n = struct.unpack_from(">H", data, 0)[0]
    ts = np.empty(n, np.int64)
    vals = np.empty(n, np.float64)
    if n == 0:
        return ts, vals
    # first sample: varint t, raw 64-bit v (byte-aligned prefix)
    t0, i = _varint(data, 2)
    v0 = struct.unpack_from(">d", data, i)[0]
    i += 8
    ts[0] = t0
    vals[0] = v0
    if n == 1:
        return ts, vals
    # second sample: uvarint tDelta, then the value bitstream begins
    t_delta, i = _uvarint(data, i)
    br = _BitReader(data[i:])
    t = t0 + t_delta
    ts[1] = t
    leading = trailing = 0
    vbits = struct.unpack(">Q", struct.pack(">d", v0))[0]

    def read_value():
        nonlocal vbits, leading, trailing
        if br.bit() == 0:
            return
        if br.bit():
            leading = br.bits(5)
            mbits = br.bits(6) or 64
            trailing = 64 - leading - mbits
        mbits = 64 - leading - trailing
        vbits ^= br.bits(mbits) << trailing

    read_value()
    vals[1] = struct.unpack(">d", struct.pack(">Q", vbits))[0]
    for k in range(2, n):
        # timestamp dod prefix code
        if br.bit() == 0:
            dod = 0
        elif br.bit() == 0:
            dod = _sign_extend(br.bits(14), 14)
        elif br.bit() == 0:
            dod = _sign_extend(br.bits(17), 17)
        elif br.bit() == 0:
            dod = _sign_extend(br.bits(20), 20)
        else:
            dod = _sign_extend(br.bits(64), 64)
        t_delta += dod
        t += t_delta
        ts[k] = t
        read_value()
        vals[k] = struct.unpack(">d", struct.pack(">Q", vbits))[0]
    return ts, vals


def _sign_extend(bits: int, n: int) -> int:
    # prometheus quirk: `> (1 << (n-1))`, so -2^(n-1) is never produced
    if bits > (1 << (n - 1)):
        bits -= 1 << n
    return bits


# -- index / chunks reading -------------------------------------------------

class TSDBBlock:
    """One opened block directory.

    `verify_index=True` additionally checks the index CRCs (TOC, symbol
    table, each series entry) — the verify-block mode; plain reads skip
    them for speed."""

    def __init__(self, path: str, verify_index: bool = False):
        self.path = path
        self.verify_index = verify_index
        self.meta = {}
        mp = os.path.join(path, "meta.json")
        if os.path.exists(mp):
            self.meta = json.load(open(mp))
        self._index = open(os.path.join(path, "index"), "rb").read()
        self._segments: list[bytes] = []
        cdir = os.path.join(path, "chunks")
        for name in sorted(os.listdir(cdir)):
            self._segments.append(
                open(os.path.join(cdir, name), "rb").read())
        self._symbols: list[str] = []
        self._toc = None
        self._parse_header()

    def _parse_header(self):
        ix = self._index
        magic, ver = struct.unpack_from(">IB", ix, 0)
        if magic != INDEX_MAGIC:
            raise ValueError(f"bad index magic {magic:#x}")
        if ver != 2:
            # v1 label refs are byte offsets into the symbol section, not
            # table indexes — decoding them with v2 semantics would pair
            # labels arbitrarily; reject loudly instead
            raise ValueError(f"unsupported index version {ver} (only v2)")
        # TOC: 6 x u64 + crc32 at the tail
        if self.verify_index:
            want = struct.unpack_from(">I", ix, len(ix) - 4)[0]
            if crc32c(ix[len(ix) - 52:len(ix) - 4]) != want:
                raise ValueError("index TOC crc mismatch")
        toc = struct.unpack_from(">6Q", ix, len(ix) - 52)
        self._toc = {
            "symbols": toc[0], "series": toc[1],
            "label_indices": toc[2], "label_offset_table": toc[3],
            "postings": toc[4], "postings_offset_table": toc[5],
        }
        # symbol table: u32 len, u32 count, then uvarint-prefixed strings
        off = self._toc["symbols"]
        _len, cnt = struct.unpack_from(">II", ix, off)
        if self.verify_index:
            want = struct.unpack_from(">I", ix, off + 4 + _len)[0]
            if crc32c(ix[off + 4:off + 4 + _len]) != want:
                raise ValueError("index symbol-table crc mismatch")
        i = off + 8
        syms = []
        for _ in range(cnt):
            n, i = _uvarint(ix, i)
            syms.append(ix[i:i + n].decode("utf-8", "replace"))
            i += n
        self._symbols = syms

    def series(self):
        """Yield (labels dict, [(mint, maxt, chunk_ref), ...])."""
        ix = self._index
        pos = self._toc["series"]
        end = self._toc["label_indices"] or (len(ix) - 52)
        syms = self._symbols
        while pos < end:
            pos = (pos + 15) // 16 * 16  # entries are 16-byte aligned
            if pos >= end:
                break
            ln, i = _uvarint(ix, pos)
            if ln == 0:
                break  # zero padding: end of section
            body_end = i + ln
            if self.verify_index:
                want = struct.unpack_from(">I", ix, body_end)[0]
                if crc32c(ix[i:body_end]) != want:
                    raise ValueError(
                        f"index series entry crc mismatch at {pos}")
            nlabels, i = _uvarint(ix, i)
            labels = {}
            for _ in range(nlabels):
                kref, i = _uvarint(ix, i)
                vref, i = _uvarint(ix, i)
                labels[syms[kref]] = syms[vref]
            nchunks, i = _uvarint(ix, i)
            chunks = []
            if nchunks:
                mint, i = _varint(ix, i)
                span, i = _uvarint(ix, i)
                ref, i = _uvarint(ix, i)
                chunks.append((mint, mint + span, ref))
                prev_maxt = mint + span
                for _ in range(nchunks - 1):
                    dmint, i = _varint(ix, i)
                    span, i = _uvarint(ix, i)
                    dref, i = _varint(ix, i)
                    mint = prev_maxt + dmint
                    ref += dref
                    chunks.append((mint, mint + span, ref))
                    prev_maxt = mint + span
            yield labels, chunks
            pos = body_end + 4  # + crc32

    def read_chunk(self, ref: int, verify_crc: bool = False):
        """Decode the chunk at `ref` (= segment << 32 | offset)."""
        seg = self._segments[ref >> 32]
        off = ref & 0xFFFFFFFF
        ln, i = _uvarint(seg, off)
        enc = seg[i]
        data = seg[i + 1:i + 1 + ln]
        if verify_crc:
            want = struct.unpack_from(">I", seg, i + 1 + ln)[0]
            got = crc32c(seg[i:i + 1 + ln])
            if got != want:
                raise ValueError(
                    f"chunk crc mismatch at ref {ref:#x}")
        if enc != 1:
            raise ValueError(f"unsupported chunk encoding {enc}")
        return decode_xor_chunk(data)


def read_block(path: str, verify_crc: bool = False,
               on_unsupported=None):
    """Yield (labels dict, ts_ms int64[], values float64[]) per series.

    `on_unsupported(labels, error)` is called for series whose chunks use
    an unsupported encoding (e.g. native-histogram chunks, encoding 2/3);
    those series are SKIPPED instead of aborting a migration mid-block.
    Pass None to raise instead."""
    blk = TSDBBlock(path)
    for labels, chunks in blk.series():
        if not chunks:
            continue
        try:
            parts = [blk.read_chunk(ref, verify_crc)
                     for _, _, ref in chunks]
        except ValueError as e:
            if on_unsupported is None:
                raise
            on_unsupported(labels, e)
            continue
        ts = np.concatenate([p[0] for p in parts])
        vals = np.concatenate([p[1] for p in parts])
        yield labels, ts, vals


def verify_block(path: str) -> dict:
    """Walk every structure + CRC; returns a report dict (the reference
    vmctl verify-block mode, app/vmctl/main.go:514)."""
    report = {"path": path, "ok": True, "errors": [],
              "series": 0, "chunks": 0, "samples": 0,
              "min_ts": None, "max_ts": None}
    try:
        blk = TSDBBlock(path, verify_index=True)
    except (OSError, ValueError, KeyError, struct.error) as e:
        report["ok"] = False
        report["errors"].append(f"cannot open block: {e}")
        return report
    def _series_iter():
        # an index-crc failure aborts the series walk; record it rather
        # than crashing the report
        try:
            yield from blk.series()
        except (ValueError, IndexError, struct.error) as e:
            report["ok"] = False
            report["errors"].append(f"index: {e}")

    for labels, chunks in _series_iter():
        report["series"] += 1
        if not labels.get("__name__"):
            report["ok"] = False
            report["errors"].append(f"series without __name__: {labels}")
        prev_t = None
        for mint, maxt, ref in chunks:
            report["chunks"] += 1
            try:
                ts, vals = blk.read_chunk(ref, verify_crc=True)
            except (ValueError, IndexError, struct.error) as e:
                report["ok"] = False
                report["errors"].append(f"chunk {ref:#x}: {e}")
                continue
            report["samples"] += int(ts.size)
            if ts.size:
                if not bool((np.diff(ts) >= 0).all()):
                    report["ok"] = False
                    report["errors"].append(
                        f"chunk {ref:#x}: timestamps out of order")
                if prev_t is not None and ts[0] < prev_t:
                    report["ok"] = False
                    report["errors"].append(
                        f"chunk {ref:#x}: overlaps previous chunk")
                prev_t = int(ts[-1])
                lo, hi = int(ts[0]), int(ts[-1])
                report["min_ts"] = (lo if report["min_ts"] is None
                                    else min(report["min_ts"], lo))
                report["max_ts"] = (hi if report["max_ts"] is None
                                    else max(report["max_ts"], hi))
                if int(mint) > lo or int(maxt) < hi:
                    report["ok"] = False
                    report["errors"].append(
                        f"chunk {ref:#x}: index time range "
                        f"[{mint},{maxt}] does not cover data")
    return report


# -- minimal writer (tests / fixtures) --------------------------------------

class _BitWriter:
    __slots__ = ("buf", "acc", "nacc")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nacc = 0

    def bits(self, v: int, n: int):
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)

    def done(self) -> bytes:
        if self.nacc:
            self.buf.append((self.acc << (8 - self.nacc)) & 0xFF)
            self.nacc = 0
        return bytes(self.buf)


def encode_xor_chunk(ts: np.ndarray, vals: np.ndarray) -> bytes:
    """Inverse of decode_xor_chunk (used to build test fixtures)."""
    n = int(ts.size)
    out = bytearray(struct.pack(">H", n))
    if n == 0:
        return bytes(out)
    out += _put_varint(int(ts[0]))
    out += struct.pack(">d", float(vals[0]))
    if n == 1:
        return bytes(out)
    t_delta = int(ts[1]) - int(ts[0])
    out += _put_uvarint(t_delta)
    bw = _BitWriter()
    leading, trailing = 0xFF, 0
    prev_bits = struct.unpack(">Q", struct.pack(">d", float(vals[0])))[0]

    def write_value(v: float):
        nonlocal prev_bits, leading, trailing
        bits = struct.unpack(">Q", struct.pack(">d", float(v)))[0]
        x = prev_bits ^ bits
        prev_bits = bits
        if x == 0:
            bw.bits(0, 1)
            return
        bw.bits(1, 1)
        lead = _clz64(x)
        trail = _ctz64(x)
        if lead > 31:
            lead = 31
        if leading != 0xFF and lead >= leading and trail >= trailing:
            bw.bits(0, 1)
            bw.bits(x >> trailing, 64 - leading - trailing)
        else:
            leading, trailing = lead, trail
            bw.bits(1, 1)
            bw.bits(lead, 5)
            mbits = 64 - lead - trail
            bw.bits(mbits & 0x3F, 6)  # 64 encodes as 0
            bw.bits(x >> trail, mbits)

    write_value(float(vals[1]))
    prev_delta = t_delta
    for k in range(2, n):
        delta = int(ts[k]) - int(ts[k - 1])
        dod = delta - prev_delta
        prev_delta = delta
        if dod == 0:
            bw.bits(0, 1)
        elif -8191 <= dod <= 8192:
            bw.bits(0b10, 2)
            bw.bits(dod & 0x3FFF, 14)
        elif -65535 <= dod <= 65536:
            bw.bits(0b110, 3)
            bw.bits(dod & 0x1FFFF, 17)
        elif -524287 <= dod <= 524288:
            bw.bits(0b1110, 4)
            bw.bits(dod & 0xFFFFF, 20)
        else:
            bw.bits(0b1111, 4)
            bw.bits(dod & ((1 << 64) - 1), 64)
        write_value(float(vals[k]))
    return bytes(out) + bw.done()


def _clz64(x: int) -> int:
    return 64 - x.bit_length()


def _ctz64(x: int) -> int:
    return (x & -x).bit_length() - 1 if x else 64


def write_block(path: str, series) -> None:
    """Write a minimal v2 TSDB block: series = [(labels dict, ts, vals)].
    Fixture-grade (no postings/label indices beyond empty sections) but
    byte-compatible with read_block/verify_block and the real format for
    the sections it emits."""
    os.makedirs(os.path.join(path, "chunks"), exist_ok=True)
    # chunks segment
    seg = bytearray(struct.pack(">IB3x", CHUNKS_MAGIC, 1))
    refs = []
    for labels, ts, vals in series:
        data = encode_xor_chunk(np.asarray(ts, np.int64),
                                np.asarray(vals, np.float64))
        body = bytes([1]) + data  # crc covers encoding + data only
        refs.append(len(seg))
        seg += _put_uvarint(len(data)) + body + \
            struct.pack(">I", crc32c(body))
    with open(os.path.join(path, "chunks", "000001"), "wb") as f:
        f.write(seg)
    # symbols
    symset = set()
    for labels, _, _ in series:
        for k, v in labels.items():
            symset.add(k)
            symset.add(v)
    syms = sorted(symset)
    sym_of = {s: i for i, s in enumerate(syms)}
    sym_body = struct.pack(">I", len(syms))
    for s in syms:
        b = s.encode()
        sym_body += _put_uvarint(len(b)) + b
    index = bytearray(struct.pack(">IB", INDEX_MAGIC, 2))
    toc_symbols = len(index)
    index += struct.pack(">I", len(sym_body)) + sym_body
    index += struct.pack(">I", crc32c(sym_body))
    # series section, 16-byte aligned entries
    toc_series = (len(index) + 15) // 16 * 16
    index += b"\x00" * (toc_series - len(index))
    min_t = None
    max_t = None
    for (labels, ts, vals), ref in zip(series, refs):
        ts = np.asarray(ts, np.int64)
        body = _put_uvarint(len(labels))
        for k in sorted(labels):
            body += _put_uvarint(sym_of[k]) + _put_uvarint(sym_of[labels[k]])
        body += _put_uvarint(1)  # one chunk per series
        mint, maxt = int(ts[0]), int(ts[-1])
        min_t = mint if min_t is None else min(min_t, mint)
        max_t = maxt if max_t is None else max(max_t, maxt)
        body += _put_varint(mint)
        body += _put_uvarint(maxt - mint)
        body += _put_uvarint(ref)
        pos = (len(index) + 15) // 16 * 16
        index += b"\x00" * (pos - len(index))
        entry = _put_uvarint(len(body)) + body
        index += entry + struct.pack(">I", crc32c(body))
    toc_label_indices = len(index)
    # TOC (empty offsets for sections we do not emit)
    toc = struct.pack(">6Q", toc_symbols, toc_series, toc_label_indices,
                      0, 0, 0)
    index += toc + struct.pack(">I", crc32c(toc))
    with open(os.path.join(path, "index"), "wb") as f:
        f.write(index)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"version": 1, "minTime": min_t, "maxTime": max_t,
                   "stats": {"numSeries": len(series)}}, f)
