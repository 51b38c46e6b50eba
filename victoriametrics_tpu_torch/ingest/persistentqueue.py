"""Crash-safe FIFO queue: in-RAM fast path spilling to disk chunk files
(reference lib/persistentqueue/{fastqueue,persistentqueue}.go:33-640).

Blocks (byte strings) are appended to chunk files as u32-length-prefixed
records; metainfo.json tracks the reader position. Corrupted trailing
records (crash mid-write) are skipped on open (skipBrokenChunkFile
analog). The in-RAM deque front avoids disk I/O while the consumer keeps
up; memory pressure spills to disk.

The port's copy of ``victoriametrics_tpu/ingest/persistentqueue.py``,
whole.
"""

from __future__ import annotations

import collections
import json
import os
import struct
import threading

_U32 = struct.Struct("<I")
CHUNK_MAX_BYTES = 16 << 20


class PersistentQueue:
    def __init__(self, path: str, max_inmemory_blocks: int = 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Condition()
        self._mem: collections.deque[bytes] = collections.deque()
        self._max_mem = max_inmemory_blocks
        self._meta_path = os.path.join(path, "metainfo.json")
        self._read_chunk = 0
        self._read_off = 0
        self._write_chunk = 0
        self._write_f = None
        self._load_meta()
        self._stopped = False

    # -- persistence -----------------------------------------------------

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.path, f"chunk_{idx:010d}")

    def _load_meta(self):
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                m = json.load(f)
            self._read_chunk = m.get("read_chunk", 0)
            self._read_off = m.get("read_off", 0)
        chunks = sorted(int(n.split("_")[1]) for n in os.listdir(self.path)
                        if n.startswith("chunk_"))
        self._write_chunk = (chunks[-1] if chunks else self._read_chunk)
        # drop chunks older than the read position (already consumed)
        for c in chunks:
            if c < self._read_chunk:
                os.unlink(self._chunk_path(c))

    def _save_meta(self):
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"read_chunk": self._read_chunk,
                       "read_off": self._read_off}, f)
        os.replace(tmp, self._meta_path)

    def _open_write_chunk_locked(self):
        if self._write_f is None:
            self._write_f = open(self._chunk_path(self._write_chunk), "ab")
        elif self._write_f.tell() >= CHUNK_MAX_BYTES:
            self._write_f.close()
            self._write_chunk += 1
            self._write_f = open(self._chunk_path(self._write_chunk), "ab")

    def _write_block_to_disk(self, block: bytes):
        self._open_write_chunk_locked()
        self._write_f.write(_U32.pack(len(block)) + block)
        self._write_f.flush()

    def _read_block_from_disk(self) -> bytes | None:
        while self._read_chunk <= self._write_chunk:
            p = self._chunk_path(self._read_chunk)
            if not os.path.exists(p):
                self._read_chunk += 1
                self._read_off = 0
                continue
            with open(p, "rb") as f:
                f.seek(self._read_off)
                hdr = f.read(4)
                if len(hdr) < 4:
                    # end of chunk (or truncated crash tail)
                    if self._read_chunk < self._write_chunk:
                        os.unlink(p)
                        self._read_chunk += 1
                        self._read_off = 0
                        continue
                    return None
                n = _U32.unpack(hdr)[0]
                data = f.read(n)
                if len(data) < n:
                    # crash mid-write: skip the broken tail
                    if self._read_chunk < self._write_chunk:
                        os.unlink(p)
                        self._read_chunk += 1
                        self._read_off = 0
                        continue
                    return None
                self._read_off = f.tell()
                self._save_meta()
                return data
        return None

    # -- API ---------------------------------------------------------------

    def put(self, block: bytes) -> None:
        with self._lock:
            if not self._disk_pending() and len(self._mem) < self._max_mem:
                self._mem.append(block)
            else:
                # preserve FIFO: once anything is on disk, everything goes
                # through disk
                while self._mem:
                    self._write_block_to_disk(self._mem.popleft())
                self._write_block_to_disk(block)
            self._lock.notify()

    def _disk_pending(self) -> bool:
        if self._write_f is not None and (
                self._read_chunk < self._write_chunk or
                self._read_off < self._write_f.tell()):
            return True
        return False

    def get(self, timeout: float | None = None) -> bytes | None:
        with self._lock:
            if not self._mem and not self._disk_pending():
                self._lock.wait(timeout)
            if self._mem:
                return self._mem.popleft()
            return self._read_block_from_disk()

    def flush_to_disk(self):
        """Persist the RAM front (shutdown path)."""
        with self._lock:
            while self._mem:
                self._write_block_to_disk(self._mem.popleft())
            if self._write_f:
                self._write_f.flush()
                os.fsync(self._write_f.fileno())
            self._save_meta()

    def close(self):
        self.flush_to_disk()
        with self._lock:
            if self._write_f:
                self._write_f.close()
                self._write_f = None

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._mem) + (1 if self._disk_pending() else 0)
