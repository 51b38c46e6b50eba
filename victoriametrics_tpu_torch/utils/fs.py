"""Durable-filesystem helpers (reference lib/fs/fs.go:71,182).

The storage engine's whole crash story rests on write-to-tmp -> fsync ->
atomic rename.  The rename itself is NOT durable until the parent
directory's entry table is fsynced: a crash after ``os.rename`` but
before the directory metadata reaches disk can resurrect the old
directory listing, un-publishing a part that was already acknowledged.
:func:`fsync_dir` is that missing fsync, shared by the partition,
mergeset and snapshot paths (the MustSyncPath analog).

File checksums (crc32 of each payload file, recorded in the part's
``metadata.json`` at finalize) close the other half: a torn or
bit-flipped part is detected at open and quarantined loudly instead of
misparsing or silently vanishing from serving.

The port's copy of ``victoriametrics_tpu/utils/fs.py``, whole.
"""

from __future__ import annotations

import json
import os
import zlib

_CHUNK = 1 << 20


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-renamed entry inside it is durable
    (fs.go MustSyncPath on the parent dir).  Raises OSError on failure —
    a rename whose durability cannot be established must not be treated
    as committed."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def rename_durable(src: str, dst: str) -> None:
    """os.replace + parent-dir fsync: the atomic-publish idiom every
    finalize path uses (rename alone is atomic but not durable).  When
    src is a directory its OWN entry table is fsynced first — the files
    inside were fsynced individually, but the directory entries naming
    them were not, and a power loss could otherwise persist the rename
    while losing a child entry."""
    if os.path.isdir(src):
        fsync_dir(src)
    os.replace(src, dst)
    fsync_dir(os.path.dirname(dst) or ".")


def checksum_file(path: str) -> int:
    """crc32 of a whole file (streamed; parts can be large)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


class IntegrityError(ValueError):
    """A part file's bytes do not match the checksums recorded at
    finalize (torn write, bit rot, truncation).  Openers quarantine the
    part instead of serving — or silently dropping — corrupt data."""


def meta_crc(meta: dict) -> int:
    """Self-checksum of a metadata dict (everything except the
    ``meta_crc`` field itself, canonically serialized): catches bit
    flips inside metadata.json, which the per-file checksums it carries
    cannot cover."""
    body = {k: v for k, v in meta.items() if k != "meta_crc"}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode())


def write_meta_json(path: str, meta: dict) -> None:
    """Write metadata.json with its self-crc, fsynced (callers rename
    the enclosing tmp dir afterwards)."""
    meta = dict(meta)
    meta["meta_crc"] = meta_crc(meta)
    with open(path, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())


def verify_enabled() -> bool:
    """Checksum verification at part open (default ON; VM_VERIFY_PARTS=0
    opts out for benchmarking the raw open path)."""
    return os.environ.get("VM_VERIFY_PARTS", "1") not in ("0", "")


def load_meta_json(path: str) -> dict:
    """Read + self-verify metadata.json; raises IntegrityError when the
    recorded meta_crc does not match (bit flip inside the metadata
    itself).  Metadata written before checksums existed (no meta_crc
    field) loads unverified."""
    with open(path) as f:
        meta = json.load(f)
    rec = meta.get("meta_crc")
    if rec is not None and verify_enabled() and rec != meta_crc(meta):
        raise IntegrityError(f"{path}: metadata self-checksum mismatch")
    return meta


#: subdir (inside a partition / mergeset table dir) holding parts that
#: failed the open-time integrity check — kept for forensics/restore,
#: never served, never mistaken for a crash leftover by cleanup sweeps
QUARANTINE_DIR = "quarantine"


def quarantine_dir_entry(parent: str, name: str, err,
                         store: str, where: str) -> dict:
    """Move ``parent/name`` into ``parent/quarantine/`` (same-fs rename;
    a suffix disambiguates repeat quarantines of one name) and return
    the report entry /api/v1/status/quarantine serves."""
    from . import logger
    qdir = os.path.join(parent, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, name)
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(qdir, f"{name}.{n}")
    os.rename(os.path.join(parent, name), dst)
    try:
        fsync_dir(parent)
    except OSError:
        pass  # the move is advisory bookkeeping; never fail open on it
    logger.errorf("%s %s: QUARANTINED part %s -> %s: %s",
                  store, where, name, dst, err)
    return {"store": store, "in": where, "part": name, "path": dst,
            "error": str(err)}


def resident_quarantine_entries(parent: str, store: str,
                                where: str) -> list[dict]:
    """Report entries for parts quarantined by a PREVIOUS open (the
    quarantine dir's residents): a restart must keep serving loudly
    partial until the operator restores or deletes them.  Shared by the
    partition and mergeset openers so the report schema and operator
    guidance cannot drift between stores."""
    qdir = os.path.join(parent, QUARANTINE_DIR)
    if not os.path.isdir(qdir):
        return []
    return [{"store": store, "in": where, "part": n,
             "path": os.path.join(qdir, n),
             "error": "quarantined by a previous open; restore from a "
                      "replica/snapshot or delete the quarantine dir to "
                      "accept the loss"}
            for n in sorted(os.listdir(qdir))]


def verify_checksums(part_dir: str, meta: dict) -> None:
    """Verify every file checksum recorded in ``meta['checksums']``
    against the bytes on disk; raises IntegrityError on the first
    mismatch (missing file included).  Parts finalized before checksums
    existed carry no map and verify trivially."""
    sums = meta.get("checksums")
    if not sums or not verify_enabled():
        return
    for name, want in sums.items():
        full = os.path.join(part_dir, name)
        try:
            got = checksum_file(full)
        except OSError as e:
            # on-disk corruption is a TRUE internal error: there is no
            # typed status that makes it the client's problem, so the
            # boundary's anonymous 500/error frame is the contract
            raise IntegrityError(  # vmt: disable=VMT016
                f"{part_dir}: cannot checksum {name}: {e}") from None
        if got != want:
            raise IntegrityError(  # vmt: disable=VMT016 — corruption = 500
                f"{part_dir}: checksum mismatch on {name} "
                f"(recorded {want}, computed {got}) — torn or corrupt")
