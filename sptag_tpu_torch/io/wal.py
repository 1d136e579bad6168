"""Write-ahead log: every acked add/delete survives process death (port
of ``sptag_tpu/io/wal.py``; the bytes are identical, so a log written by
either package replays in the other).

The reference mutates in memory and persists only at SaveIndex: a crash
between an acked AddIndex and the next save silently loses the write.
Here a VectorIndex with ``WalEnabled=1`` and a home folder appends one
checksummed record per acked mutation to ``wal.bin`` (fsync'd before the
ack when ``WalFsync=1``), and ``load_index`` replays the log over the
loaded snapshot — the acked state is reconstructed exactly.

Layout (little-endian throughout, like io/format.py):

* file header: ``b"SPWL"`` + u32 version (8 bytes);
* record: u32 payload length, u32 CRC32(payload), payload;
* payload: u8 op, then op-specific —
  ``OP_ADD``: u64 begin (the global id rows[0] landed at), u32 rows,
  u32 dim, u8 dtype-string length + ascii numpy dtype, raw row bytes,
  u8 has-metadata, then per-row u32 length + bytes when present;
  ``OP_DELETE``: u32 count, count × u64 tombstoned vids.

Torn-tail contract: replay parses records until the first one whose
length runs past EOF or whose CRC fails, TRUNCATES the file there (the
torn record was never acked — its append raised before returning), and
returns the good prefix.  Replay is idempotent against the snapshot via
``begin``: a record whose rows are already inside the loaded snapshot
(begin + rows <= n) is skipped, so the crash window "snapshot published,
WAL not yet reset" double-applies nothing.

Fault sites (utils/faultinject.py storage kinds, ``SPTAG_FAULTINJECT``):
``wal.append`` (``torn_write`` / ``crash``, per record) and ``wal.read``
(``short_read``), the sites of the deterministic crash-recovery matrix.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np

from sptag_tpu_torch.utils import faultinject

log = logging.getLogger(__name__)

#: WAL file name inside an index folder
WAL_NAME = "wal.bin"

_MAGIC = b"SPWL"
_VERSION = 1
_HEADER = _MAGIC + struct.pack("<I", _VERSION)

OP_ADD = 1
OP_DELETE = 2


class WalAdd:
    __slots__ = ("begin", "rows", "metas")

    def __init__(self, begin: int, rows: np.ndarray,
                 metas: Optional[List[bytes]]):
        self.begin = begin
        self.rows = rows
        self.metas = metas


class WalDelete:
    __slots__ = ("vids",)

    def __init__(self, vids: List[int]):
        self.vids = vids


WalRecord = Union[WalAdd, WalDelete]


def pack_add(begin: int, rows: np.ndarray,
             metas: Optional[List[bytes]]) -> bytes:
    rows = np.ascontiguousarray(rows)
    dt = rows.dtype.str.encode("ascii")
    out = [struct.pack("<BQII", OP_ADD, begin, rows.shape[0],
                       rows.shape[1]),
           struct.pack("<B", len(dt)), dt, rows.tobytes(),
           struct.pack("<B", 1 if metas is not None else 0)]
    if metas is not None:
        for m in metas:
            m = bytes(m)
            out.append(struct.pack("<I", len(m)))
            out.append(m)
    return b"".join(out)


def pack_delete(vids: List[int]) -> bytes:
    return struct.pack("<BI", OP_DELETE, len(vids)) + b"".join(
        struct.pack("<Q", int(v)) for v in vids)


def _decode(payload: bytes) -> WalRecord:
    op = payload[0]
    if op == OP_ADD:
        _, begin, nrows, dim = struct.unpack_from("<BQII", payload, 0)
        off = struct.calcsize("<BQII")
        (dtlen,) = struct.unpack_from("<B", payload, off)
        off += 1
        dt = np.dtype(payload[off:off + dtlen].decode("ascii"))
        off += dtlen
        nbytes = nrows * dim * dt.itemsize
        rows = np.frombuffer(payload, dt, nrows * dim,
                             off).reshape(nrows, dim).copy()
        off += nbytes
        (has_meta,) = struct.unpack_from("<B", payload, off)
        off += 1
        metas = None
        if has_meta:
            metas = []
            for _ in range(nrows):
                (mlen,) = struct.unpack_from("<I", payload, off)
                off += 4
                metas.append(payload[off:off + mlen])
                off += mlen
        return WalAdd(begin, rows, metas)
    if op == OP_DELETE:
        _, count = struct.unpack_from("<BI", payload, 0)
        off = struct.calcsize("<BI")
        vids = [struct.unpack_from("<Q", payload, off + 8 * i)[0]
                for i in range(count)]
        return WalDelete(vids)
    raise ValueError(f"unknown WAL op {op}")


class WalWriter:
    """Append-only, checksummed, fsync'd log handle.

    An append that RETURNS is durable (modulo ``sync=False``, the
    operator's explicit throughput-for-durability trade); an append
    that raises was never acked and its bytes — torn or absent — are
    truncated away by the next replay."""

    def __init__(self, path: str, sync: bool = True):
        self.path = path
        self.sync = sync
        self.appended = 0
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_HEADER)
            self._flush()

    def _flush(self) -> None:
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())

    def append(self, payload: bytes) -> None:
        rec = struct.pack("<II", len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF) + payload
        fault = faultinject.storage_fault("wal.append")
        if fault is not None:
            if fault.kind == "crash":
                raise faultinject.InjectedCrash("wal.append")
            if fault.kind == "torn_write":
                self._f.write(rec[: max(1, len(rec) // 2)])
                # a durable torn prefix, then the "death" (io/atomic.py
                # _TearingFile)
                self._f.flush()
                os.fsync(self._f.fileno())
                raise faultinject.InjectedCrash("wal.append")
        self._f.write(rec)
        self._flush()
        self.appended += 1

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            log.warning("WAL close failed for %s", self.path,
                        exc_info=True)


def create_empty(path: str) -> None:
    """Write a fresh header-only WAL (the staged-save companion: a
    published snapshot carries an empty log — its records are folded
    into the blobs it ships with)."""
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.flush()
        os.fsync(f.fileno())


def replay(path: str, truncate: bool = True
           ) -> Tuple[List[WalRecord], bool]:
    """Parse `path` into records; returns ``(records, torn)``.

    On the first torn/corrupt record the file is truncated there (the
    bytes were never acked) and parsing stops.  A missing file is an
    empty log.  A file whose HEADER is unreadable is treated as wholly
    torn — truncated to a fresh header, zero records."""
    if not os.path.exists(path):
        return [], False
    with open(path, "rb") as f:
        raw = f.read()
    fault = faultinject.storage_fault("wal.read")
    if fault is not None and fault.kind == "short_read":
        raw = raw[: len(raw) // 2]
    if raw[:len(_HEADER)] != _HEADER:
        log.warning("WAL %s: bad header; treating as empty", path)
        if truncate:
            create_empty(path)
        return [], True
    records: List[WalRecord] = []
    off = len(_HEADER)
    good = off
    torn = False
    while off + 8 <= len(raw):
        length, crc = struct.unpack_from("<II", raw, off)
        end = off + 8 + length
        if end > len(raw):
            torn = True
            break
        payload = raw[off + 8:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            torn = True
            break
        try:
            records.append(_decode(payload))
        except (ValueError, struct.error, IndexError):
            log.warning("WAL %s: undecodable record at offset %d; "
                        "truncating", path, off, exc_info=True)
            torn = True
            break
        off = end
        good = off
    if off != len(raw):
        torn = True
    if torn and truncate:
        with open(path, "r+b") as f:
            f.truncate(good)
            f.flush()
            os.fsync(f.fileno())
        log.warning("WAL %s: torn tail truncated at offset %d "
                    "(%d good records)", path, good, len(records))
    return records, torn
