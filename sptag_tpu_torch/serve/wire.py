"""Wire protocol — byte-compatible with the reference socket stack.

Parity targets (all under AnnService/):

* Packet framing: 16-byte header {u8 type, u8 status, u32 bodyLength,
  u32 connectionID, u32 resourceID, 2B pad} (inc/Socket/Packet.h:52-76,
  src/Socket/Packet.cpp:41-66; header buffer is c_bufferSize=16 while the
  serialized fields occupy 14).
* PacketType/ResponseMask values (inc/Socket/Packet.h:20-37) and
  PacketProcessStatus (:40-48).
* SimpleSerialization conventions (inc/Socket/SimpleSerialization.h:21-168):
  POD little-endian, strings/bytes as u32 length + payload.
* RemoteQuery / RemoteSearchResult bodies incl. the u16 version prologue
  (inc/Socket/RemoteSearchQuery.h:23-92, src/Socket/RemoteSearchQuery.cpp:
  11-210).

A C++ reference client can talk to this server and vice versa — the framing
and bodies are bit-identical on x86 (little-endian).

Framework extension (observability): RemoteQuery / RemoteSearchResult may
carry a REQUEST ID, appended as one extra length-prefixed string after the
reference fields and signalled by bumping the minor ("mirror") version to
1.  A body without an id packs byte-identically to the reference (minor 0,
no trailer), and unpack accepts both — so reference peers interoperate
unchanged while this stack's edges (client / aggregator) mint an id that
rides every hop and comes back in the response (the text protocol's
`$requestid:` option is the equivalent channel for clients that cannot
set the body field).

Framework extension (overload defense, minor version 2): a RemoteQuery
may additionally carry a DEADLINE — milliseconds of budget REMAINING at
send time (relative, never wall clock: peers' clocks are not assumed
synchronized; each receiver re-anchors at its own arrival).  The
aggregator decrements it before fanning out so shards can drop work the
client has already given up on.  A RemoteSearchResult may carry MARKER
strings — currently ``degraded``, stamped when admission control clamped
the query's budget — as a count-prefixed string list.  Both trailers
follow the request-id string (which packs even when empty at minor 2, to
keep the trailer positional) and are signalled by minor version 2; a
body without them packs exactly as before (minor 0/1), and a minor-1
peer reading a minor-2 body consumes the id and ignores the rest, so
every direction of version skew interoperates.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import struct
import uuid
from typing import List, Optional, Tuple

log = logging.getLogger(__name__)

HEADER_SIZE = 16
INVALID_CONNECTION_ID = 0
INVALID_RESOURCE_ID = 0

#: hard ceiling on a packet's declared body size, shared by EVERY reader
#: of the framing (server, aggregator backend pump, clients).  The
#: header's body_length is peer-controlled; without a cap one hostile or
#: garbled 16-byte header makes readexactly()/recv loops buffer multi-GB.
#: 64 MiB comfortably covers the largest legitimate body.
MAX_BODY_LENGTH = 64 << 20

_HEADER_STRUCT = struct.Struct("<BBIII2x")
_U32 = struct.Struct("<I")
_U16X2_U8 = struct.Struct("<HHB")
_VID_DIST = struct.Struct("<if")


class PacketType(enum.IntEnum):
    Undefined = 0x00
    HeartbeatRequest = 0x01
    RegisterRequest = 0x02
    SearchRequest = 0x03
    ResponseMask = 0x80
    HeartbeatResponse = 0x81
    RegisterResponse = 0x82
    SearchResponse = 0x83


def is_request(ptype: int) -> bool:
    return 0 < ptype < PacketType.ResponseMask


def response_type(ptype: int) -> int:
    return ptype | PacketType.ResponseMask


class PacketProcessStatus(enum.IntEnum):
    Ok = 0x00
    Timeout = 0x01
    Dropped = 0x02
    Failed = 0x03


class ResultStatus(enum.IntEnum):
    """RemoteSearchResult::ResultStatus
    (inc/Socket/RemoteSearchQuery.h:61-72).  `Overloaded` is a framework
    extension: the admission controller's shed answer, distinct from
    every execution failure so clients/load-balancers can back off
    instead of retrying into the overload."""

    Success = 0
    Timeout = 1
    FailedNetwork = 2
    FailedExecute = 3
    Dropped = 4
    Overloaded = 5


#: RemoteSearchResult marker stamped on responses whose budget the
#: admission controller clamped (serve/admission.py degrade state)
MARKER_DEGRADED = "degraded"

#: hard ceiling on markers per result — the count prefix is peer-
#: controlled and must not drive an unbounded decode loop
MAX_MARKERS = 16


@dataclasses.dataclass
class PacketHeader:
    packet_type: int = PacketType.Undefined
    process_status: int = PacketProcessStatus.Ok
    body_length: int = 0
    connection_id: int = INVALID_CONNECTION_ID
    resource_id: int = INVALID_RESOURCE_ID

    def pack(self) -> bytes:
        return _HEADER_STRUCT.pack(self.packet_type, self.process_status,
                                   self.body_length, self.connection_id,
                                   self.resource_id)

    @classmethod
    def unpack(cls, buf: bytes) -> "PacketHeader":
        t, s, blen, cid, rid = _HEADER_STRUCT.unpack(buf[:HEADER_SIZE])
        return cls(t, s, blen, cid, rid)


def write_string(s) -> bytes:
    if isinstance(s, str):
        s = s.encode()
    return _U32.pack(len(s)) + bytes(s)


def read_string(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    if off + n > len(buf):
        # bytes slicing is lenient past end-of-buffer; a length prefix
        # pointing beyond the body is a truncated/hostile packet and must
        # fail decode, not silently deliver a shortened payload
        raise struct.error("string length %d exceeds buffer" % n)
    return bytes(buf[off:off + n]), off + n


def new_request_id() -> str:
    """Mint a request id at the edge (client / aggregator) — 16 hex chars,
    unique enough to trace one query across aggregator → shard logs."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class RemoteQuery:
    """inc/Socket/RemoteSearchQuery.h:23-46; version (1, 0), type String=0.

    `request_id` is the framework's traceability extension (module
    docstring): empty packs the exact reference bytes; non-empty bumps the
    minor version to MIRROR_RID and appends one trailing string.
    `deadline_ms` (> 0) is the overload-defense extension: milliseconds
    of budget remaining at send time, minor version MIRROR_EXT (the id
    string packs too, even when empty, so the trailer stays positional)."""

    query: str = ""
    query_type: int = 0
    request_id: str = ""
    deadline_ms: float = 0.0

    MAJOR = 1
    MIRROR = 0
    MIRROR_RID = 1            # minor version signalling a request-id trailer
    MIRROR_EXT = 2            # … plus the deadline trailer

    def pack(self) -> bytes:
        ext = self.deadline_ms > 0
        mirror = (self.MIRROR_EXT if ext
                  else self.MIRROR_RID if self.request_id else self.MIRROR)
        out = (_U16X2_U8.pack(self.MAJOR, mirror, self.query_type)
               + write_string(self.query))
        if mirror >= self.MIRROR_RID:
            out += write_string(self.request_id)
        if ext:
            out += write_string("%g" % self.deadline_ms)
        return out

    @classmethod
    def unpack(cls, buf: bytes) -> Optional["RemoteQuery"]:
        try:
            major, mirror, qtype = _U16X2_U8.unpack_from(buf, 0)
            if major != cls.MAJOR:
                return None
            q, off = read_string(buf, _U16X2_U8.size)
            rid = b""
            deadline_ms = 0.0
            if mirror >= cls.MIRROR_RID and off < len(buf):
                rid, off = read_string(buf, off)
            if mirror >= cls.MIRROR_EXT and off < len(buf):
                ds, off = read_string(buf, off)
                try:
                    deadline_ms = float(ds)
                except ValueError:
                    # unparsable deadline trailer = no deadline; the
                    # query itself is still valid
                    log.debug("unparsable deadline trailer %r", ds)
                    deadline_ms = 0.0
        except struct.error:
            return None       # truncated body — hostile peers send anything
        return cls(q.decode("utf-8", "replace"), qtype,
                   rid.decode("utf-8", "replace"),
                   deadline_ms if deadline_ms > 0 else 0.0)


@dataclasses.dataclass
class IndexSearchResult:
    """inc/Socket/RemoteSearchQuery.h:49-54."""

    index_name: str
    ids: List[int]
    dists: List[float]
    metas: Optional[List[bytes]] = None


@dataclasses.dataclass
class RemoteSearchResult:
    """inc/Socket/RemoteSearchQuery.h:57-92 — flat list of per-index result
    lists; the aggregator concatenates these without re-ranking
    (AggregatorService.cpp:316-366).  `request_id` echoes the query's id
    (same versioned-trailer scheme as RemoteQuery); `markers` is the
    minor-2 marker channel (module docstring) — currently only
    MARKER_DEGRADED rides it."""

    status: int = ResultStatus.Timeout
    results: List[IndexSearchResult] = dataclasses.field(default_factory=list)
    request_id: str = ""
    markers: List[str] = dataclasses.field(default_factory=list)

    MAJOR = 1
    MIRROR = 0
    MIRROR_RID = 1
    MIRROR_EXT = 2            # request id + marker-list trailer

    @property
    def degraded(self) -> bool:
        """True when admission control clamped this query's budget."""
        return MARKER_DEGRADED in self.markers

    def pack(self) -> bytes:
        ext = bool(self.markers)
        mirror = (self.MIRROR_EXT if ext
                  else self.MIRROR_RID if self.request_id else self.MIRROR)
        out = [_U16X2_U8.pack(self.MAJOR, mirror, self.status),
               _U32.pack(len(self.results))]
        for r in self.results:
            out.append(write_string(r.index_name))
            out.append(_U32.pack(len(r.ids)))
            with_meta = r.metas is not None
            out.append(struct.pack("<?", with_meta))
            for vid, dist in zip(r.ids, r.dists):
                out.append(_VID_DIST.pack(int(vid), float(dist)))
            if with_meta:
                for m in r.metas:
                    out.append(write_string(m))
        if mirror >= self.MIRROR_RID:
            out.append(write_string(self.request_id))
        if ext:
            out.append(_U32.pack(len(self.markers)))
            for m in self.markers:
                out.append(write_string(m))
        return b"".join(out)

    @classmethod
    def unpack(cls, buf: bytes) -> Optional["RemoteSearchResult"]:
        try:
            major, mirror, status = _U16X2_U8.unpack_from(buf, 0)
            if major != cls.MAJOR:
                return None
            off = _U16X2_U8.size
            (count,) = _U32.unpack_from(buf, off)
            off += 4
            results: List[IndexSearchResult] = []
            for _ in range(count):
                name, off = read_string(buf, off)
                (num,) = _U32.unpack_from(buf, off)
                off += 4
                (with_meta,) = struct.unpack_from("<?", buf, off)
                off += 1
                ids: List[int] = []
                dists: List[float] = []
                for _ in range(num):
                    vid, dist = _VID_DIST.unpack_from(buf, off)
                    off += _VID_DIST.size
                    ids.append(vid)
                    dists.append(dist)
                metas = None
                if with_meta:
                    metas = []
                    for _ in range(num):
                        m, off = read_string(buf, off)
                        metas.append(m)
                results.append(IndexSearchResult(
                    name.decode("utf-8", "replace"), ids, dists, metas))
            rid = b""
            markers: List[str] = []
            if mirror >= cls.MIRROR_RID and off < len(buf):
                rid, off = read_string(buf, off)
            if mirror >= cls.MIRROR_EXT and off < len(buf):
                (n_mark,) = _U32.unpack_from(buf, off)
                off += 4
                if n_mark > MAX_MARKERS:
                    return None   # hostile count — treat as malformed
                for _ in range(n_mark):
                    m, off = read_string(buf, off)
                    markers.append(m.decode("utf-8", "replace"))
        except struct.error:
            return None       # truncated body — hostile peers send anything
        return cls(status, results, rid.decode("utf-8", "replace"), markers)
