"""Crash-safe persistence primitives (port of ``sptag_tpu/io/atomic.py``).

fsync'd file writes, the cross-filesystem atomic replace, and the snapshot
manifest: per-file size + CRC32, written last into a staged save, so a
folder whose blobs were truncated or bit-flipped fails the load instead of
deserializing garbage.  The manifest format is the JAX package's, so either
package verifies the other's folders.

Fault sites (utils/faultinject.py storage kinds, ``SPTAG_FAULTINJECT``):

* ``snapshot.write`` — every checked_open'd file write (``torn_write``
  persists a prefix then dies; ``crash`` dies before the file exists);
* ``snapshot.read`` — manifest verification reads (``short_read``);
* crash points are the caller's: save_index names its own
  (``save.pre_rename`` / ``save.post_rename``).
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import shutil
import zlib
from typing import Dict, Iterable, Optional

from sptag_tpu_torch.utils import faultinject

MANIFEST_NAME = "manifest.json"


class ManifestError(RuntimeError):
    """A manifest-listed file is missing or fails its checksum."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _TearingFile:
    """File proxy armed by a ``torn_write`` fault: the first write
    persists a durable prefix of its bytes, then the "process dies"."""

    def __init__(self, f):
        self._f = f

    def write(self, b):
        prefix = bytes(b)[: max(1, len(b) // 2)] if len(b) else b""
        self._f.write(prefix)
        # the torn prefix is durable before the death: a torn tail lost
        # with the page cache would test nothing
        self._f.flush()
        os.fsync(self._f.fileno())
        raise faultinject.InjectedCrash("torn_write")

    def __getattr__(self, name):
        return getattr(self._f, name)


@contextlib.contextmanager
def checked_open(path_or_stream, mode: str = "wb",
                 site: str = "snapshot.write"):
    """Write-mode open with the fault hooks, fsync'd before close; streams
    pass through (their owner handles durability)."""
    if hasattr(path_or_stream, "write"):
        yield path_or_stream
        return
    fault = faultinject.storage_fault(site)
    if fault is not None and fault.kind == "crash":
        raise faultinject.InjectedCrash(site)
    with open(path_or_stream, mode) as f:
        yield (_TearingFile(f) if fault is not None
               and fault.kind == "torn_write" else f)
        f.flush()
        os.fsync(f.fileno())


def replace_file(src: str, dst: str) -> None:
    """``os.replace`` with a copy + fsync + unlink fallback when `dst` is
    on another filesystem (EXDEV)."""
    try:
        os.replace(src, dst)
        return
    except OSError as e:
        if e.errno != errno.EXDEV:
            raise
    tmp = dst + ".xdev-tmp"
    shutil.copy2(src, tmp)
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst)
    _fsync_dir(os.path.dirname(dst) or ".")
    os.unlink(src)


def file_crc32(path: str, site: str = "snapshot.read") -> int:
    """Streaming CRC32 of a file; a ``short_read`` fault truncates the
    bytes seen (the checksum then fails loudly downstream)."""
    fault = faultinject.storage_fault(site)
    total = os.path.getsize(path)
    limit = total // 2 if fault is not None \
        and fault.kind == "short_read" else total
    seen = 0
    crc = 0
    with open(path, "rb") as f:
        while seen < limit:
            chunk = f.read(min(1 << 20, limit - seen))
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            seen += len(chunk)
    return crc & 0xFFFFFFFF


def write_manifest(folder: str, exclude: Iterable[str] = ()) -> None:
    """Write ``manifest.json``: size + CRC32 of every regular file in
    `folder` except `exclude` and the manifest itself."""
    skip = set(exclude) | {MANIFEST_NAME}
    files: Dict[str, Dict] = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        if name in skip or not os.path.isfile(path):
            continue
        files[name] = {"bytes": os.path.getsize(path),
                       "crc32": file_crc32(path, site="snapshot.write")}
    payload = json.dumps({"version": 1, "files": files}, sort_keys=True)
    with checked_open(os.path.join(folder, MANIFEST_NAME), "w") as f:
        f.write(payload)


def verify_manifest(folder: str) -> Optional[int]:
    """Check every manifest-listed file's size + CRC32; the number of files
    verified, or None without a manifest.  Raises ManifestError."""
    path = os.path.join(folder, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path, "r") as f:
        try:
            manifest = json.load(f)
        except ValueError as e:
            raise ManifestError(f"unparseable manifest {path}: {e}")
    checked = 0
    for name, meta in manifest.get("files", {}).items():
        fpath = os.path.join(folder, name)
        if not os.path.exists(fpath):
            raise ManifestError(f"manifest lists missing file {name}")
        size = os.path.getsize(fpath)
        if size != int(meta.get("bytes", -1)):
            raise ManifestError(
                f"{name}: size {size} != manifest {meta.get('bytes')}")
        crc = file_crc32(fpath)
        if crc != int(meta.get("crc32", -1)):
            raise ManifestError(
                f"{name}: crc32 {crc:#x} != manifest "
                f"{int(meta.get('crc32', -1)):#x}")
        checked += 1
    return checked
