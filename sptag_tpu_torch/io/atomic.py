"""Crash-safe persistence primitives (port of ``sptag_tpu/io/atomic.py``).

fsync'd file writes, the cross-filesystem atomic replace, and the snapshot
manifest: per-file size + CRC32, written last into a staged save, so a
folder whose blobs were truncated or bit-flipped fails the load instead of
deserializing garbage.  The manifest format is the JAX package's, so either
package verifies the other's folders.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import shutil
import zlib
from typing import Dict, Iterable, Optional

MANIFEST_NAME = "manifest.json"


class ManifestError(RuntimeError):
    """A manifest-listed file is missing or fails its checksum."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def checked_open(path_or_stream, mode: str = "wb"):
    """Write-mode open that fsyncs before close; streams pass through."""
    if hasattr(path_or_stream, "write"):
        yield path_or_stream
        return
    with open(path_or_stream, mode) as f:
        yield f
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


def file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
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
                       "crc32": file_crc32(path)}
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
