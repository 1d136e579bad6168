"""Loader of the native C++ host library (``native/sptag_host.cpp``), the
port's copy of ``sptag_tpu/native.py``.

The library speeds up host-side work (the parallel TSV parse of
io/reader.py).  It is built on first use with g++ (plain C interface,
``ctypes``) into the port's git-ignored ``_build/`` directory, named by a
hash of the source and the flags — never beside the source, where the JAX
package keeps its own build.  Without g++ or the source, ``load`` returns
None and the reader takes its pure-Python parser: a host code path that
both packages share, not a device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "sptag_host.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libsptag_host-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.info("native host library build skipped: %s", e)
        return False
    os.replace(tmp, so)            # atomic: concurrent builds agree
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None when the toolchain or
    the source is missing."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            log.info("native host library load failed: %s", e)
            return None
        lib.sptag_count_lines.restype = ctypes.c_longlong
        lib.sptag_count_lines.argtypes = [ctypes.c_char_p,
                                          ctypes.c_longlong]
        lib.sptag_parse_tsv.restype = ctypes.c_longlong
        lib.sptag_parse_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong)]
        _lib = lib
        return _lib


def parse_tsv(blob: bytes, delimiter: str, dim: int, threads: int):
    """Native parallel TSV parse -> (float32 (rows, dim), list of metadata
    bytes), or None when the library is unavailable or the input is
    malformed (the caller parses in Python then)."""
    import numpy as np

    lib = load()
    if lib is None or dim <= 0:
        return None
    rows = lib.sptag_count_lines(blob, len(blob))
    if rows <= 0:
        return None
    out = np.empty((rows, dim), np.float32)
    meta_blob = ctypes.create_string_buffer(len(blob))
    meta_lens = (ctypes.c_longlong * rows)()
    got = lib.sptag_parse_tsv(
        blob, len(blob), delimiter.encode()[:1], dim, threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        meta_blob, meta_lens)
    if got < 0:
        return None
    out = out[:got]
    metas = []
    off = 0
    raw = meta_blob.raw
    for r in range(got):
        n = meta_lens[r]
        metas.append(raw[off:off + n])
        off += n
    return out, metas
