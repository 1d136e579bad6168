"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``
— no PyTorch headers, so a build takes seconds.  Libraries land in the
package's git-ignored ``_build/`` directory, keyed by a hash of the source
and the flags, at first use; a process reuses what an earlier one built.
There is no fallback: a source that does not compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's messages (ptxas register / spill report) of each source built
#: by this process; empty for a library found already built
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from sptag_tpu_torch/csrc with the CUDA toolkit")


def library_path(name: str) -> str:
    """The library's path, keyed by its source, the headers of ``csrc/``
    (which a source may include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> Tuple[str, float]:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns (library path, seconds spent in nvcc)."""
    import time

    so = library_path(name)
    if os.path.exists(so):
        build_log.setdefault(name, "")
        return so, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {name}.cu:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)            # atomic: concurrent builds agree
    build_log[name] = res.stdout + res.stderr
    # a build is the port's compile (utils/recompile_guard.py)
    from sptag_tpu_torch.utils import recompile_guard
    recompile_guard.note_compile(recompile_guard.BUILD, seconds)
    return so, seconds


def load(name: str, signatures: Dict[str, Tuple[Optional[type], tuple]]
         ) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; `signatures` maps
    each C entry point to (restype, argtypes)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _libs[name] = lib
        return lib
