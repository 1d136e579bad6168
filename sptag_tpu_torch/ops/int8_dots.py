"""The cascade's int8 tier over a shortlist: gathered s8 x s8 -> s32 dots.

For each query and each of its C shortlist slots the int8 tier scores the
per-query quantized query against the int8 row of that slot and turns the
exact integer dot into a dequantized distance estimate
(``sptag_tpu/ops/cascade.py:192`` ``_int8_gathered_scores``, with the -1
and tombstone sentinel of ``:217`` / ``:331``)::

    dot = (qs * scale) * float(idot)
    L2:     max((qn + float(isq) * scale2) - 2 dot, 0)
    cosine: base^2 - dot

The JAX package gathers a (Q, C, D) tensor and contracts it in XLA as int32
— at Q 1,024 and C 8,192 that is 1.07 GB of int8 and 4.3 GB as int32.
PyTorch has no integer ``bmm`` on CUDA, and the gather would move the bytes
twice, so on the card ``csrc/int8_dots.cu`` (``int8_gather_dots``) reads each
slot's row by id inside the kernel (``GATHER``: ids into the resident int8
corpus) or in output order (``ROWS``: rows fetched from the host, ids only
mask).  Integer sums are exact and the epilogue is the same IEEE steps in
the same order, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from sptag_tpu_torch import _build
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops

MAX_DIST = float(np.float32(3.4e38))
#: slot -> row: ids into the source, or the source in output order
GATHER, ROWS = 0, 1

KERNELS = ("int8_gather_dots",)
_launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

_SIGNATURES = {
    "sptag_int8_gather_dots": (ctypes.c_int, (ctypes.c_void_p,) * 7
                               + (ctypes.c_int,) * 5
                               + (ctypes.c_float,) * 4
                               + (ctypes.c_void_p,)),
}


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def library() -> ctypes.CDLL:
    return _build.load("int8_dots", _SIGNATURES)


def _f32(v: float) -> float:
    return float(np.float32(v))


def int8_gather_dots_reference(qq: torch.Tensor, qs: torch.Tensor,
                               qn: torch.Tensor, x: torch.Tensor,
                               ids: torch.Tensor,
                               invalid: Optional[torch.Tensor],
                               scale: float, metric: int, base: int,
                               mode: int = GATHER) -> torch.Tensor:
    """Plain version: the rows gathered (or viewed in output order), one
    exact integer contraction, the JAX package's epilogue."""
    Q, C = ids.shape
    safe = ids.clamp_min(0).long()
    rows = x[safe] if mode == GATHER else x.view(Q, C, -1)
    idot = dist_ops.int_contract("qd,qcd->qc", qq, rows)
    scale = _f32(scale)
    dot = (qs[:, None] * scale) * idot.to(torch.float32)
    if int(metric) == int(DistCalcMethod.Cosine):
        d = float(base) * float(base) - dot
    else:
        ri = rows.to(torch.int32)
        isq = (ri * ri).sum(-1).to(torch.float32)
        scale2 = _f32(np.float32(scale) * np.float32(scale))
        d = torch.clamp_min(qn[:, None] + isq * scale2 - 2.0 * dot, 0.0)
    dead = ids < 0
    if mode == GATHER and invalid is not None:
        dead = dead | invalid[safe]
    return torch.where(dead, MAX_DIST, d)


def int8_gather_dots(qq: torch.Tensor, qs: torch.Tensor, qn: torch.Tensor,
                     x: torch.Tensor, ids: torch.Tensor,
                     invalid: Optional[torch.Tensor], scale: float,
                     metric: int, base: int,
                     mode: int = GATHER) -> torch.Tensor:
    """(Q, D) int8 quantized queries with their (Q,) float32 scales `qs` and
    squared norms `qn`, an (R, D) int8 source `x`, (Q, C) int32 `ids` ->
    (Q, C) float32 distance estimates; a -1 id, or (GATHER) a row whose
    `invalid` is set, gives MAX_DIST.  A CPU tensor runs the plain version;
    on the card the kernel (or a raise)."""
    if qq.device.type == "cpu":
        return int8_gather_dots_reference(qq, qs, qn, x, ids, invalid, scale,
                                          metric, base, mode)
    dev = qq.device
    checks = [(qq, torch.int8), (x, torch.int8), (qs, torch.float32),
              (qn, torch.float32), (ids, torch.int32)]
    if invalid is not None:
        checks.append((invalid, torch.bool))
    for t, dt in checks:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise TypeError("int8_gather_dots: takes contiguous int8 queries "
                            "and rows, float32 scales and norms, int32 ids "
                            "and a bool mask on one device")
    (Q, D), C = qq.shape, ids.shape[1]
    if (x.shape[1] != D or ids.shape[0] != Q or qs.numel() != Q
            or qn.numel() != Q or mode not in (GATHER, ROWS)
            or (mode == ROWS and x.shape[0] != Q * C)
            or Q > 65535 or Q * C >= 2 ** 31):
        raise ValueError("int8_gather_dots: shapes")
    out = torch.empty((Q, C), dtype=torch.float32, device=dev)
    if Q * C == 0:
        return out
    epi = 1 if int(metric) == int(DistCalcMethod.Cosine) else 0
    s = _f32(scale)
    with torch.cuda.device(dev):
        rc = library().sptag_int8_gather_dots(
            qq.data_ptr(), qs.data_ptr(), qn.data_ptr(), x.data_ptr(),
            ids.data_ptr(), None if invalid is None else invalid.data_ptr(),
            out.data_ptr(), Q, C, D, mode, epi, s,
            _f32(np.float32(s) * np.float32(s)),
            _f32(float(base) * float(base)), MAX_DIST,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_gather_dots: CUDA launch failed ({rc})")
    with _count_lock:
        _launches["int8_gather_dots"] += 1
    return out
