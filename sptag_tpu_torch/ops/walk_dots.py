"""Fixed-order float32 distances of the graph walk.

The walk (algo/engine.py) scores a query against the pivots when it
seeds, against the neighbours it gathers every iteration, and, with a bf16
shadow, against its final pool.  A library contraction (cuBLAS behind
``einsum`` and ``@``) tiles by the whole call's shape, so on the card a
query's float32 distances move in the last bits with the batch it rides
in, and a walk that pops nodes by those distances can take another path:
a server that coalesces requests would answer one query differently in
different batches.  ``csrc/walk_dots.cu`` computes every dot as one warp's
sum in one order, so a float32 query against a float32 corpus gets the
same bits in a batch of 1 or 1,024, eager or replayed in a CUDA graph.

`walk_distance` is the walk's entry point.  A CUDA float32 query against
float32 rows launches the kernel (or raises); a CPU tensor takes the plain
version, which is the formula the walk used before (``einsum`` / ``@``),
so the CPU results do not change.  Integer and bf16 rows keep their own
paths (exact integer contractions; the bf16 shadow's tensor-core product,
whose pool the float32 re-rank then scores here).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from sptag_tpu_torch import _build
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops

#: launches of the kernel (the CPU path never counts); the walk runs on
#: readers' threads, a scheduler's worker and background swaps
launches = 0
_count_lock = threading.Lock()

#: output row -> row of x: idx[r], r itself, or r % C
GATHER, ROWS, SHARED = 0, 1, 2

_SIGNATURES = {
    "sptag_walk_dots": (ctypes.c_int, (ctypes.c_void_p,) * 4
                        + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p)),
}


def launch_counts() -> dict:
    return {"walk_dots_f32": launches}


def reset_launch_counts() -> None:
    global launches
    with _count_lock:
        launches = 0


def library() -> ctypes.CDLL:
    return _build.load("walk_dots", _SIGNATURES)


def walk_dots_reference(q: torch.Tensor, x: torch.Tensor,
                        idx: Optional[torch.Tensor], mode: int,
                        C: int) -> torch.Tensor:
    """Plain version: (Q, C) float32 dots by one ``einsum`` (gathered or
    row-aligned) or one matrix product (shared rows)."""
    if mode == SHARED:
        return q @ x.T
    rows = x[idx] if mode == GATHER else x.view(q.shape[0], C, -1)
    return torch.einsum("qd,qcd->qc", q, rows)


def walk_dots(q: torch.Tensor, x: torch.Tensor,
              idx: Optional[torch.Tensor], mode: int, C: int
              ) -> torch.Tensor:
    """(Q, D) float32 queries -> (Q, C) float32 dots against the rows of
    `x` that `mode` names (GATHER: ``idx`` (Q, C) int64; ROWS: x is
    (Q * C, D) in output order; SHARED: x is (C, D) for every query).  A
    CPU tensor runs the plain version; on the card the fixed-order
    kernel."""
    if q.device.type == "cpu":
        return walk_dots_reference(q, x, idx, mode, C)
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("walk_dots: takes float32 queries and rows")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise TypeError("walk_dots: takes contiguous queries and rows")
    if mode == GATHER and (idx is None or idx.dtype != torch.int64
                           or not idx.is_contiguous()):
        raise TypeError("walk_dots: GATHER takes contiguous int64 ids")
    Q, D = q.shape
    out = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    if Q * C == 0:
        return out
    lib = library()
    with torch.cuda.device(q.device):
        rc = lib.sptag_walk_dots(
            q.data_ptr(), x.data_ptr(),
            idx.data_ptr() if mode == GATHER else None, out.data_ptr(),
            Q * C, C, D, mode, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"walk_dots: CUDA launch failed ({rc})")
    global launches
    with _count_lock:
        launches += 1
    return out


def _fixed_order(q: torch.Tensor, x: torch.Tensor) -> bool:
    return (q.device.type == "cuda" and q.dtype == torch.float32
            and x.dtype == torch.float32)


def walk_distance(q: torch.Tensor, x: torch.Tensor, metric, base: int,
                  mode: int, idx: Optional[torch.Tensor] = None,
                  x_sqnorm: Optional[torch.Tensor] = None,
                  C: Optional[int] = None) -> torch.Tensor:
    """(Q, D) queries -> (Q, C) float32 distances (L2 or cosine) against
    the rows of `x` that `mode` names; `x_sqnorm` holds those rows'
    squared norms in output order ((Q, C), or (C,) for SHARED; None:
    computed).  On the card a float32 query against float32 rows scores
    with the fixed-order kernel, queries' own norms included; every other
    case computes what ``ops/distance.py`` computes for the walk."""
    metric = int(metric)
    Q = q.shape[0]
    if C is None:
        C = idx.shape[1] if mode == GATHER else (
            x.shape[0] if mode == SHARED else x.shape[0] // max(Q, 1))
    if not _fixed_order(q, x):
        if mode == SHARED:
            return dist_ops.pairwise_distance(q, x, DistCalcMethod(metric),
                                              x_sqnorm=x_sqnorm)
        rows = x[idx] if mode == GATHER else x.view(Q, C, -1)
        return dist_ops.batched_gathered_distance(q, rows, metric, base,
                                                  x_sqnorm)
    q = q.contiguous()
    dot = walk_dots(q, x.contiguous(), idx, mode, C)
    if metric == int(DistCalcMethod.Cosine):
        return 1.0 - dot
    qn = walk_dots(q, q, None, ROWS, 1)                        # (Q, 1)
    if x_sqnorm is None:
        xr = x[idx].reshape(-1, x.shape[1]) if mode == GATHER else x
        xn = walk_dots(xr, xr, None, ROWS, 1)[:, 0]
        x_sqnorm = xn.view(Q, C) if mode != SHARED else xn
    xn = x_sqnorm if mode != SHARED else x_sqnorm[None, :]
    return torch.clamp_min(qn + xn - 2.0 * dot, 0.0)
