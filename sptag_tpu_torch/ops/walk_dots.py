"""Fixed-order float32 distances of the graph walk.

The walk (algo/engine.py) scores a query against the pivots when it
seeds, against the neighbours it gathers every iteration, and, with a bf16
shadow, against its final pool.  A library contraction (cuBLAS behind
``einsum`` and ``@``) tiles by the whole call's shape, so on the card a
query's float32 distances would move in the last bits with the batch it
rides in, and a walk that pops nodes by those distances can take another
path: a server that coalesces requests would answer one query differently
in different batches.  ``csrc/walk_dots.cu`` sums every dot in an order
fixed by D alone and fuses the distance epilogue, so a float32 query
against a float32 corpus gets the same bits in a batch of 1 or 1,024,
eager or replayed in a CUDA graph:

* ``walk_seed`` (kernel 1, SHARED): every pivot for every query, a
  register-tiled FFMA product over shared memory;
* ``walk_score`` (kernel 2, GATHER / ROWS): the in-loop scoring, KDT's
  seeds and the re-rank, one CTA a query, the rows gathered by id inside
  the kernel; a slot whose id is -1 loads nothing and scores MAX_DIST;
* ``walk_score_i8`` (kernel 2 over int8 rows): the cascade's in-loop
  scoring (``CascadeSearch``), each element dequantized as
  ``float(x) * scale`` in one rounding, then kernel 2's order and
  epilogue: bit for bit ``walk_score_f32`` over the dequantized rows, at a
  quarter of their bytes;
* ``row_sqnorms``: the squared norms by the kernels' own norm function
  (the engine caches the pivots' once).

`walk_distance` is the walk's entry point.  A CUDA float32 query against
float32 rows launches a kernel (or raises); a CPU tensor takes the plain
version, which is the formula the walk used before (``ops/distance.py``'s
``pairwise_distance`` / ``batched_gathered_distance``, then the -1 slots
masked), so the CPU results do not change.  Integer and bf16 rows keep
their own paths (exact integer contractions; the bf16 shadow's
tensor-core product, whose pool the float32 re-rank then scores here).
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

#: the walk's "no distance" (a masked slot's score)
MAX_DIST = float(np.float32(3.4e38))

#: output row -> row of x: idx[q, c], q * C + c itself, or every row of x
GATHER, ROWS, SHARED = 0, 1, 2
#: the kernels' epilogues: L2 and cosine (DistCalcMethod's values), the dot
L2, COSINE, DOT = 0, 1, 2

#: kernel -> launches (the CPU path never counts); the walk runs on
#: readers' threads, a scheduler's worker and background swaps
KERNELS = ("walk_seed_f32", "walk_score_f32", "walk_score_i8",
           "walk_sqnorm_f32")
_launches = dict.fromkeys(KERNELS, 0)
#: the same launches by card: (kernel, str(device)) -> launches
_card_launches: dict = {}
_count_lock = threading.Lock()

# a scoring CTA holds the query in up to 48 KB of shared memory
MAX_SCORE_D = 12288
_INT32_MAX = 2 ** 31 - 1

_SIGNATURES = {
    "sptag_walk_seed": (ctypes.c_int, (ctypes.c_void_p,) * 4
                        + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)),
    "sptag_walk_score": (ctypes.c_int, (ctypes.c_void_p,) * 5
                         + (ctypes.c_int,) * 5
                         + (ctypes.c_float, ctypes.c_void_p)),
    "sptag_walk_score_i8": (ctypes.c_int, (ctypes.c_void_p,) * 5
                            + (ctypes.c_int,) * 5
                            + (ctypes.c_float, ctypes.c_float,
                               ctypes.c_void_p)),
    "sptag_walk_sqnorms": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p)),
}


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def launch_counts_by_card() -> dict:
    """`launch_counts` split by card: ``str(device)`` -> {kernel:
    launches}, the cards that launched only."""
    with _count_lock:
        out: dict = {}
        for (name, card), n in _card_launches.items():
            out.setdefault(card, {})[name] = n
    return out


def reset_launch_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0
        _card_launches.clear()


def _count(name: str, device) -> None:
    key = (name, str(device))
    with _count_lock:
        _launches[name] += 1
        _card_launches[key] = _card_launches.get(key, 0) + 1


def library() -> ctypes.CDLL:
    return _build.load("walk_dots", _SIGNATURES)


def _launch(fn: str, kernel: str, device, *args) -> None:
    with torch.cuda.device(device):
        rc = getattr(library(), fn)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc})")
    _count(kernel, device)


def _check_f32(name: str, device, *tensors) -> None:
    for t in tensors:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise TypeError(f"{name}: takes contiguous float32 tensors on "
                            f"the queries' device")


def _check_ids(name: str, device, idx: Optional[torch.Tensor], Q: int,
               C: int) -> None:
    if (idx is None or idx.dtype != torch.int64 or not idx.is_contiguous()
            or tuple(idx.shape) != (Q, C) or idx.device != device):
        raise TypeError(f"{name}: takes contiguous (Q, C) int64 ids on the "
                        f"queries' device")


# ---- plain versions ---------------------------------------------------------

def dequantize(rows: torch.Tensor, score_scale: float) -> torch.Tensor:
    """int8 rows as the cascade scores them: ``float(x) * scale``, one
    float32 rounding an element."""
    return rows.to(torch.float32) * float(np.float32(score_scale))


def walk_distance_reference(q: torch.Tensor, x: torch.Tensor, metric,
                            base: int, mode: int,
                            idx: Optional[torch.Tensor] = None,
                            x_sqnorm: Optional[torch.Tensor] = None,
                            C: Optional[int] = None,
                            score_scale: float = 0.0) -> torch.Tensor:
    """What ``ops/distance.py`` computes for the walk, with the -1 slots of
    `idx` MAX_DIST (they score row 0 first, as the walk did).  Any dtype;
    the plain version of both kernels' L2 and cosine epilogues.  With
    `score_scale` > 0 the int8 rows are dequantized after the gather (the
    cascade's in-loop scoring)."""
    metric = int(metric)
    if mode == SHARED:
        return dist_ops.pairwise_distance(q, x, DistCalcMethod(metric),
                                          x_sqnorm=x_sqnorm)
    Q = q.shape[0]
    if mode == GATHER:
        safe = idx.clamp_min(0)
        rows = x[safe]
        sq = None if x_sqnorm is None else x_sqnorm[safe]
    else:
        C = idx.shape[1] if C is None else C
        rows = x.view(Q, C, -1)
        sq = None if x_sqnorm is None else x_sqnorm.reshape(Q, C)
    if score_scale:
        rows = dequantize(rows, score_scale)
    d = dist_ops.batched_gathered_distance(q, rows, metric, base, sq)
    return d if idx is None else torch.where(idx >= 0, d, MAX_DIST)


def walk_seed_reference(q: torch.Tensor, x: torch.Tensor,
                        x_sqnorm: Optional[torch.Tensor],
                        epi: int) -> torch.Tensor:
    """Plain version of kernel 1: (Q, P) by one matrix product."""
    if epi == DOT:
        return q @ x.T
    return walk_distance_reference(q, x, epi, 1, SHARED, x_sqnorm=x_sqnorm)


def walk_score_reference(q: torch.Tensor, x: torch.Tensor,
                         idx: Optional[torch.Tensor],
                         x_sqnorm: Optional[torch.Tensor], epi: int,
                         mode: int, C: int) -> torch.Tensor:
    """Plain version of kernel 2: (Q, C) by one ``einsum`` over the rows
    gathered by id (GATHER) or laid out in output order (ROWS)."""
    if epi != DOT:
        return walk_distance_reference(q, x, epi, 1, mode, idx, x_sqnorm, C)
    if mode == GATHER:
        rows = x[idx.clamp_min(0)]
    else:
        rows = x.view(q.shape[0], C, -1)
    dot = torch.einsum("qd,qcd->qc", q, rows)
    return dot if idx is None else torch.where(idx >= 0, dot, MAX_DIST)


# ---- the kernels' wrappers --------------------------------------------------

def row_sqnorms(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N,) float32 squared norms.  On the card, float32 rows
    take the kernels' own norm function (the bits kernel 1 and 2 give a
    query's norm); other dtypes and CPU tensors ``ops/distance.py``'s."""
    if x.device.type == "cpu" or x.dtype != torch.float32:
        return dist_ops.row_sqnorms(x)
    _check_f32("walk_sqnorm_f32", x.device, x)
    N, D = x.shape
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    _launch("sptag_walk_sqnorms", "walk_sqnorm_f32", x.device,
            x.data_ptr(), out.data_ptr(), N, D)
    return out


def walk_seed(q: torch.Tensor, x: torch.Tensor,
              x_sqnorm: Optional[torch.Tensor], epi: int) -> torch.Tensor:
    """(Q, D) float32 queries x (P, D) rows -> (Q, P) float32: each query
    against every row (L2 reads `x_sqnorm` (P,)).  A CPU tensor runs the
    plain version; on the card kernel 1."""
    if q.device.type == "cpu":
        return walk_seed_reference(q, x, x_sqnorm, epi)
    _check_f32("walk_seed_f32", q.device, q, x)
    (Q, D), P = q.shape, x.shape[0]
    if x.shape[1] != D or max(Q, P) > _INT32_MAX:
        raise ValueError("walk_seed_f32: shapes")
    if epi == L2:
        _check_f32("walk_seed_f32", q.device, x_sqnorm)
        if x_sqnorm.numel() != P:
            raise ValueError("walk_seed_f32: x_sqnorm must be (P,)")
    out = torch.empty((Q, P), dtype=torch.float32, device=q.device)
    if Q * P == 0:
        return out
    _launch("sptag_walk_seed", "walk_seed_f32", q.device, q.data_ptr(),
            x.data_ptr(), x_sqnorm.data_ptr() if epi == L2 else None,
            out.data_ptr(), Q, P, D, epi)
    return out


def walk_score_i8_reference(q: torch.Tensor, x: torch.Tensor,
                            idx: Optional[torch.Tensor],
                            x_sqnorm: Optional[torch.Tensor], epi: int,
                            mode: int, C: int,
                            score_scale: float) -> torch.Tensor:
    """Plain version of kernel 2 over int8 rows: the rows dequantized,
    then ``walk_score_reference``."""
    return walk_score_reference(q, dequantize(x, score_scale), idx,
                                x_sqnorm, epi, mode, C)


def walk_score(q: torch.Tensor, x: torch.Tensor,
               idx: Optional[torch.Tensor],
               x_sqnorm: Optional[torch.Tensor], epi: int, mode: int,
               C: int, score_scale: float = 0.0) -> torch.Tensor:
    """(Q, D) float32 queries -> (Q, C) float32 against the rows of `x`
    that `mode` names (GATHER: ``idx`` (Q, C) int64 ids; ROWS: x is
    (Q * C, D) in output order and ``idx``, if given, masks); -1 ids score
    MAX_DIST.  L2 reads `x_sqnorm` by row of x.  int8 rows `x` with
    `score_scale` > 0 are dequantized in the load (``walk_score_i8``).  A
    CPU tensor runs the plain version; on the card kernel 2."""
    i8 = x.dtype == torch.int8
    if q.device.type == "cpu":
        if i8:
            return walk_score_i8_reference(q, x, idx, x_sqnorm, epi, mode,
                                           C, score_scale)
        return walk_score_reference(q, x, idx, x_sqnorm, epi, mode, C)
    name = "walk_score_i8" if i8 else "walk_score_f32"
    if i8:
        _check_f32(name, q.device, q)
        if not x.is_contiguous() or x.device != q.device or not score_scale:
            raise TypeError(f"{name}: takes contiguous int8 rows on the "
                            f"queries' device and a scale")
    else:
        _check_f32(name, q.device, q, x)
    Q, D = q.shape
    if mode not in (GATHER, ROWS) or x.shape[1] != D:
        raise ValueError(f"{name}: mode or shapes")
    if mode == GATHER or idx is not None:
        _check_ids(name, q.device, idx, Q, C)
    if mode == ROWS and x.shape[0] != Q * C:
        raise ValueError(f"{name}: ROWS takes (Q * C, D) rows")
    if D > MAX_SCORE_D or x.shape[0] > _INT32_MAX or Q * C > _INT32_MAX:
        raise ValueError(f"{name}: D <= {MAX_SCORE_D}, fewer than 2^31 rows "
                         f"and outputs")
    if epi == L2:
        _check_f32(name, q.device, x_sqnorm)
        if x_sqnorm.numel() != x.shape[0]:
            raise ValueError(f"{name}: x_sqnorm must hold one norm a row "
                             f"of x")
    out = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    if Q * C == 0:
        return out
    args = (q.data_ptr(), x.data_ptr(),
            None if idx is None else idx.data_ptr(),
            x_sqnorm.data_ptr() if epi == L2 else None, out.data_ptr(),
            Q, C, D, mode, epi)
    if i8:
        _launch("sptag_walk_score_i8", name, q.device, *args,
                float(np.float32(score_scale)), MAX_DIST)
    else:
        _launch("sptag_walk_score", name, q.device, *args, MAX_DIST)
    return out


def walk_distance(q: torch.Tensor, x: torch.Tensor, metric, base: int,
                  mode: int, idx: Optional[torch.Tensor] = None,
                  x_sqnorm: Optional[torch.Tensor] = None,
                  score_scale: float = 0.0) -> torch.Tensor:
    """(Q, D) queries -> (Q, C) float32 distances (L2 or cosine) against
    the rows of `x` that `mode` names; a slot whose id in `idx` is -1
    scores MAX_DIST.  `x_sqnorm` holds one squared norm a row of `x` (the
    corpus's table for GATHER, (Q * C,) in output order for ROWS, (P,) for
    SHARED; None: computed).  `score_scale` > 0 with int8 rows: the rows
    are the cascade's quantization, dequantized as ``float(x) * scale``.
    On the card a float32 query against float32 rows, or against such int8
    rows in GATHER / ROWS mode, takes the fixed-order kernels; every other
    case `walk_distance_reference`."""
    metric = int(metric)
    Q = q.shape[0]
    C = idx.shape[1] if idx is not None else (
        x.shape[0] if mode == SHARED else x.shape[0] // max(Q, 1))
    i8 = bool(score_scale) and x.dtype == torch.int8 and mode != SHARED
    if not (q.device.type == "cuda" and q.dtype == torch.float32
            and (x.dtype == torch.float32 or i8)):
        return walk_distance_reference(q, x, metric, base, mode, idx,
                                       x_sqnorm, C,
                                       score_scale if i8 else 0.0)
    if metric == int(DistCalcMethod.Cosine):
        if base != 1:
            raise ValueError("walk_distance: float cosine has base 1")
        epi, x_sqnorm = COSINE, None
    else:
        epi = L2
        if x_sqnorm is None:
            x_sqnorm = row_sqnorms(dequantize(x, score_scale) if i8
                                   else x.contiguous())
        x_sqnorm = x_sqnorm.reshape(-1).contiguous()
    q = q.contiguous()
    if mode == SHARED:
        return walk_seed(q, x.contiguous(), x_sqnorm, epi)
    idx = None if idx is None else idx.contiguous()
    if i8:
        return walk_score(q, x.contiguous(), idx, x_sqnorm, epi, mode, C,
                          score_scale)
    return walk_score(q, x.contiguous(), idx, x_sqnorm, epi, mode, C)
