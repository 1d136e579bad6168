"""Batched distance functions (port of ``sptag_tpu/ops/distance.py``).

Conventions are the JAX package's, which are SPTAG's (DistanceUtils.h):

* L2 is the SQUARED euclidean distance, composed as
  ``max(|q|^2 + |x|^2 - 2 q.x, 0)`` from (cached) squared norms.
* Cosine is ``base^2 - dot`` (int8 127^2, uint8 255^2, int16 32767^2, float
  1), on rows normalized to length ``base`` at ingest.
* Floats accumulate in float32 at full precision (TF32 off, device.py);
  the walk's bf16 shadow contracts bf16 operands into float32 dots.
* int8 / uint8 dots are exact integers.  int16 uses the exact high/low byte
  split, a = 256*hi + lo: three integer-exact contractions combined with
  one float32 rounding per partial for L2, and exactly in int32 for cosine.

Integer contractions: CUDA has no integer GEMM, so they run in float64 —
every partial sum here is an integer far below 2^53, hence exact — and
the CPU takes int64; int8 / uint8 contractions short enough that every
partial sum stays below 2^24 run in float32, exact as well.  Either way
the result equals the JAX package's int32-accumulated value.

Every top-k keeps ``lax.top_k``'s rule: among equal distances the lowest
index comes first (a stable sort), which ``torch.topk`` does not promise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.core.types import DistCalcMethod, VectorValueType, base_of
from sptag_tpu_torch.utils import costmodel

# every int16 partial sum fits int32 below this D (sum(lo*lo) <= D*255^2)
_INT16_EXACT_MAX_D = 16384

_INT_VALUE_TYPES = {torch.int8: VectorValueType.Int8,
                    torch.uint8: VectorValueType.UInt8,
                    torch.int16: VectorValueType.Int16}


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point


def exact_int_dot(dtype: torch.dtype) -> bool:
    """int8/uint8: dots are exact integers.  int16 takes the split path."""
    return dtype in (torch.int8, torch.uint8)


def _use_int16_exact(dtype: torch.dtype, d: int) -> bool:
    return dtype == torch.int16 and d <= _INT16_EXACT_MAX_D


# largest |a_d * b_d| of an int8 / uint8 product
_MAX_PRODUCT = {torch.int8: 128 * 128, torch.uint8: 255 * 255}


def int_contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer einsum -> int64 (see the module docstring).  Where
    every partial sum of an int8 / uint8 contraction over the last axis is
    an integer below 2^24 (int8 up to D = 1023, uint8 up to D = 258) it
    runs in float32, exact in any summation order."""
    bound = _MAX_PRODUCT.get(a.dtype) if a.dtype == b.dtype else None
    if bound and bound * a.shape[-1] < (1 << 24):
        return torch.einsum(eq, a.to(torch.float32),
                            b.to(torch.float32)).long()
    if a.device.type == "cpu":
        return torch.einsum(eq, a.long(), b.long())
    return torch.einsum(eq, a.double(), b.double()).long()


def _int16_split(a: torch.Tensor):
    """a = 256*hi + lo, hi in [-128, 127], lo in [0, 255]."""
    ai = a.to(torch.int32)
    return ai >> 8, ai & 255


def _int16_dot_parts(q, x, eq: str):
    qh, ql = _int16_split(q)
    xh, xl = _int16_split(x)
    hh = int_contract(eq, qh, xh)
    mixed = int_contract(eq, torch.cat([qh, ql], -1), torch.cat([xl, xh], -1))
    ll = int_contract(eq, ql, xl)
    return hh, mixed, ll


def _int16_parts_f32(hh, mixed, ll) -> torch.Tensor:
    """The JAX package's float32 combine: each partial converted once."""
    return (65536.0 * hh.to(torch.float32) + 256.0 * mixed.to(torch.float32)
            + ll.to(torch.float32))


def _int16_parts_i32(hh, mixed, ll) -> torch.Tensor:
    """Exact combine with int32 wraparound (exact when the dot fits int32,
    as it does for cosine on base-normalized rows)."""
    v = (hh << 16) + (mixed << 8) + ll
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def pairwise_dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) dot products, float32."""
    if exact_int_dot(q.dtype):
        return int_contract("qd,nd->qn", q, x).to(torch.float32)
    if _use_int16_exact(q.dtype, q.shape[-1]):
        return _int16_parts_f32(*_int16_dot_parts(q, x, "qd,nd->qn"))
    return q.to(torch.float32) @ x.to(torch.float32).T


def row_sqnorms(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N,) squared norms, float32 (exact for int8/uint8)."""
    if _is_int(x.dtype):
        if x.dtype == torch.int16:
            if _use_int16_exact(x.dtype, x.shape[-1]):
                h, low = _int16_split(x)
                return (65536.0 * (h * h).sum(-1).to(torch.float32)
                        + 512.0 * (h * low).sum(-1).to(torch.float32)
                        + (low * low).sum(-1).to(torch.float32))
            xf = x.to(torch.float32)
            return (xf * xf).sum(-1)
        xi = x.to(torch.int32)
        return (xi * xi).sum(-1).to(torch.float32)
    xf = x.to(torch.float32)
    return (xf * xf).sum(-1)


def pairwise_l2(q: torch.Tensor, x: torch.Tensor,
                x_sqnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) squared L2 distances, float32."""
    qn = row_sqnorms(q)[:, None]
    xn = (row_sqnorms(x) if x_sqnorm is None else x_sqnorm)[None, :]
    return torch.clamp_min(qn + xn - 2.0 * pairwise_dot(q, x), 0.0)


def pairwise_cosine(q: torch.Tensor, x: torch.Tensor,
                    base: int) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) ``base^2 - dot``."""
    if _use_int16_exact(q.dtype, q.shape[-1]):
        dot = _int16_parts_i32(*_int16_dot_parts(q, x, "qd,nd->qn"))
        return (int(base) * int(base) - dot).to(torch.float32)
    return float(base) * float(base) - pairwise_dot(q, x)


def pairwise_distance(q: torch.Tensor, x: torch.Tensor,
                      metric: DistCalcMethod,
                      value_type: Optional[VectorValueType] = None,
                      x_sqnorm: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    metric = DistCalcMethod(metric)
    if metric == DistCalcMethod.L2:
        return pairwise_l2(q, x, x_sqnorm)
    if value_type is None:
        value_type = _INT_VALUE_TYPES.get(q.dtype, VectorValueType.Float)
    return pairwise_cosine(q, x, base_of(value_type))


def batched_gathered_distance(q: torch.Tensor, cand: torch.Tensor,
                              metric: DistCalcMethod, base: int,
                              cand_sqnorm: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """(Q, D) queries x (Q, C, D) per-query candidates -> (Q, C) float32."""
    metric = int(metric)
    eq = "qd,qcd->qc"
    if _is_int(q.dtype):
        if not exact_int_dot(q.dtype):
            if _use_int16_exact(q.dtype, q.shape[-1]):
                parts = _int16_dot_parts(q, cand, eq)
                if metric == int(DistCalcMethod.Cosine):
                    return (int(base) * int(base)
                            - _int16_parts_i32(*parts)).to(torch.float32)
                dot = _int16_parts_f32(*parts)
                qn = row_sqnorms(q)[:, None]
                if cand_sqnorm is None:
                    cand_sqnorm = row_sqnorms(cand)
                return torch.clamp_min(qn + cand_sqnorm - 2.0 * dot, 0.0)
            dot = torch.einsum(eq, q.to(torch.float32),
                               cand.to(torch.float32))
        else:
            dot = int_contract(eq, q, cand).to(torch.float32)
        if metric == int(DistCalcMethod.Cosine):
            return float(base) * float(base) - dot
        qf = q.to(torch.float32)
        qn = (qf * qf).sum(-1)[:, None]
        if cand_sqnorm is None:
            cf = cand.to(torch.float32)
            cand_sqnorm = (cf * cf).sum(-1)
        return torch.clamp_min(qn + cand_sqnorm - 2.0 * dot, 0.0)
    qf = q.to(torch.float32)
    if q.dtype == torch.bfloat16 and cand.dtype == torch.bfloat16:
        # the walk's bf16 shadow: bf16 operands, float32 dots
        dot = bf16_gathered_dot(q, cand)
    else:
        dot = torch.einsum(eq, qf, cand.to(torch.float32))
    if metric == int(DistCalcMethod.Cosine):
        return 1.0 - dot
    qn = (qf * qf).sum(-1)[:, None]
    if cand_sqnorm is None:
        cf = cand.to(torch.float32)
        cand_sqnorm = (cf * cf).sum(-1)
    return torch.clamp_min(qn + cand_sqnorm - 2.0 * dot, 0.0)


def bf16_gathered_dot_plain(q: torch.Tensor, cand: torch.Tensor
                            ) -> torch.Tensor:
    """(Q, D) x (Q, C, D) bf16 -> (Q, C) float32 dots: both operands
    upcast (exactly) and contracted in float32, where each product of two
    bf16 values is exact.  The CPU path and the card's reference."""
    return torch.einsum("qd,qcd->qc", q.to(torch.float32),
                        cand.to(torch.float32))


def bf16_gathered_dot(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """bf16 dots with float32 results, as the JAX package's
    ``preferred_element_type=float32``: a bf16 product rounded to bf16
    (what ``einsum``/``bmm`` give for two bf16 tensors) would keep 8
    mantissa bits of every dot and walk differently.  On the card one
    batched bf16 tensor-core product with a float32 output reads the
    (Q, C, D) rows once at 2 bytes an element; a CPU tensor takes the
    plain form."""
    if q.device.type != "cuda":
        return bf16_gathered_dot_plain(q, cand)
    return torch.bmm(cand, q[:, :, None], out_dtype=torch.float32)[..., 0]


def normalize(vectors: np.ndarray, base: int) -> np.ndarray:
    """Host-side ingest normalization (SPTAG Utils::Normalize): each row
    scaled to length `base` and cast back to the storage dtype; zero rows
    become the constant vector ``base/sqrt(D)``."""
    vectors = np.asarray(vectors)
    out_dtype = vectors.dtype
    f = vectors.astype(np.float64)
    norms = np.sqrt(np.sum(f * f, axis=-1, keepdims=True))
    d = vectors.shape[-1]
    constant = (1.0 / np.sqrt(d)) * base
    scaled = np.where(norms < 1e-6, constant,
                      f / np.maximum(norms, 1e-30) * base)
    return scaled.astype(out_dtype)


def smallest_k(dists: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) -> ((Q, k) ascending values, (Q, k) int64 positions), ties
    broken by the lowest position (the rule of ``lax.top_k``)."""
    vals, pos = torch.sort(dists, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]


def batch_topk(dists: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) distances -> ((Q, k) dists ascending, (Q, k) int32 indices)."""
    vals, pos = smallest_k(dists, k)
    return vals, pos.to(torch.int32)


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py)
# ---------------------------------------------------------------------------

def _batch_topk_cost(Q, N, k, **_):
    flops = costmodel.topk_flops(Q, N) + 2.0 * Q * N     # two negations
    nbytes = 3.0 * Q * N * 4 + Q * k * 8
    return flops, nbytes


def _row_sqnorms_cost(N, D, itemsize=4, **_):
    return 2.0 * N * D, N * D * itemsize + N * 4


costmodel.register("distance.batch_topk", batch_topk, _batch_topk_cost)
costmodel.register("distance.row_sqnorms", row_sqnorms, _row_sqnorms_cost)
