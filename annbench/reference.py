"""The plain reference: exact k nearest neighbours in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
normalizes its own rows for cosine and computes every distance itself.
Distances follow SPTAG's conventions, which the program states: squared
L2, and for float cosine ``1 - dot`` of rows scaled to unit length.

* `exact_topk`: the k smallest distances of each query over the whole
  corpus, computed in blocks of queries on the device, float32 with TF32
  off (`precision="float32"`).  `precision="tf32"` is the control: the
  same search with the dot products' inputs rounded to TF32's 10-bit
  mantissa, what a TF32 matrix product does, on the CPU as on the card.
* `pair_distances`: the float64 distance of given (query, row) pairs and
  the scale its float32 rounding is judged against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

METRICS = ("L2", "Cosine")


def set_full_float32() -> None:
    """float32 products at full precision (TF32 off) in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest even at TF32's 10 mantissa bits
    (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to length 1 (float64 norms; zero rows become the
    constant vector 1/sqrt(D), SPTAG's rule)."""
    x64 = x.double()
    norms = x64.norm(dim=1, keepdim=True)
    const = torch.full_like(x64, 1.0 / np.sqrt(x.shape[1]))
    return torch.where(norms < 1e-6, const,
                       x64 / norms.clamp_min(1e-30)).to(x.dtype)


def prepare(rows: np.ndarray, metric: str, device: torch.device
            ) -> torch.Tensor:
    """float32 rows on `device` as the metric reads them."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    x = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)
    return unit_rows(x) if metric == "Cosine" else x


def _block_distances(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor,
                     metric: str, precision: str) -> torch.Tensor:
    if precision == "tf32":
        dot = round_to_tf32(q) @ round_to_tf32(x).T
    elif precision == "float32":
        dot = q @ x.T
    else:
        raise ValueError(f"unknown precision {precision!r}")
    if metric == "Cosine":
        return 1.0 - dot
    qn = (q * q).sum(1, keepdim=True)
    return (qn + xn[None, :] - 2.0 * dot).clamp_min(0.0)


def exact_topk(x: torch.Tensor, queries: torch.Tensor, k: int, metric: str,
               precision: str = "float32", block: int = 1024
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((Q, k) float32 distances ascending, (Q, k) int64 row ids) of the
    prepared `queries` over the prepared corpus `x`."""
    set_full_float32()
    xn = (x * x).sum(1)
    dists, ids = [], []
    for s in range(0, queries.shape[0], block):
        d = _block_distances(queries[s:s + block], x, xn, metric, precision)
        vals, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dists.append(vals)
        ids.append(pos)
    return torch.cat(dists), torch.cat(ids)


def pair_distances(q: torch.Tensor, x: torch.Tensor, metric: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, D) queries and (R, C, D) rows -> ((R, C) float64 distances,
    (R, C) float64 scales).  The scale is the sum of the magnitudes of the
    terms a float32 expanded form adds up (|q|^2 + |x|^2 + 2 sum |q_d x_d|
    for L2, 1 + sum |q_d x_d| for cosine): a float32 computation of the
    distance is off by a few units of float32 rounding of it."""
    q64 = q.double()[:, None, :]
    x64 = x.double()
    prod = q64 * x64
    absdot = prod.abs().sum(-1)
    if metric == "Cosine":
        return 1.0 - prod.sum(-1), 1.0 + absdot
    diff = q64 - x64
    scale = (q64 * q64).sum(-1) + (x64 * x64).sum(-1) + 2.0 * absdot
    return (diff * diff).sum(-1), scale
