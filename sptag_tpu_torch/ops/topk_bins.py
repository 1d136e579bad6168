"""Bin-reduction approximate top-k (port of ``sptag_tpu/ops/topk_bins.py``).

A row of W scores is scattered into ``bins`` bins by the strided rule
(column ``j`` lands in bin ``j % bins``), each bin keeps its best element,
and the exact top-k runs over the ``bins``-wide winner row only.  The
result is exact whenever no two of the true top-k share a bin; distances
of returned ids are always exact.  ``bins_for`` sizes the reduction for a
recall target by inverting E[recall@k] ~= exp(-k(k-1) / (2 bins)).

The rule functions are the JAX package's host math, unchanged.  The tensor
functions keep its tie rules: ``jnp.argmin`` takes the first occurrence
(``torch.argmin`` does too) and ``lax.top_k`` the lowest index (a stable
sort here: ``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.utils import costmodel

MAX_DIST = float(3.4e38)

#: default recall target of the `auto` engagement rule (ApproxRecallTarget)
DEFAULT_RECALL_TARGET = 0.99

#: `auto` bins only rows at least this many times wider than the bin count
AUTO_WIDTH_FACTOR = 2


def pow2ceil(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def validate_recall_target(rt: float) -> float:
    """Recall targets live in (0, 1]; 1.0 means exact selection."""
    rt = float(rt)
    if not (0.0 < rt <= 1.0):
        raise ValueError(
            f"recall target must be in (0, 1], got {rt!r} "
            "(ApproxRecallTarget / BinnedTopK contract)")
    return rt


def bins_for(k: int, width: int,
             recall_target: float = DEFAULT_RECALL_TARGET) -> int:
    """Power-of-two bin count meeting `recall_target` for a top-`k` select
    over a `width`-wide row: bins >= k(k-1) / (2 ln(1/recall)), floored at
    2k and capped at the row width (more bins than columns is the
    identity)."""
    recall_target = validate_recall_target(recall_target)
    if recall_target >= 1.0:
        need = width
    elif k <= 1:
        need = 1
    else:
        need = k * (k - 1) / (2.0 * math.log(1.0 / recall_target))
    bins = pow2ceil(max(int(math.ceil(need)), 2 * k, 1))
    return min(bins, pow2ceil(width))


def auto_bins(k: int, width: int,
              recall_target: float = DEFAULT_RECALL_TARGET) -> int:
    """`BinnedTopK=auto`: the `bins_for` count, or 0 (exact) unless the row
    is at least AUTO_WIDTH_FACTOR times wider than it."""
    bins = bins_for(k, width, recall_target)
    return bins if width >= AUTO_WIDTH_FACTOR * bins else 0


def normalize_mode(mode) -> str:
    """Canonical BinnedTopK value: off / on / auto (raises otherwise)."""
    m = (str(mode) if mode is not None else "off").strip().lower()
    if m in ("off", "0", ""):
        return "off"
    if m in ("on", "1"):
        return "on"
    if m == "auto":
        return "auto"
    raise ValueError(f"BinnedTopK must be off/on/auto, got {mode!r}")


def walk_merge_bins(mode: str, L: int, width: int) -> int:
    """Bin count of the beam walk's frontier merge (0 = exact merge):
    pow2ceil(2L) keeps the sorted beam prefix collision-free under the
    strided binning and leaves each beam slot a free partner bin.  `width`
    is the merged row (L + B*m, spare columns excluded)."""
    mode = normalize_mode(mode)
    if mode == "off":
        return 0
    bins = pow2ceil(2 * L)
    if mode == "on":
        return bins if width > bins else 0
    return bins if width >= AUTO_WIDTH_FACTOR * bins else 0


def seed_spare_keep(mode: str, L: int, width: int) -> int:
    """How many sorted spare pivots beyond the top-L the binned seed select
    keeps (0 = exact full-sort seeding): 3L, far past any injection
    budget, unless the pivot row is too narrow for binning to pay."""
    if normalize_mode(mode) == "off":
        return 0
    keep = max(min(width - L, 3 * L), 0)
    kbins = pow2ceil(L + keep)
    if width < AUTO_WIDTH_FACTOR * kbins:
        return 0
    return keep


def resolve_bins(mode: str, k: int, width: int,
                 recall_target: float = DEFAULT_RECALL_TARGET) -> int:
    """BinnedTopK value -> bin count (0 = exact): "off" never bins, "on"
    bins at the recall-target size unless the row is no wider than the
    bins, "auto" applies the width-factor rule."""
    mode = normalize_mode(mode)
    if mode == "off":
        return 0
    if mode == "on":
        bins = bins_for(k, width, recall_target)
        return bins if width > bins else 0
    return auto_bins(k, width, recall_target)


def bin_shortlist(d: torch.Tensor, bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) distances -> ((Q, bins) per-bin minima, (Q, bins) int64 source
    columns).  The row is MAX_DIST-padded to a stride multiple, so empty
    bins surface as MAX_DIST winners; ties go to the lowest stride."""
    q, w = d.shape
    strides = -(-w // bins)
    pad = strides * bins - w
    if pad:
        d = torch.cat([d, torch.full((q, pad), MAX_DIST, dtype=d.dtype,
                                     device=d.device)], dim=1)
    r = d.reshape(q, strides, bins)
    amin = torch.argmin(r, dim=1)                          # first occurrence
    vals = torch.gather(r, 1, amin[:, None, :])[:, 0, :]
    cols = amin * bins + torch.arange(bins, device=d.device)[None, :]
    return vals, cols


def binned_topk(d: torch.Tensor, k: int, bins: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate ascending top-k: per-bin reduction, then the exact top-k
    over the winner row.  Returns ((Q, k') distances ascending, (Q, k')
    int64 column indices into `d`), k' = min(k, bins)."""
    vals, cols = bin_shortlist(d, bins)
    out, pos = dist_ops.smallest_k(vals, min(k, bins))
    return out, torch.gather(cols, 1, pos)


# ---------------------------------------------------------------------------
# cost-ledger entry (utils/costmodel.py)
# ---------------------------------------------------------------------------

def binned_select_cost(Q, W, k, bins, **_):
    """One bin reduction + the bins-wide exact top-k: the O(W) min/argmin
    pass, the winner-column arithmetic and `topk_flops` over the
    shortlist; bytes: the padded row read twice, the (Q, bins) winner
    row's traffic and the (Q, k) result."""
    W_pad = (-(-W // bins)) * bins
    flops = (2.0 * Q * W_pad                    # min + argmin reductions
             + 2.0 * Q * bins                   # column arithmetic
             + costmodel.topk_flops(Q, bins))
    nbytes = (2.0 * Q * W_pad * 4               # row read by both reductions
              + 6.0 * Q * bins * 4              # winners written + re-read
              + Q * k * 8)
    return flops, nbytes


costmodel.register("ops.binned_topk", binned_topk, binned_select_cost)
