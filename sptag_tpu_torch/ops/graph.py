"""Device functions of the k-NN graph build (port of
``sptag_tpu/ops/graph.py``).

* ``leaf_allpairs_topk`` — a batch of TPTree leaves as one (B, P, P)
  distance tensor and one lowest-index-first top-k per row (the
  reference's per-pair insertion sorts, NeighborhoodGraph.h:80-105).
* ``merge_candidates`` — two (N, C) candidate lists into the best C unique
  neighbours.
* ``rng_select`` — the RNG pruning rule (RelativeNeighborhoodGraph.h:
  18-35), slot-major: each of the <= m steps keeps every row's first
  candidate not yet occluded and marks everything it occludes; the JAX
  package's ``fori_loop`` over slots is a Python loop here.

Every top-k is a stable sort (``lax.top_k``'s lowest-index rule) and every
first-True pick an ``argmax`` (first occurrence), so ids equal the JAX
package's wherever the distances do.
"""

from __future__ import annotations

import torch

from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.utils import costmodel

MAX_DIST = float(3.4e38)


def _batch_pairwise(a: torch.Tensor, b: torch.Tensor, metric: int,
                    base: int) -> torch.Tensor:
    """(B, P, D) x (B, C, D) float32 -> (B, P, C) distances: squared L2
    (metric 0) or ``base^2 - dot`` (metric 1, rows normalized to `base`)."""
    dot = torch.einsum("bpd,bcd->bpc", a, b)
    if metric == 1:
        return float(base) * float(base) - dot
    an = (a * a).sum(-1)[..., None]
    bn = (b * b).sum(-1)[:, None, :]
    return torch.clamp_min(an + bn - 2.0 * dot, 0.0)


def leaf_allpairs_topk(vecs: torch.Tensor, valid: torch.Tensor,
                       num_candidates: int, metric: int, base: int):
    """All-pairs nearest neighbours inside each leaf of a batch.

    vecs (B, P, D) float32 padded leaf members, valid (B, P) bool ->
    (pos (B, P, num_candidates) int32 positions within the leaf, -1 for
    empty slots; dists (B, P, num_candidates) float32, MAX_DIST padded)."""
    B, P, _ = vecs.shape
    d = _batch_pairwise(vecs, vecs, metric, base)          # (B, P, P)
    eye = torch.eye(P, dtype=torch.bool, device=vecs.device)[None]
    d = torch.where(eye | ~valid[:, None, :] | ~valid[:, :, None],
                    MAX_DIST, d)
    k = min(num_candidates, P)
    dists, pos = dist_ops.smallest_k(d.reshape(B * P, P), k)
    dists = dists.reshape(B, P, k)
    pos = torch.where(dists >= MAX_DIST, -1, pos.reshape(B, P, k)).to(
        torch.int32)
    if k < num_candidates:
        pad = num_candidates - k
        pos = torch.cat([pos, pos.new_full((B, P, pad), -1)], dim=-1)
        dists = torch.cat([dists, dists.new_full((B, P, pad), MAX_DIST)],
                          dim=-1)
    return pos, dists


def merge_candidates(cand_ids: torch.Tensor, cand_d: torch.Tensor,
                     new_ids: torch.Tensor, new_d: torch.Tensor):
    """Merge two (N, C) candidate lists into the best C unique neighbours:
    concatenate, sort by distance, stable-sort by id so duplicates sit
    best-first side by side, keep the first of each, top-C by distance.
    Returns (ids (N, C) int32 -1 padded, dists (N, C) float32 MAX_DIST
    padded), ascending."""
    C = cand_ids.shape[1]
    ids = torch.cat([cand_ids, new_ids], dim=1).to(torch.int64)
    d = torch.cat([cand_d, new_d], dim=1)
    d_order = torch.argsort(d, dim=1, stable=True)
    ids_d = torch.gather(ids, 1, d_order)
    d_d = torch.gather(d, 1, d_order)
    id_order = torch.argsort(torch.where(ids_d < 0, 2 ** 31 - 1, ids_d),
                             dim=1, stable=True)
    ids_s = torch.gather(ids_d, 1, id_order)
    d_s = torch.gather(d_d, 1, id_order)
    dup = torch.cat([torch.zeros_like(ids_s[:, :1], dtype=torch.bool),
                     ids_s[:, 1:] == ids_s[:, :-1]], dim=1)
    d_s = torch.where(dup | (ids_s < 0), MAX_DIST, d_s)
    out_d, pos = dist_ops.smallest_k(d_s, C)
    out_ids = torch.gather(ids_s, 1, pos)
    out_ids = torch.where(out_d >= MAX_DIST, -1, out_ids)
    return out_ids.to(torch.int32), out_d


def node_candidate_dists(node_vecs: torch.Tensor, cand_vecs: torch.Tensor,
                         metric: int, base: int) -> torch.Tensor:
    """(U, D) node vectors x (U, C, D) per-node candidates -> (U, C)."""
    return _batch_pairwise(node_vecs[:, None, :], cand_vecs, metric,
                           base)[:, 0, :]


def rng_select(cand_vecs: torch.Tensor, cand_dists: torch.Tensor,
               cand_valid: torch.Tensor, m: int, metric: int, base: int
               ) -> torch.Tensor:
    """The RNG rule over candidate lists sorted ascending by distance to
    their node: candidate j is kept iff no already-kept g has
    dist(g, j) <= dist(node, j), until m are kept; slots the rule leaves
    empty are filled with the nearest occluded candidates (the batched
    walk seeds once, so row degree must carry connectivity).

    cand_vecs (B, C, D) float32, cand_dists (B, C), cand_valid (B, C) bool
    -> (B, m) int32 positions into C, kept first then fill, -1 padded."""
    B, C, _ = cand_vecs.shape
    dev = cand_vecs.device
    cf = cand_vecs.to(torch.float32)
    if metric != 1:
        cnorm = (cf * cf).sum(-1)                              # (B, C)
    pos = torch.arange(C, device=dev)[None, :]
    keep_mask = torch.zeros((B, C), dtype=torch.bool, device=dev)
    blocked = ~cand_valid
    for _ in range(min(m, C)):
        avail = ~blocked
        j = torch.argmax(avail.to(torch.uint8), dim=1)         # first True
        exists = torch.gather(avail, 1, j[:, None])[:, 0]
        keep_mask = keep_mask | (exists[:, None] & (pos == j[:, None]))
        gvec = cf[torch.arange(B, device=dev), j]              # (B, D)
        dot = torch.einsum("bd,bcd->bc", gvec, cf)
        if metric == 1:
            gd = float(base) * float(base) - dot
        else:
            gn = torch.gather(cnorm, 1, j[:, None])
            gd = torch.clamp_min(gn + cnorm - 2.0 * dot, 0.0)
        occ = exists[:, None] & (gd <= cand_dists)
        blocked = blocked | occ | keep_mask

    n_kept = keep_mask.sum(1, keepdim=True)
    rank_kept = torch.cumsum(keep_mask.to(torch.int64), dim=1) - 1
    fill_mask = cand_valid & ~keep_mask
    rank_fill = torch.cumsum(fill_mask.to(torch.int64), dim=1) - 1
    k = min(m, C)
    src = torch.where(keep_mask, rank_kept,
                      torch.where(fill_mask, n_kept + rank_fill, k))
    src = torch.clamp_max(src, k)                              # k: dump slot
    out = torch.full((B, k + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, src, pos.expand(B, C).to(torch.int32))
    out = out[:, :k]
    if k < m:
        out = torch.cat([out, out.new_full((B, m - k), -1)], dim=1)
    return out


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py): build-time kernels; the
# formulas carry the dominant contraction terms (the JAX package's)
# ---------------------------------------------------------------------------

def _leaf_allpairs_cost(B, P, D, num_candidates, **_):
    flops = 2.0 * B * P * P * D + costmodel.topk_flops(B * P, P)
    nbytes = 2.0 * B * P * D * 4 + 3.0 * B * P * P * 4 \
        + 2.0 * B * P * num_candidates * 4
    return flops, nbytes


def _merge_candidates_cost(N, C, **_):
    flops = 64.0 * N * C          # three sorts + dedupe + top-k
    nbytes = 12.0 * N * C * 4
    return flops, nbytes


def _node_candidate_dists_cost(U, C, D, **_):
    return 2.0 * U * C * D, 2.0 * U * C * D * 4 + U * C * 4


def _rng_select_cost(B, C, D, m, **_):
    steps = min(m, C)
    flops = 2.0 * B * C * D * steps + 8.0 * B * C * steps
    nbytes = B * C * D * 4 + 8.0 * B * C * 4 * steps
    return flops, nbytes


costmodel.register("graph.leaf_allpairs", leaf_allpairs_topk,
                   _leaf_allpairs_cost)
costmodel.register("graph.merge_candidates", merge_candidates,
                   _merge_candidates_cost)
costmodel.register("graph.node_candidate_dists", node_candidate_dists,
                   _node_candidate_dists_cost)
costmodel.register("graph.rng_select", rng_select, _rng_select_cost)
