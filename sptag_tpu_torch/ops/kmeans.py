"""Batched k-means for the BKT tree build (port of
``sptag_tpu/ops/kmeans.py``).

Every node of a tree level is one row of a (B, P, D) padded batch and all
of them run k-means at once as batched matrix products.  SPTAG's semantics
(BKTree.h:324-503), as the JAX package keeps them:

* count-balancing: assignment cost ``dist + lambda*count[k]`` with
  ``lambda = base^2 / (100 * node_size)``;
* several random restarts, keeping the lowest-cost initialization;
* Lloyd iterations on a bounded sample of the node, final assignment over
  the whole node;
* centers re-normalized for cosine;
* the final assignment records each cluster's member closest to its center
  (the child node's centerid);
* an empty cluster is re-seeded from the sample farthest from its center.

The random restarts draw from an explicit ``torch.Generator``; its numbers
differ from ``jax.random``'s, so the two packages build different trees
from the same seed.
"""

from __future__ import annotations

import torch

from sptag_tpu_torch.utils import costmodel

MAX_DIST = 3.4e38


def _pairwise(data: torch.Tensor, centers: torch.Tensor, metric: int,
              base: int) -> torch.Tensor:
    """(B, P, D) x (B, K, D) -> (B, P, K) distances: 0 = squared L2,
    1 = cosine ``base^2 - dot`` (centers are kept base-normalized)."""
    dot = torch.einsum("bpd,bkd->bpk", data, centers)
    if metric == 1:
        return float(base) * float(base) - dot
    dn = (data * data).sum(-1)[..., None]
    cn = (centers * centers).sum(-1)[:, None, :]
    return torch.clamp_min(dn + cn - 2.0 * dot, 0.0)


def _assign(data, valid, centers, counts, lam, metric, base):
    """-> (labels (B, P), dist-to-own (B, P), cost (B,))."""
    d = _pairwise(data, centers, metric, base)
    penalized = d + lam[:, None, None] * counts[:, None, :].to(torch.float32)
    labels = torch.argmin(penalized, dim=-1)
    own = torch.gather(d, -1, labels[..., None])[..., 0]
    own = torch.where(valid, own, 0.0)
    cost = torch.where(valid, torch.gather(penalized, -1, labels[..., None])
                       [..., 0], 0.0).sum(-1)
    return labels, own, cost


def _update_centers(data, valid, labels, own, K, metric, base):
    """Mean update + cosine renorm + empty-cluster reseed."""
    onehot = (torch.nn.functional.one_hot(labels, K).to(torch.float32)
              * valid[..., None].to(torch.float32))        # (B, P, K)
    counts = onehot.sum(1)                                 # (B, K)
    sums = torch.einsum("bpk,bpd->bkd", onehot, data)
    means = sums / torch.clamp_min(counts, 1.0)[..., None]
    if metric == 1:
        norm = torch.sqrt((means * means).sum(-1, keepdim=True))
        means = means / torch.clamp_min(norm, 1e-30) * float(base)
    far = torch.argmax(torch.where(valid, own, -1.0), dim=-1)      # (B,)
    far_vec = torch.gather(
        data, 1, far[:, None, None].expand(-1, 1, data.shape[2]))  # (B,1,D)
    centers = torch.where((counts <= 0.0)[..., None], far_vec, means)
    return centers, counts.to(torch.int32)


def kmeans_fit(data: torch.Tensor, valid: torch.Tensor,
               generator: torch.Generator, K: int, iters: int,
               restarts: int, metric: int, base: int):
    """Fit K centers per batch row.  data (B, P, D) float32, valid (B, P)
    bool.  Returns (centers (B, K, D) float32, counts (B, K) int32)."""
    B, P, D = data.shape
    nvalid = valid.sum(-1)
    lam = (float(base) * float(base)
           / (100.0 * torch.clamp_min(nvalid.to(torch.float32), 1.0)))
    zero_counts = torch.zeros((B, K), dtype=torch.int32, device=data.device)
    best_centers = best_cost = None
    for _ in range(restarts):
        # K random valid samples as the initial centers
        u = torch.rand((B, P), generator=generator, device=data.device)
        u = torch.where(valid, u, -1.0)
        pos = torch.topk(u, K, dim=-1).indices                      # (B, K)
        centers = torch.gather(data, 1, pos[..., None].expand(-1, -1, D))
        _, _, cost = _assign(data, valid, centers, zero_counts,
                             torch.zeros_like(lam), metric, base)
        if best_cost is None:
            best_centers, best_cost = centers, cost
        else:
            better = cost < best_cost           # first restart wins ties
            best_centers = torch.where(better[:, None, None], centers,
                                       best_centers)
            best_cost = torch.where(better, cost, best_cost)
    centers, counts = best_centers, zero_counts
    for _ in range(iters):
        labels, own, _ = _assign(data, valid, centers, counts, lam,
                                 metric, base)
        centers, counts = _update_centers(data, valid, labels, own, K,
                                          metric, base)
    return centers, counts


def kmeans_final_assign(data: torch.Tensor, valid: torch.Tensor,
                        centers: torch.Tensor, K: int, metric: int,
                        base: int):
    """Full-node assignment with lambda = 0 plus per-cluster medoid (the
    member closest to its center).  Returns (labels (B, P) int32, -1 for
    padding; counts (B, K) int32; medoid_pos (B, K) int32, -1 if empty)."""
    d = _pairwise(data, centers, metric, base)
    d = torch.where(valid[..., None], d, MAX_DIST)
    labels = torch.argmin(d, dim=-1)
    own = torch.gather(d, -1, labels[..., None])[..., 0]
    member = ((labels[..., None]
               == torch.arange(K, device=data.device)[None, None, :])
              & valid[..., None])                                  # (B,P,K)
    counts = member.sum(1).to(torch.int32)
    member_d = torch.where(member, own[..., None], MAX_DIST)
    medoid_pos = torch.argmin(member_d, dim=1).to(torch.int32)
    medoid_pos = torch.where(counts > 0, medoid_pos, -1)
    labels = torch.where(valid, labels.to(torch.int32), -1)
    return labels, counts, medoid_pos


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py): build-time kernels, the Lloyd
# loop's body counted once (the JAX package's formulas)
# ---------------------------------------------------------------------------

def _kmeans_fit_cost(B, P, D, K, restarts, **_):
    assign = 2.0 * B * P * K * D + 4.0 * B * P * K
    flops = (restarts + 1.0) * assign + 2.0 * B * K * D
    nbytes = (restarts + 2.0) * (B * P * D * 4 + B * P * K * 4) \
        + 2.0 * B * K * D * 4
    return flops, nbytes


def _kmeans_assign_cost(B, P, D, K, **_):
    flops = 2.0 * B * P * K * D + 6.0 * B * P * K
    nbytes = B * P * D * 4 + B * K * D * 4 + 5.0 * B * P * K * 4
    return flops, nbytes


costmodel.register("kmeans.fit", kmeans_fit, _kmeans_fit_cost)
costmodel.register("kmeans.final_assign", kmeans_final_assign,
                   _kmeans_assign_cost)
