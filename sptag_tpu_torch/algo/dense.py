"""Dense tree-partition search (port of ``sptag_tpu/algo/dense.py``).

The first tree of the BKT forest (or of the KDT forest: kd cells) is cut
into subtrees of about ``DenseClusterSize`` samples; the corpus is re-laid
out cluster-contiguously as one (C, P, D) block tensor on the device (P =
padded cluster size, padding rows carry id -1 and squared norm 0).  A query
batch scores every block mean with one (Q, C) matrix product, takes its
``nprobe = ceil(MaxCheck / P)`` nearest blocks, scores every row of them
with the hand-written block-dot kernels (ops/block_dots.py) and keeps a
masked top-k.
With ``DenseQueryGroup`` the batch is sorted by nearest block, split into
groups, and each group scores the union of its members' probes.

Everything that decides which candidates a query sees or how ties fall is
kept from the JAX package: the P alignment, the grouping rules (adaptive
cap, G <= U clamp, the dtype floor on G), the chunk sizing from
``_GATHER_BUDGET``, the query-bucket padding, the metric algebra, the
replica de-duplication, and ``lax.top_k``'s lowest-index-first tie rule
(stable sorts throughout).  The chunks run as a Python loop.

With ``CascadeSearch`` on a float corpus the block layout holds the int8
quantization (a quarter of the bytes): queries ``q / scale`` in float32
score against it through the block-dot kernels' float32 x int8 variant
(the JAX package's XLA branch), the probe prefilter takes the place of
the sketch tier, and the ``TierBudgetInt8``-wide shortlist is re-ranked
exactly against the float32 rows — the resident corpus (``device``) or
rows fetched from host memory (``host``; ``host_all`` acts as ``host``)
— by ops/cascade.py's fixed-order re-rank, so both tiers return the same
ids and distance bits.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.ops import block_dots
from sptag_tpu_torch.ops import cascade as cascade_ops
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import walk_dots as walk_ops
from sptag_tpu_torch.ops import topk_bins
from sptag_tpu_torch.utils import costmodel, devmem, query_bucket, round_up

log = logging.getLogger(__name__)

# float32-exact, so comparisons against float32 tensors are exact too
MAX_DIST = float(np.float32(3.4e38))

# score-buffer budget per chunk (bytes): Q * nprobe * P * D * 4
_GATHER_BUDGET = 1 << 30


def partition_from_tree(tree, n: int, target_size: int
                        ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Cut the first BKT tree into subtrees of <= target_size samples.

    Returns (cut-node center sample ids (C,), C member id arrays — every
    sample id in [0, n) appears in exactly one cluster)."""
    nodes = tree.nodes
    cid = nodes["centerid"].astype(np.int64)
    cs = nodes["childStart"].astype(np.int64)
    ce = nodes["childEnd"].astype(np.int64)
    start = int(tree.tree_starts[0])
    end = int(tree.tree_starts[1]) if len(tree.tree_starts) > 1 \
        else len(nodes)

    def children(ni: int) -> range:
        # leaf: cs == -1 and ce <= 0; a duplicate node negates childStart
        if cs[ni] >= 0:
            return range(int(cs[ni]), int(ce[ni]))
        if cs[ni] < -1 or (cs[ni] == -1 and ce[ni] > 0):
            return range(int(-cs[ni]), int(ce[ni]))
        return range(0)

    def sample_of(ni: int) -> int:
        # the root's centerid is the build-time sample count, not a sample
        if ni == start:
            return -1
        c = int(cid[ni])
        return c if 0 <= c < n else -1

    # bottom-up subtree sample counts (children follow their parents)
    counts = np.zeros(end - start, np.int64)
    for ni in range(end - 1, start - 1, -1):
        c = 1 if sample_of(ni) >= 0 else 0
        for ch in children(ni):
            c += counts[ch - start]
        counts[ni - start] = c

    # top-down BFS: a node becomes a cluster root once its subtree fits
    roots: List[int] = []
    loose: List[int] = []          # interior-node center samples above cuts
    frontier = [start]
    while frontier:
        nxt: List[int] = []
        for ni in frontier:
            if counts[ni - start] == 0:
                continue
            kids = children(ni)
            if counts[ni - start] <= target_size or len(kids) == 0:
                roots.append(ni)
            else:
                nxt.extend(kids)
                if sample_of(ni) >= 0:
                    loose.append(sample_of(ni))
        frontier = nxt

    clusters: List[np.ndarray] = []
    centers: List[int] = []
    for r in roots:
        members: List[int] = []
        stack = [r]
        while stack:
            ni = stack.pop()
            if sample_of(ni) >= 0:
                members.append(sample_of(ni))
            stack.extend(children(ni))
        if members:
            clusters.append(np.asarray(members, np.int64))
            centers.append(sample_of(r) if sample_of(r) >= 0 else members[0])
    # center samples of nodes above the cut join the smallest cluster
    for s in loose:
        smallest = min(range(len(clusters)), key=lambda i: len(clusters[i]))
        clusters[smallest] = np.append(clusters[smallest], s)

    return _pack_clusters(clusters, centers, target_size)


def partition_from_kdtree(tree, n: int, target_size: int
                          ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Cut the first kd-tree into subtrees of <= target_size samples.

    The kd-tree analog of `partition_from_tree` (``sptag_tpu/algo/
    dense.py::partition_from_kdtree``): kd nodes store left/right child
    node indices with ``-id-1`` encodings for single-sample leaves, and
    children always follow their parent, so a reverse scan yields subtree
    sizes and a BFS emits the cut.  A kd cell is an axis-aligned box, so
    block means rank blocks well.  Returns (center sample ids (C,), C
    member arrays covering [0, n) exactly once)."""
    nodes = tree.nodes
    left = nodes["left"].astype(np.int64)
    right = nodes["right"].astype(np.int64)
    start = int(tree.tree_starts[0])
    end = int(tree.tree_starts[1]) if len(tree.tree_starts) > 1 \
        else len(nodes)

    def kids(ni: int):
        return (int(left[ni]), int(right[ni]))

    # bottom-up subtree sample counts (children appended after parents)
    counts = np.zeros(end - start, np.int64)
    for ni in range(end - 1, start - 1, -1):
        c = 0
        for ch in kids(ni):
            c += 1 if ch < 0 else int(counts[ch - start])
        counts[ni - start] = c

    def collect(ni: int) -> List[int]:
        out: List[int] = []
        stack = [ni]
        while stack:
            cur = stack.pop()
            for ch in kids(cur):
                if ch < 0:
                    sid = -ch - 1
                    if 0 <= sid < n:
                        out.append(sid)
                else:
                    stack.append(ch)
        return out

    clusters: List[np.ndarray] = []
    centers: List[int] = []
    loose: List[int] = []
    frontier = [start]
    while frontier:
        nxt: List[int] = []
        for ni in frontier:
            if counts[ni - start] == 0:
                continue
            if counts[ni - start] <= target_size:
                members = collect(ni)
                if members:
                    # degenerate duplicate leaves (one-row corpus) collapse
                    members = sorted(set(members))
                    clusters.append(np.asarray(members, np.int64))
                    centers.append(members[0])
            else:
                for ch in kids(ni):
                    if ch < 0:
                        sid = -ch - 1
                        if 0 <= sid < n:
                            loose.append(sid)
                    else:
                        nxt.append(ch)
        frontier = nxt
    if loose and not clusters:
        clusters.append(np.asarray(sorted(set(loose)), np.int64))
        centers.append(clusters[0][0])
        loose = []
    for s in loose:
        smallest = min(range(len(clusters)), key=lambda i: len(clusters[i]))
        clusters[smallest] = np.append(clusters[smallest], s)
    return _pack_clusters(clusters, centers, target_size)


def _pack_clusters(clusters: List[np.ndarray], centers: List[int],
                   target_size: int
                   ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Greedily merge adjacent (tree-sibling) small clusters into near-full
    blocks; a merged block keeps the center of its largest constituent."""
    packed_c: List[np.ndarray] = []
    packed_id: List[int] = []
    cur: List[np.ndarray] = []
    cur_center, cur_best, cur_n = -1, -1, 0
    for ci in range(len(clusters)):
        sz = len(clusters[ci])
        if cur_n and cur_n + sz > target_size:
            packed_c.append(np.concatenate(cur))
            packed_id.append(cur_center)
            cur, cur_center, cur_best, cur_n = [], -1, -1, 0
        cur.append(clusters[ci])
        if sz > cur_best:
            cur_best, cur_center = sz, centers[ci]
        cur_n += sz
    if cur_n:
        packed_c.append(np.concatenate(cur))
        packed_id.append(cur_center)
    return np.asarray(packed_id, np.int64), packed_c


def _sorted_dup_mask(ids: torch.Tensor) -> torch.Tensor:
    """(Q, X) ids -> (Q, X) bool: True at every repeat of an id after its
    first occurrence (``sptag_tpu/algo/engine.py::_sorted_dup_mask``):
    one stable sort, the inverse order by a scatter."""
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = torch.gather(ids, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros_like(sorted_ids[:, :1], dtype=torch.bool),
         sorted_ids[:, 1:] == sorted_ids[:, :-1]], dim=1)
    return torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)


def _finalize_topk(nd: torch.Tensor, ids: torch.Tensor,
                   deleted: torch.Tensor, dedup: bool, k: int,
                   extra_dead: Optional[torch.Tensor] = None,
                   binned_bins: int = 0):
    """Tombstone/sentinel masking, optional replica de-duplication, masked
    top-k (lowest index first among ties), -1 id sentinel.  `binned_bins`
    > 0 selects through the bin reduction (ops/topk_bins.py, BinnedTopK)."""
    dead = deleted[torch.clamp_min(ids, 0).long()] | (ids < 0)
    if extra_dead is not None:
        dead = dead | extra_dead
    nd = torch.where(dead, MAX_DIST, nd)
    if dedup:
        # replicated rows appear in several probed blocks with identical
        # distances: keep one occurrence
        nd = torch.where(_sorted_dup_mask(torch.where(ids >= 0, ids, -1))
                         & (ids >= 0), MAX_DIST, nd)
    k_eff = min(k, nd.shape[1])
    if binned_bins:
        out_d, pos = topk_bins.binned_topk(nd, k_eff, binned_bins)
    else:
        out_d, pos = dist_ops.smallest_k(nd, k_eff)
    out_ids = torch.gather(ids, 1, pos)
    out_ids = torch.where(out_d < MAX_DIST, out_ids, -1)
    return out_d, out_ids.to(torch.int32)


def _kernel_ok(data_perm: torch.Tensor, queries: torch.Tensor) -> bool:
    """The block-dot kernels take float32 blocks, or int8 blocks with int8
    queries or float32 ones (the cascade's quantized layout); other value
    types score through a gather, as the JAX package's XLA path does."""
    return (data_perm.dtype == torch.float32
            or (data_perm.dtype == torch.int8
                and queries.dtype in (torch.int8, torch.float32)))


def _kernel_queries(data_perm: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """int8 queries against int8 blocks (exact int32 dots); float32
    otherwise."""
    if data_perm.dtype == torch.int8 and queries.dtype == torch.int8:
        return queries
    return queries.to(torch.float32)


def probe_choice(queries, centroids, cent_sq, metric: int, nprobe: int,
                 cent_valid: Optional[torch.Tensor] = None):
    """(Q, D) queries -> (ascending block-mean distances, block ids), both
    (Q, nprobe).  Block means are float32 even for integer corpora, so they
    are scored with float queries.  `cent_valid` (C,) masks the padding
    blocks of a mesh shard's layout (`DenseTreeSearcher.pad_layout`) out of
    the ranking."""
    d0 = dist_ops.pairwise_distance(queries.to(torch.float32), centroids,
                                    DistCalcMethod(metric), x_sqnorm=cent_sq)
    if cent_valid is not None:
        d0 = torch.where(cent_valid[None, :], d0, MAX_DIST)
    return dist_ops.smallest_k(d0, nprobe)


def _dense_search_kernel(data_perm, member_ids, member_sq, centroids,
                         cent_sq, deleted, queries, k: int, nprobe: int,
                         metric: int, base: int, dedup: bool = False,
                         binned_bins: int = 0,
                         cent_valid: Optional[torch.Tensor] = None):
    """(Q, C) block scores -> top-nprobe blocks -> (Q, nprobe*P) candidate
    scores -> masked top-k.  `cent_valid`: see `probe_choice`."""
    Q = queries.shape[0]
    C, P, D = data_perm.shape
    _, topc = probe_choice(queries, centroids, cent_sq, metric, nprobe,
                           cent_valid)
    ids = member_ids[topc].reshape(Q, nprobe * P)
    sq = member_sq[topc].reshape(Q, nprobe * P)
    if _kernel_ok(data_perm, queries):
        q_in = _kernel_queries(data_perm, queries)
        dot = block_dots.probe_block_dots(
            data_perm, q_in.contiguous(), topc.to(torch.int32).contiguous()
        ).reshape(Q, nprobe * P).to(torch.float32)
        if int(metric) == int(DistCalcMethod.Cosine):
            nd = float(base) * float(base) - dot
        else:
            qf = queries.to(torch.float32)
            qn = (qf * qf).sum(-1)[:, None]
            nd = torch.clamp_min(qn + sq - 2.0 * dot, 0.0)
    else:
        vecs = data_perm[topc].reshape(Q, nprobe * P, D)
        nd = dist_ops.batched_gathered_distance(
            queries, vecs, DistCalcMethod(metric), base, sq)
    return _finalize_topk(nd, ids, deleted, dedup, k,
                          binned_bins=binned_bins)


def _segmented_min(vals: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Per row, the minimum of each run (`first` marks run starts),
    broadcast over the run — at a run's last element it equals the JAX
    package's segmented inclusive min-scan."""
    run = torch.cumsum(first.to(torch.int64), dim=1) - 1
    mins = torch.full_like(vals, float("inf")).scatter_reduce(
        1, run, vals, reduce="amin", include_self=True)
    return torch.gather(mins, 1, run)


def group_union(queries, centroids, cent_sq, nq_valid: int, nprobe: int,
                U: int, G: int, metric: int):
    """Sort a chunk's queries by nearest block and rank each group's union
    of probed blocks.  Returns (order, inverse order, union (NG, U) with -1
    for empty slots).

    The union ranks blocks by probe RANK first, with the block's distance
    position within its query's own probe spread as tie-break; with G <= U
    every query's top-1 block survives the top-U cut.  Queries from
    `nq_valid` on are padding: they sort last and claim no union slots."""
    Q = queries.shape[0]
    C = centroids.shape[0]
    NG = Q // G
    dev = queries.device
    dc, topc = probe_choice(queries, centroids, cent_sq, metric, nprobe)
    valid = torch.arange(Q, device=dev) < nq_valid
    order = torch.argsort(torch.where(valid, topc[:, 0], C), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Q, device=dev)
    topc_s = topc[order].reshape(NG, G * nprobe)
    rel = dc - dc[:, :1]
    tie = rel / (rel[:, -1:] + 1e-20) * 0.999
    comp = torch.arange(nprobe, dtype=torch.float32, device=dev)[None, :] \
        + tie
    comp = torch.where(valid[:, None], comp, MAX_DIST)
    topd_s = comp[order].reshape(NG, G * nprobe)

    # distinct union blocks per group ranked by their best score: sort by
    # block id, min over each run, keep each run's last element
    o2 = torch.argsort(topc_s, dim=1, stable=True)
    bid = torch.gather(topc_s, 1, o2)
    bd = torch.gather(topd_s, 1, o2)
    change = bid[:, 1:] != bid[:, :-1]
    ones = torch.ones((NG, 1), dtype=torch.bool, device=dev)
    mn = _segmented_min(bd, torch.cat([ones, change], dim=1))
    rank_d = torch.where(torch.cat([change, ones], dim=1), mn, MAX_DIST)
    rvals, upos = dist_ops.smallest_k(rank_d, U)
    union = torch.where(rvals < MAX_DIST, torch.gather(bid, 1, upos), -1)
    return order, inv, union


def _dense_search_grouped_kernel(data_perm, member_ids, member_sq, centroids,
                                 cent_sq, deleted, queries, nq_valid: int,
                                 k: int, nprobe: int, U: int, G: int,
                                 metric: int, base: int,
                                 dedup: bool = False, binned_bins: int = 0):
    """Query-grouped probing: every query of a group is scored against the
    group's U-block union as (G, D) x (D, P) products; results come back in
    the caller's query order."""
    Q = queries.shape[0]
    C, P, D = data_perm.shape
    NG = Q // G
    order, inv, union = group_union(queries, centroids, cent_sq, nq_valid,
                                    nprobe, U, G, metric)
    qs = queries[order]
    qsf = qs.to(torch.float32)
    union_safe = torch.clamp_min(union, 0).to(torch.int32)
    ids_u = member_ids[union_safe]                           # (NG, U, P)
    sq_u = member_sq[union_safe]
    if _kernel_ok(data_perm, queries):
        q_in = _kernel_queries(data_perm, qs)
        dot = block_dots.group_block_dots(
            data_perm, q_in.contiguous(), union_safe.contiguous()
        ).to(torch.float32).permute(0, 2, 1, 3)              # (NG, G, U, P)
    else:
        vecs = data_perm[union_safe]                         # (NG, U, P, D)
        if dist_ops.exact_int_dot(queries.dtype):
            dot = dist_ops.int_contract(
                "gqd,gupd->gqup", qs.reshape(NG, G, D), vecs
            ).to(torch.float32)
        else:
            # int16 included: float32 accumulation, as the JAX package
            dot = torch.einsum("gqd,gupd->gqup", qsf.reshape(NG, G, D),
                               vecs.to(torch.float32))
    if int(metric) == int(DistCalcMethod.Cosine):
        nd = float(base) * float(base) - dot
    else:
        qn = (qsf * qsf).sum(-1).reshape(NG, G, 1, 1)
        nd = torch.clamp_min(qn + sq_u[:, None, :, :] - 2.0 * dot, 0.0)
    ids = ids_u[:, None, :, :].expand(NG, G, U, P).reshape(Q, U * P)
    pad_blocks = (union < 0)[:, None, :, None].expand(NG, G, U, P) \
        .reshape(Q, U * P)
    out_d, out_ids = _finalize_topk(nd.reshape(Q, U * P), ids, deleted,
                                    dedup, k, extra_dead=pad_blocks,
                                    binned_bins=binned_bins)
    return out_d[inv], out_ids[inv]


def replicate_clusters(data: np.ndarray, clusters: List[np.ndarray],
                       replicas: int, metric: DistCalcMethod,
                       device: torch.device, chunk: int = 8192
                       ) -> List[np.ndarray]:
    """Closure assignment: append every row to its `replicas - 1` nearest
    OTHER blocks by block-mean distance, each block taking at most
    ``len(block) * (replicas - 1)`` of its closest such rows."""
    if replicas <= 1:
        return clusters
    means = np.stack([data[c].astype(np.float32).mean(axis=0)
                      for c in clusters])
    own = np.full(data.shape[0], -1, np.int64)
    for ci, c in enumerate(clusters):
        own[c] = ci
    extra = min(replicas - 1, len(clusters) - 1)
    means_d = torch.from_numpy(means).to(device)
    msq_d = torch.from_numpy((means ** 2).sum(1, dtype=np.float32)).to(device)
    chunk_rows, chunk_blocks, chunk_dists = [], [], []
    for off in range(0, data.shape[0], chunk):
        rows = np.arange(off, min(off + chunk, data.shape[0]))
        rows = rows[own[rows] >= 0]
        if not len(rows):
            continue
        q = torch.from_numpy(data[rows].astype(np.float32)).to(device)
        if metric == DistCalcMethod.Cosine:
            d = -(q @ means_d.T)
        else:
            d = ((q * q).sum(1)[:, None] + msq_d[None, :]
                 - 2.0 * (q @ means_d.T))
        d[torch.arange(len(rows), device=device),
          torch.from_numpy(own[rows]).to(device)] = float("inf")
        dtop, top = dist_ops.smallest_k(d, extra)
        chunk_rows.append(np.repeat(rows, extra))
        chunk_blocks.append(top.cpu().numpy().ravel())
        chunk_dists.append(dtop.cpu().numpy().ravel())
    if not chunk_rows:
        return clusters
    all_rows = np.concatenate(chunk_rows)
    all_blocks = np.concatenate(chunk_blocks)
    all_dists = np.concatenate(chunk_dists)
    order = np.argsort(all_blocks, kind="stable")
    all_rows, all_blocks, all_dists = (
        all_rows[order], all_blocks[order], all_dists[order])
    starts = np.searchsorted(all_blocks, np.arange(len(clusters) + 1))
    out = []
    for ci, c in enumerate(clusters):
        lo, hi = starts[ci], starts[ci + 1]
        cap = len(c) * (replicas - 1)
        rows_b, dists_b = all_rows[lo:hi], all_dists[lo:hi]
        if len(rows_b) > cap:              # keep the closest boundary rows
            keep = np.argpartition(dists_b, cap - 1)[:cap] if cap else []
            rows_b = rows_b[keep]
        out.append(np.concatenate([c, rows_b.astype(np.int64)])
                   if len(rows_b) else c)
    return out


class DenseTreeSearcher:
    """Device snapshot of the cluster-contiguous layout.

    Probes are ranked by block MEANS.  With `replicas` > 1 the blocks hold
    closure-assigned duplicate rows and the search de-duplicates ids before
    its final top-k."""

    @staticmethod
    def build_layout(data: np.ndarray, clusters: List[np.ndarray],
                     metric: DistCalcMethod, replicas: int = 1,
                     device: DeviceLike = None) -> dict:
        """Host (numpy) layout: packed blocks, member ids, squared norms,
        block-mean centroids — the JAX package's ``build_layout`` dict."""
        clusters = replicate_clusters(
            data, clusters, max(1, replicas), DistCalcMethod(metric),
            resolve_device(device))
        C = len(clusters)
        p_align = 32 if np.dtype(data.dtype) == np.int8 else 8
        P = round_up(max(len(c) for c in clusters), p_align)
        D = data.shape[1]
        perm = np.zeros((C, P, D), data.dtype)
        mids = np.full((C, P), -1, np.int32)
        for i, members in enumerate(clusters):
            perm[i, :len(members)] = data[members]
            mids[i, :len(members)] = members
        flat = perm.reshape(C * P, D)
        if np.issubdtype(perm.dtype, np.integer):
            sq = (flat.astype(np.int64) ** 2).sum(1).astype(np.float32)
        else:
            sq = (flat.astype(np.float32) ** 2).sum(1, dtype=np.float32)
        means = np.stack([data[members].astype(np.float32).mean(axis=0)
                          for members in clusters])
        cent_sq = (means ** 2).sum(1, dtype=np.float32)
        return dict(perm=perm, ids=mids, sq=sq.reshape(C, P), cent=means,
                    cent_sq=cent_sq, cluster_size=P, num_clusters=C)

    @staticmethod
    def pad_layout(lay: dict, C: int, Pb: int, dim: int) -> dict:
        """Pad one `build_layout` result to an agreed (C, Pb) geometry
        (shared by the mesh packer, parallel/sharded.py, and the
        multi-process build, parallel/multihost.py, so the padding cannot
        diverge): -1 ids, zero vectors and norms, and a centroid-validity
        mask over the real blocks."""
        c, p = lay["perm"].shape[:2]
        out = dict(
            dense_perm=np.zeros((C, Pb, dim), lay["perm"].dtype),
            dense_ids=np.full((C, Pb), -1, np.int32),
            dense_sq=np.zeros((C, Pb), np.float32),
            dense_cent=np.zeros((C, dim), np.float32),
            dense_cent_sq=np.zeros((C,), np.float32),
            dense_cent_valid=np.zeros((C,), bool),
        )
        out["dense_perm"][:c, :p] = lay["perm"]
        out["dense_ids"][:c, :p] = lay["ids"]
        out["dense_sq"][:c, :p] = lay["sq"]
        out["dense_cent"][:c] = lay["cent"]
        out["dense_cent_sq"][:c] = lay["cent_sq"]
        out["dense_cent_valid"][:c] = True
        return out

    def __init__(self, data: np.ndarray, clusters: List[np.ndarray],
                 deleted: Optional[np.ndarray], metric: DistCalcMethod,
                 base: int, replicas: int = 1,
                 device: DeviceLike = None,
                 cascade_cfg: Optional[dict] = None):
        """`cascade_cfg` ({"tier", "rerank_budget"}; ignored for integer
        corpora): the int8 layout with the exact float32 re-rank."""
        device = resolve_device(device)
        src = self._cascade_init(data, cascade_cfg, device)
        lay = self.build_layout(src, clusters, metric, replicas, device)
        self._place(lay, data.shape[0], deleted, metric, base, replicas,
                    device)

    def _cascade_init(self, data: np.ndarray, cfg: Optional[dict],
                      device: torch.device) -> np.ndarray:
        """Set the cascade's state; returns the rows the layout holds."""
        self.cascade_cfg = None
        self.scale = 0.0
        self.fp_d = self.fp_sq = None
        self.fp_host: Optional[np.ndarray] = None
        if cfg is None or not np.issubdtype(np.asarray(data).dtype,
                                            np.floating):
            return data
        tier = cascade_ops.normalize_tier(cfg.get("tier", "device"))
        if tier == "host_all":
            tier = "host"               # no sketch tier to keep resident
        fp = np.ascontiguousarray(np.asarray(data, np.float32))
        int8_np, self.scale = cascade_ops.quantize_int8(fp)
        self.cascade_cfg = {"tier": tier, "rerank_budget":
                            int(cfg.get("rerank_budget", 0) or 0)}
        if tier == "device":
            self.fp_d = torch.from_numpy(fp).to(device)
            if device.type == "cuda":
                # the re-rank kernel's norm table (ROWS mode computes the
                # same bits from fetched rows)
                self.fp_sq = walk_ops.row_sqnorms(self.fp_d)
        else:
            self.fp_host = fp
        return int8_np

    @classmethod
    def from_layout(cls, lay: dict, deleted: Optional[np.ndarray],
                    metric: DistCalcMethod, base: int, replicas: int = 1,
                    device: DeviceLike = None) -> "DenseTreeSearcher":
        """A searcher over an existing ``build_layout`` dict — either
        package's; the corpus size comes from the tombstone mask (or the
        largest member id when there is none)."""
        self = cls.__new__(cls)
        n = len(deleted) if deleted is not None \
            else int(np.asarray(lay["ids"]).max()) + 1
        self._cascade_init(lay["perm"], None, resolve_device(device))
        self._place(lay, n, deleted, metric, base, replicas,
                    resolve_device(device))
        return self

    def _place(self, lay, n, deleted, metric, base, replicas, device):
        self.metric = DistCalcMethod(metric)
        self.base = int(base)
        self.n = int(n)
        self.replicas = max(1, int(replicas))
        self.device = device
        self.cluster_size = int(lay["cluster_size"])
        self.num_clusters = int(lay["num_clusters"])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.data_perm = put(lay["perm"])
        self.member_ids = put(np.asarray(lay["ids"], np.int32))
        self.member_sq = put(np.asarray(lay["sq"], np.float32))
        self.centroids = put(np.asarray(lay["cent"], np.float32))
        self.cent_sq = put(np.asarray(lay["cent_sq"], np.float32))
        self.set_deleted(np.zeros(self.n, bool) if deleted is None
                         else deleted)
        self.last_effective_group = 0     # set by search(); diagnostic only
        self._demotions = set()
        self.register_devmem()

    def register_devmem(self) -> None:
        """(Re-)register the block layout's resident bytes under a
        dtype-split component (int8 blocks apart from float32 ones);
        called at placement and on DeviceBytesLedger re-enable."""
        lay_bytes = (self.data_perm.nbytes + self.member_ids.nbytes
                     + self.member_sq.nbytes + self.centroids.nbytes
                     + self.cent_sq.nbytes + self.deleted.nbytes)
        devmem.track("int8_blocks" if self.data_perm.dtype == torch.int8
                     else "dense_blocks", self, lay_bytes)
        if self.fp_d is not None:
            # the cascade's fp re-rank tier, resident (CorpusTier=device)
            devmem.track("corpus", self, self.fp_d.nbytes + (
                0 if self.fp_sq is None else self.fp_sq.nbytes))
        if self.fp_host is not None:
            # host memory: shown, excluded from the device total
            devmem.track("host_corpus", self, self.fp_host.nbytes,
                         host=True)

    def set_deleted(self, deleted: np.ndarray) -> None:
        """Swap only the tombstone mask."""
        self.deleted = torch.from_numpy(
            np.ascontiguousarray(deleted[:self.n], bool)).to(self.device)

    def _group_floor(self) -> int:
        """Smallest query-group size that keeps grouping on (8 float, 32
        int8).  The CUDA kernel has no such limit, but the JAX package
        applies it on every platform, so it decides which path runs."""
        return 32 if self.data_perm.dtype == torch.int8 else 8

    def _rerank_budget(self, k: int) -> int:
        """The fp tier's shortlist (TierBudgetInt8 under the cascade's
        budget rule: 0 = auto, a power of two, >= k, <= the corpus)."""
        n = max(self.n, 1)
        _, b2 = cascade_ops.resolve_budgets(
            n, self.cascade_cfg.get("rerank_budget", 0), k, n)
        return max(b2, min(k, self.n))

    def search(self, queries: np.ndarray, k: int, max_check: int = 2048,
               group: int = 0, union_factor: int = 2, binned: str = "off",
               recall_target: float = topk_bins.DEFAULT_RECALL_TARGET
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) host queries -> ((Q, k) float32 dists, (Q, k) int32 ids)
        as numpy, MAX_DIST / -1 padded.  `binned` (BinnedTopK: off / on /
        auto) routes the final select through the bin reduction, sized by
        `recall_target` over the scored row width.  Under the cascade the
        int8 scan's ``TierBudgetInt8`` shortlist is re-ranked exactly, so
        distances are float32 exact whatever the tier."""
        if self.cascade_cfg is None:
            return self._scan_topk(queries, k, max_check, group,
                                   union_factor, binned, recall_target)
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq = queries.shape[0]
        # the int8 blocks hold x / scale: q / scale keeps every query's
        # ordering that of the dequantized scores
        q_scaled = queries.astype(np.float32) / np.float32(self.scale)
        _, ids = self._scan_topk(q_scaled, self._rerank_budget(k),
                                 max_check, group, union_factor, binned,
                                 recall_target)
        k_eff = min(k, ids.shape[1])
        out_d = np.full((nq, k), np.float32(MAX_DIST), np.float32)
        out_i = np.full((nq, k), -1, np.int32)
        qf = np.ascontiguousarray(queries, np.float32)
        for lo in range(0, nq, 1024):
            hi = min(lo + 1024, nq)
            q = torch.from_numpy(qf[lo:hi]).to(self.device)
            cid = ids[lo:hi]
            if self.fp_host is not None:
                cid, _ = cascade_ops.check_host_ids(self.fp_host.shape[0],
                                                    cid)
                d, out = cascade_ops.rerank_gathered(
                    q, cascade_ops.fetch_rows(self.fp_host, cid,
                                              self.device),
                    torch.from_numpy(cid).to(self.device), k_eff,
                    int(self.metric), self.base, walk_ops.ROWS)
            else:
                d, out = cascade_ops.rerank_gathered(
                    q, self.fp_d, torch.from_numpy(cid).to(self.device),
                    k_eff, int(self.metric), self.base, walk_ops.GATHER,
                    self.fp_sq)
            out_d[lo:hi, :k_eff] = d.cpu().numpy()
            out_i[lo:hi, :k_eff] = out.cpu().numpy()
        return out_d, out_i

    def _scan_topk(self, queries: np.ndarray, k: int, max_check: int = 2048,
                   group: int = 0, union_factor: int = 2,
                   binned: str = "off",
                   recall_target: float = topk_bins.DEFAULT_RECALL_TARGET
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The block scan and its masked top-k (`search` without the
        cascade's re-rank)."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq, D = queries.shape
        P = self.cluster_size
        nprobe = int(np.clip(-(-max_check // P), 1, self.num_clusters))
        G = int(group) if group and group > 1 else 0
        if G and (G & (G - 1)):
            raise ValueError(f"DenseQueryGroup must be a power of two: {G}")
        if G:
            # adaptive cap: shrink the group to ~4 blocks' worth of queries
            per_block = max(1, nq // max(self.num_clusters, 1))
            cap = 1 << max(1, (4 * per_block).bit_length() - 1)
            G = min(G, max(cap, 2))
        U = (min(max(int(union_factor), 1) * nprobe, self.num_clusters)
             if G else 0)
        if G:
            # G <= U keeps every query's top-1 block inside the union
            G = min(G, 1 << (U.bit_length() - 1))
            if G < self._group_floor():
                G = 0
            # a group's union holds at most G*nprobe distinct blocks
            U = min(U, G * nprobe) if G else U
        # a union covering every block is a full scan: ungrouped is cheaper
        if G and U >= self.num_clusters and nprobe >= self.num_clusters:
            G = 0
        self.last_effective_group = G
        if group and int(group) > 1 and G != int(group):
            key = (int(group), G)
            if key not in self._demotions:
                self._demotions.add(key)
                log.info("dense grouped probing: requested group=%s -> "
                         "effective %s (nq=%d, clusters=%d, nprobe=%d, U=%s)",
                         group, G or "off", nq, self.num_clusters, nprobe,
                         U or "-")
        k_eff = min(k, (U if G else nprobe) * P, self.n)
        bins = topk_bins.resolve_bins(binned, k_eff,
                                      (U if G else nprobe) * P,
                                      recall_target)
        bytes_q = ((U * P * D * 4 + G - 1) // G if G
                   else nprobe * P * D * 4)
        chunk = max(1, min(_GATHER_BUDGET // bytes_q, 1024))
        if G:
            chunk = max(G, (chunk // G) * G)    # groups must tile the chunk
        return self._search_impl(queries, nq, k, k_eff, nprobe, chunk, D,
                                 G, U, bins)

    def _run_chunk(self, q: np.ndarray, nq_valid: int, k_eff: int,
                   nprobe: int, G: int, U: int, bins: int):
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        args = (self.data_perm, self.member_ids, self.member_sq,
                self.centroids, self.cent_sq, self.deleted, qd)
        dedup = self.replicas > 1
        if G > 1:
            d, ids = _dense_search_grouped_kernel(
                *args, nq_valid, k_eff, nprobe, U, G, int(self.metric),
                self.base, dedup, bins)
        else:
            d, ids = _dense_search_kernel(
                *args, k_eff, nprobe, int(self.metric), self.base, dedup,
                bins)
        return d.cpu().numpy(), ids.cpu().numpy()

    def _search_impl(self, queries, nq, k, k_eff, nprobe, chunk, D, G, U,
                     bins):
        out_d = np.full((nq, k), np.float32(MAX_DIST), np.float32)
        out_i = np.full((nq, k), -1, np.int32)
        if nq <= chunk:
            q_pad = query_bucket(nq, chunk)
            g_eff = min(G, q_pad) if G else 0     # buckets are powers of 2
            if g_eff < self._group_floor():
                g_eff = 0
            if g_eff != G:
                self.last_effective_group = g_eff
            q = queries
            if q_pad != nq:
                q = np.concatenate([q, np.zeros((q_pad - nq, D), q.dtype)])
            d, ids = self._run_chunk(q, nq, k_eff, nprobe, g_eff, U, bins)
            out_d[:, :d.shape[1]] = d[:nq]
            out_i[:, :ids.shape[1]] = ids[:nq]
            return out_d, out_i
        m = -(-nq // chunk)
        q = queries
        if m * chunk != nq:
            q = np.concatenate([q, np.zeros((m * chunk - nq, D), q.dtype)])
        g_chunk = min(G, chunk) if G > 1 else 0
        for i in range(m):
            lo = i * chunk
            d, ids = self._run_chunk(q[lo:lo + chunk],
                                     int(np.clip(nq - lo, 0, chunk)), k_eff,
                                     nprobe, g_chunk, U, bins)
            hi = min(lo + chunk, nq)
            out_d[lo:hi, :d.shape[1]] = d[:hi - lo]
            out_i[lo:hi, :ids.shape[1]] = ids[:hi - lo]
        return out_d, out_i


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py; the JAX package's formulas).
# The JAX package compiles a chunked program (``lax.map`` over query
# chunks) apart from the one-chunk kernels; the port loops over chunks in
# `DenseTreeSearcher._search_impl`, which stands for both chunked families.
# ---------------------------------------------------------------------------

def _dense_scan_cost(Q, C, P, D, nprobe, k, itemsize=4, binned_bins=0,
                     **_):
    """Per-query kernel: (Q, C) center matmul, top-nprobe cut, block
    gather, (Q, nprobe*P) candidate contraction, masked top-k.  Bytes:
    the gathered (Q, nprobe, P, D) candidate tensor is written then
    re-read by the scoring einsum (2x), plus the full block-layout
    operand of the gather and the (Q, nprobe*P) score-matrix traffic.
    With `binned_bins` the final select is the bin reduction: the
    top-k ensemble term is replaced by the O(M) reduction + the
    bins-wide shortlist sort (ops/topk_bins.binned_select_cost)."""
    M = Q * nprobe * P
    if binned_bins:
        sel_f, sel_b = topk_bins.binned_select_cost(Q, nprobe * P, k, binned_bins)
        sel_f += 6.0 * M                          # mask/where epilogue
        sel_b += 4.0 * M * 4
    else:
        sel_f, sel_b = 10.0 * M, 8.0 * M * 4      # mask/top-k ensemble
    flops = (costmodel.matmul_flops(Q, C, D)      # center scoring
             + 2.0 * M * D                        # candidate scoring
             + sel_f
             + 2.0 * D * (Q + C))                 # norms
    nbytes = (2.0 * M * D * itemsize              # gather out + einsum read
              + C * P * D * itemsize              # gather operand
              + C * D * 4 + C * 4                 # centroids
              + Q * D * itemsize
              + sel_b                             # ids/sq/mask/select traffic
              + Q * k * 8)
    return flops, nbytes


def _dense_chunked_cost(M_chunks, Q, C, P, D, nprobe, k, itemsize=4,
                        binned_bins=0, **_):
    f, b = _dense_scan_cost(Q, C, P, D, nprobe, k, itemsize,
                            binned_bins=binned_bins)
    return M_chunks * f, M_chunks * b


def _dense_grouped_cost(Q, C, P, D, nprobe, U, G, k, itemsize=4,
                        binned_bins=0, **_):
    """Grouped kernel: every query scores its group's U-block union —
    (Q/G)*U grid steps of (G, D) x (D, P) contractions.  With
    `binned_bins` the final (Q, U*P)-wide select is the bin reduction
    (same substitution as _dense_scan_cost)."""
    NG = max(1, Q // max(G, 1))
    M = NG * U * P * G                            # scored candidates
    if binned_bins:
        sel_f, sel_b = topk_bins.binned_select_cost(Q, U * P, k, binned_bins)
        sel_f += 8.0 * M                          # union rank/scan/mask
        sel_b += 4.0 * M * 4
    else:
        sel_f, sel_b = 12.0 * M, 8.0 * M * 4      # union rank/scan/top-k
    flops = (costmodel.matmul_flops(Q, C, D)
             + 2.0 * M * D
             + sel_f
             + 2.0 * D * (Q + C))
    nbytes = (2.0 * NG * U * P * D * itemsize + C * P * D * itemsize
              + C * D * 4 + Q * D * itemsize + sel_b + Q * k * 8)
    return flops, nbytes


def _dense_grouped_chunked_cost(M_chunks, Q, C, P, D, nprobe, U, G, k,
                                itemsize=4, binned_bins=0, **_):
    f, b = _dense_grouped_cost(Q, C, P, D, nprobe, U, G, k, itemsize,
                               binned_bins=binned_bins)
    return M_chunks * f, M_chunks * b


costmodel.register("dense.scan", _dense_search_kernel, _dense_scan_cost)
costmodel.register("dense.scan_chunked", DenseTreeSearcher._search_impl,
                   _dense_chunked_cost)
costmodel.register("dense.grouped", _dense_search_grouped_kernel,
                   _dense_grouped_cost)
costmodel.register("dense.grouped_chunked", DenseTreeSearcher._search_impl,
                   _dense_grouped_chunked_cost)
