"""BKTree — balanced k-means tree forest (port of
``sptag_tpu/trees/bktree.py``).

Same node layout and file format as SPTAG's COMMON::BKTree (BKTree.h:
107-513) and the JAX package:

* the root's centerid is the sample count; a node's children occupy the
  node range [childStart, childEnd);
* a node with <= leaf_size samples expands into per-sample leaf children;
* otherwise the node's samples are k-means clustered and each non-empty
  cluster becomes a child whose centerid is the member closest to the
  centroid, excluded from deeper recursion;
* an all-one-cluster node (duplicates) negates its childStart, keeps its
  smallest sample as centerid, stores the other duplicates as children and
  records them in the sample-center map;
* each tree ends with a sentinel node of centerid -1.

Each tree level is clustered as batched k-means on the device (padded
(B, P, D) batches grouped by ``shape_bucket`` size, which also fixes how
many centers a small node may seed, as in the JAX package); bookkeeping is
host numpy.  Permutations and sub-samples come from a numpy generator
seeded like the JAX package's; the k-means restarts from a
``torch.Generator`` — so the trees differ from the JAX package's, but both
hold the same invariants and interchange through ``tree.bin``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.ops import kmeans as km
from sptag_tpu_torch.utils import shape_bucket

# device batch budget: rows per (B, P) padded batch (times D floats)
_MAX_BATCH_ROWS = 1 << 21


class BKTree:
    """A built forest: flat node arrays + sample-center map."""

    def __init__(self, tree_number: int = 1, kmeans_k: int = 32,
                 leaf_size: int = 8, samples: int = 1000,
                 metric: int = 0, base: int = 1,
                 lloyd_iterations: int = 16, restarts: int = 3,
                 device: DeviceLike = None):
        self.tree_number = tree_number
        self.kmeans_k = kmeans_k
        self.leaf_size = leaf_size
        self.samples = samples
        self.metric = metric
        self.base = base
        self.lloyd_iterations = lloyd_iterations
        self.restarts = restarts
        self.device = device          # resolved by build(), which needs it

        self.tree_starts = np.zeros(0, np.int32)
        self.nodes = np.zeros(0, fmt.BKT_NODE_DTYPE)
        self.sample_center_map: Dict[int, int] = {}

    # ------------------------------------------------------------------ build

    def build(self, data: np.ndarray, seed: int = 42) -> None:
        """Build the forest over all rows of `data`, one level at a time."""
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n = data.shape[0]
        ids_all = np.arange(n, dtype=np.int64)

        centerid: List[int] = []
        child_start: List[int] = []
        child_end: List[int] = []
        tree_starts: List[int] = []
        self.sample_center_map = {}

        def new_node(cid: int) -> int:
            centerid.append(cid)
            child_start.append(-1)
            child_end.append(-1)
            return len(centerid) - 1

        for _ in range(self.tree_number):
            perm = rng.permutation(ids_all)
            tree_starts.append(len(centerid))
            root = new_node(n)
            # (node, sample ids, has_center_sample — False for the root,
            # whose centerid is the count sentinel)
            level: List[Tuple[int, np.ndarray, bool]] = [(root, perm, False)]
            while level:
                level = self._expand_level(
                    data, level, centerid, child_start, child_end,
                    new_node, rng, gen)
            new_node(-1)     # per-tree sentinel

        self.tree_starts = np.asarray(tree_starts, np.int32)
        self.nodes = np.zeros(len(centerid), fmt.BKT_NODE_DTYPE)
        self.nodes["centerid"] = centerid
        self.nodes["childStart"] = child_start
        self.nodes["childEnd"] = child_end

    def _expand_level(self, data, level, centerid, child_start, child_end,
                      new_node, rng, gen):
        """Expand all items of one level; returns the next level's items."""
        next_level: List[Tuple[int, np.ndarray, bool]] = []
        km_items = [(ni, ids, hc) for ni, ids, hc in level
                    if len(ids) > self.leaf_size]
        for ni, ids, _ in level:
            if len(ids) <= self.leaf_size:
                child_start[ni] = len(centerid)
                for s in ids:
                    new_node(int(s))
                child_end[ni] = len(centerid)

        results: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        buckets: Dict[int, List[int]] = {}
        for idx, (_, ids, _) in enumerate(km_items):
            buckets.setdefault(shape_bucket(len(ids)), []).append(idx)
        for p_full, idxs in sorted(buckets.items()):
            p_sub = shape_bucket(min(p_full, self.samples))
            max_b = max(1, _MAX_BATCH_ROWS // p_full)
            for off in range(0, len(idxs), max_b):
                self._run_kmeans_chunk(data, km_items, idxs[off:off + max_b],
                                       p_full, p_sub, rng, gen, results)

        for idx, (ni, ids, has_center) in enumerate(km_items):
            labels, counts, medoids = results[idx]
            nonzero = np.flatnonzero(counts)
            child_start[ni] = len(centerid)
            if len(nonzero) <= 1:
                # degenerate duplicate cluster: re-include the node's own
                # center sample (a parent excluded it), keep the smallest
                # sample as center, the rest become duplicate children
                old_center = int(centerid[ni])
                if has_center and old_center not in ids:
                    ids = np.concatenate([ids, [old_center]])
                ids_sorted = np.sort(ids)
                center = int(ids_sorted[0])
                centerid[ni] = center
                child_start[ni] = -child_start[ni]
                for dup in ids_sorted[1:]:
                    new_node(int(dup))
                    self.sample_center_map[int(dup)] = center
                self.sample_center_map[-1 - center] = ni
            else:
                order = np.argsort(labels, kind="stable")
                sorted_ids = ids[order]
                offsets = np.concatenate([[0], np.cumsum(counts)])
                for k in nonzero:
                    members = sorted_ids[offsets[k]:offsets[k + 1]]
                    med = medoids[k]
                    cni = new_node(int(med))
                    rest = members[members != med]
                    if len(rest) > 0:
                        next_level.append((cni, rest, True))
            child_end[ni] = len(centerid)
        return next_level

    def _run_kmeans_chunk(self, data, km_items, chunk, p_full, p_sub, rng,
                          gen, results):
        """One padded (B, P) batch of device k-means; fills results with
        (labels over the item's ids, counts (K,), medoid sample ids)."""
        K = min(self.kmeans_k, p_sub)
        B, D = len(chunk), data.shape[1]
        sub = np.zeros((B, p_sub, D), np.float32)
        sub_valid = np.zeros((B, p_sub), bool)
        full = np.zeros((B, p_full, D), np.float32)
        full_valid = np.zeros((B, p_full), bool)
        for row, idx in enumerate(chunk):
            ids = km_items[idx][1]
            cnt = len(ids)
            take = min(cnt, self.samples)
            pick = (ids if cnt <= self.samples
                    else rng.choice(ids, self.samples, replace=False))
            sub[row, :take] = data[pick]
            sub_valid[row, :take] = True
            full[row, :cnt] = data[ids]
            full_valid[row, :cnt] = True

        dev = self.device
        centers, _ = km.kmeans_fit(
            torch.from_numpy(sub).to(dev), torch.from_numpy(sub_valid).to(dev),
            gen, K, self.lloyd_iterations, self.restarts, self.metric,
            self.base)
        labels, counts, medoid_pos = km.kmeans_final_assign(
            torch.from_numpy(full).to(dev),
            torch.from_numpy(full_valid).to(dev), centers, K, self.metric,
            self.base)
        labels = labels.cpu().numpy()
        counts = counts.cpu().numpy()
        medoid_pos = medoid_pos.cpu().numpy()
        for row, idx in enumerate(chunk):
            ids = km_items[idx][1]
            cnt = len(ids)
            med_ids = np.where(medoid_pos[row] >= 0,
                               ids[np.clip(medoid_pos[row], 0, cnt - 1)], -1)
            results[idx] = (labels[row, :cnt], counts[row], med_ids)

    # ---------------------------------------------------------------- queries

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def collect_pivots(self, max_pivots: int) -> np.ndarray:
        """Breadth-first over all trees, the node centerids (sample ids)
        top-down, each once: the shared pivot set that seeds the beam walk
        with one (Q, n_pivots) distance matrix."""
        out: List[int] = []
        seen = set()
        frontier: List[int] = list(self.tree_starts)
        cs = self.nodes["childStart"]
        ce = self.nodes["childEnd"]
        cid = self.nodes["centerid"]
        while frontier and len(out) < max_pivots:
            nxt: List[int] = []
            for ni in frontier:
                start = cs[ni]
                if start < 0:
                    # leaf or degenerate-duplicate node: nothing to descend
                    continue
                for c in range(start, ce[ni]):
                    sid = int(cid[c])
                    if sid >= 0 and sid not in seen:
                        seen.add(sid)
                        out.append(sid)
                        if len(out) >= max_pivots:
                            break
                    nxt.append(c)
                if len(out) >= max_pivots:
                    break
            frontier = nxt
        return np.asarray(out[:max_pivots], np.int32)

    # ------------------------------------------------------------ persistence

    def save(self, path_or_stream) -> None:
        """SPTAG binary format (BKTree::SaveTrees)."""
        fmt.write_tree_forest(path_or_stream, self.tree_starts, self.nodes)

    @classmethod
    def from_arrays(cls, tree_starts: np.ndarray, nodes: np.ndarray,
                    **kwargs) -> "BKTree":
        tree = cls(**kwargs)
        tree.tree_starts = np.asarray(tree_starts, np.int32)
        tree.nodes = np.asarray(nodes, fmt.BKT_NODE_DTYPE)
        tree.tree_number = len(tree.tree_starts)
        # restore the sentinel if an old file lacks it (BKTree.h:253)
        if len(tree.nodes) and tree.nodes["centerid"][-1] != -1:
            sentinel = np.zeros(1, fmt.BKT_NODE_DTYPE)
            sentinel["centerid"] = -1
            sentinel["childStart"] = -1
            sentinel["childEnd"] = -1
            tree.nodes = np.concatenate([tree.nodes, sentinel])
        tree._rebuild_sample_center_map()
        return tree

    @classmethod
    def load(cls, path_or_stream, **kwargs) -> "BKTree":
        return cls.from_arrays(
            *fmt.read_tree_forest(path_or_stream, fmt.BKT_NODE_DTYPE),
            **kwargs)

    def _rebuild_sample_center_map(self) -> None:
        self.sample_center_map = {}
        cid = self.nodes["centerid"]
        cs = self.nodes["childStart"]
        ce = self.nodes["childEnd"]
        # degenerate nodes store a negated childStart; cs == -1 is the leaf
        # default unless childEnd shows materialized children
        for ni in np.flatnonzero((cs < -1) | ((cs == -1) & (ce > 0))):
            center = int(cid[ni])
            if center < 0:
                continue
            self.sample_center_map[-1 - center] = int(ni)
            for c in range(-cs[ni], ce[ni]):
                self.sample_center_map[int(cid[c])] = center
