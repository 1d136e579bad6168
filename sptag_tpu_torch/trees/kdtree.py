"""KDTree forest — kd-trees with top-variance random split dimension (port
of ``sptag_tpu/trees/kdtree.py``: host numpy in both packages, so the same
data and seed give the same nodes).

Parity: SPTAG COMMON::KDTree (AnnService/inc/Core/Common/
KDTree.h:25-348).  Same node layout and on-disk format (``KDTNode{left,
right, split_dim, split_value}``, SaveTrees :100-110), same build semantics:

* split dimension drawn at random from the top-`numTopDimensionKDTSplit`(5)
  variance dims of a <=`Samples` sample of the cell (ChooseDivision
  :246-279, SelectDivisionDimension :281-311);
* split value = mean of that dimension over the sample (:278);
* Hoare-style partition; a degenerate all-equal cell splits at the middle
  index (Subdivide :313-341);
* a single-sample child is a leaf encoded as ``-sampleid - 1``
  (DivideTree :219-244).

The build's per-cell mean/variance is cheap host numpy over a bounded
sample, so the whole build stays host-side (the reference builds one
tree per OpenMP thread, KDTree.h:78; sequential here — trees are built once
offline).  Search-side, the recursive KDTSearch descent (:178-215) becomes
`collect_seeds`: a **vectorized** descent of all queries at once whose leaf
hits seed the batched beam engine; the reference's distance-bound priority
queue over "other children" (:213) maps to picking the `backtrack` smallest
accumulated-bound branches per query and greedily descending each.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from sptag_tpu_torch.io import format as fmt


class KDTree:
    def __init__(self, tree_number: int = 1, top_dims: int = 5,
                 samples: int = 100):
        self.tree_number = tree_number
        self.top_dims = top_dims
        self.samples = samples
        self.tree_starts = np.zeros(0, np.int32)
        self.nodes = np.zeros(0, fmt.KDT_NODE_DTYPE)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    # ------------------------------------------------------------------ build

    def build(self, data: np.ndarray, seed: int = 17,
              sample_ids: Optional[np.ndarray] = None) -> None:
        rng = np.random.default_rng(seed)
        n = data.shape[0] if sample_ids is None else len(sample_ids)
        base_ids = (np.arange(n, dtype=np.int64) if sample_ids is None
                    else np.asarray(sample_ids, np.int64))

        left: List[int] = []
        right: List[int] = []
        split_dim: List[int] = []
        split_value: List[float] = []
        tree_starts: List[int] = []

        def new_node() -> int:
            left.append(0)
            right.append(0)
            split_dim.append(-1)
            split_value.append(0.0)
            return len(left) - 1

        for t in range(self.tree_number):
            ids = rng.permutation(base_ids)
            tree_starts.append(len(left))
            if n == 1:
                # degenerate one-row corpus: a root whose children are both
                # the single sample
                ni = new_node()
                left[ni] = -int(ids[0]) - 1
                right[ni] = -int(ids[0]) - 1
                continue
            root = new_node()
            # explicit stack of (node_idx, id-array) replaces the
            # reference's recursion (DivideTree, KDTree.h:219-244)
            stack: List[Tuple[int, np.ndarray]] = [(root, ids)]
            while stack:
                ni, cell = stack.pop()
                mid = self._choose_division(
                    data, cell, ni, split_dim, split_value, rng)
                lo, hi = cell[:mid], cell[mid:]
                if len(lo) == 1:
                    left[ni] = -int(lo[0]) - 1
                else:
                    ci = new_node()
                    left[ni] = ci
                    stack.append((ci, lo))
                if len(hi) == 1:
                    right[ni] = -int(hi[0]) - 1
                else:
                    ci = new_node()
                    right[ni] = ci
                    stack.append((ci, hi))

        self.tree_starts = np.asarray(tree_starts, np.int32)
        self.nodes = np.zeros(len(left), fmt.KDT_NODE_DTYPE)
        self.nodes["left"] = left
        self.nodes["right"] = right
        self.nodes["split_dim"] = split_dim
        self.nodes["split_value"] = split_value

    def _choose_division(self, data, cell, ni, split_dim, split_value,
                         rng) -> int:
        """Pick split dim/value (ChooseDivision) and partition the cell;
        returns the split point (count of left ids) after reordering `cell`
        in place."""
        sample = cell if len(cell) <= self.samples else cell[:self.samples]
        vals = data[sample].astype(np.float32)
        var = vals.var(axis=0)
        k = min(self.top_dims, data.shape[1])
        top = np.argpartition(var, len(var) - k)[len(var) - k:]
        # order top dims by variance descending, pick uniformly (reference
        # SelectDivisionDimension, KDTree.h:281-311)
        top = top[np.argsort(-var[top], kind="stable")]
        dim = int(top[rng.integers(0, k)])
        value = float(vals[:, dim].mean())
        split_dim[ni] = dim
        split_value[ni] = value

        col = data[cell, dim]
        mask = col < value
        mid = int(mask.sum())
        if mid == 0 or mid == len(cell):
            # all-equal cell: split at the middle (Subdivide, :335-339)
            mid = len(cell) // 2
            order = np.arange(len(cell))
        else:
            order = np.argsort(~mask, kind="stable")
        cell[:] = cell[order]
        return mid

    # ---------------------------------------------------------------- seeding

    def collect_seeds(self, queries: np.ndarray,
                      backtrack: int = 8) -> np.ndarray:
        """Vectorized seed collection: for every query and tree, the greedy
        descent leaf plus the `backtrack` lowest-bound other-children leaves.

        Returns (Q, tree_number * (1 + backtrack)) int64 sample ids, -1
        padded.  Mirrors KDTSearch's bestChild descent + SPTQueue of
        (otherChild, accumulated bound) (KDTree.h:178-215).
        """
        q = np.asarray(queries, np.float32)
        Q = q.shape[0]
        per_tree = 1 + backtrack
        out = np.full((Q, self.tree_number * per_tree), -1, np.int64)
        for t in range(self.tree_number):
            root = int(self.tree_starts[t])
            active = np.ones(Q, bool)
            leaf, others, bounds = self._descend(
                q, np.full(Q, root, np.int64), active, track_others=True)
            col = t * per_tree
            out[:, col] = leaf
            if backtrack > 0 and others.shape[1] > 0:
                nb = min(backtrack, others.shape[1])
                pick = np.argpartition(bounds, nb - 1, axis=1)[:, :nb]
                chosen = np.take_along_axis(others, pick, axis=1)
                chosen_ok = np.isfinite(
                    np.take_along_axis(bounds, pick, axis=1))
                for b in range(nb):
                    sub_leaf, _, _ = self._descend(
                        q, chosen[:, b].copy(), chosen_ok[:, b],
                        track_others=False)
                    out[:, col + 1 + b] = sub_leaf
        return out

    def _descend(self, q: np.ndarray, start: np.ndarray, active: np.ndarray,
                 track_others: bool):
        """Greedy best-child descent for all queries at once.

        start (Q,) node indices (negative = a ``-id-1`` leaf encoding);
        `active` masks queries whose start is a real branch.  Returns
        (leaf sample ids (Q,), -1 where inactive; other-children (Q, depth);
        branch bounds (Q, depth) = the split-plane distance diff^2 exactly
        as the reference's KDTSearch root descent computes them
        (KDTree.h:199-213, distBound starts at 0), +inf where absent)."""
        Q = q.shape[0]
        ptr = start.astype(np.int64).copy()
        others: List[np.ndarray] = []
        bounds: List[np.ndarray] = []
        # loop until every active pointer reaches a leaf — mean-value splits
        # can be arbitrarily unbalanced on skewed data, so no fixed depth cap
        # (the reference recurses to a leaf unconditionally, KDTree.h:178-215);
        # node-count bound = hard stop against a malformed (cyclic) tree
        for _ in range(len(self.nodes) + 1):
            internal = active & (ptr >= 0)
            if not internal.any():
                break
            safe = np.where(internal, ptr, 0)
            node = self.nodes[safe]
            dims = node["split_dim"].astype(np.int64)
            diff = (q[np.arange(Q), np.clip(dims, 0, q.shape[1] - 1)]
                    - node["split_value"]).astype(np.float32)
            go_left = diff < 0
            best = np.where(go_left, node["left"], node["right"])
            other = np.where(go_left, node["right"], node["left"])
            if track_others:
                others.append(np.where(internal, other, 0))
                bounds.append(np.where(internal, diff * diff,
                                       np.float32(np.inf)))
            ptr = np.where(internal, best, ptr)
        leaf = np.where(active & (ptr < 0), -ptr - 1, -1)
        if track_others and others:
            return leaf, np.stack(others, axis=1), np.stack(bounds, axis=1)
        return leaf, np.zeros((Q, 0), np.int64), np.zeros((Q, 0), np.float32)

    # ------------------------------------------------------------ persistence

    def save(self, path_or_stream) -> None:
        fmt.write_tree_forest(path_or_stream, self.tree_starts, self.nodes)

    @classmethod
    def load(cls, path_or_stream, **kwargs) -> "KDTree":
        tree = cls(**kwargs)
        tree.tree_starts, tree.nodes = fmt.read_tree_forest(
            path_or_stream, fmt.KDT_NODE_DTYPE)
        tree.tree_number = len(tree.tree_starts)
        return tree
