"""KDT index — kd-tree forest + RNG graph + beam search (port of
``sptag_tpu/algo/kdt.py``).

SPTAG's KDT::Index is BKT's composition with another tree: the kd-tree
forest (trees/kdtree.py, host numpy, the JAX package's draws) replaces the
k-means forest, the same RNG graph is built over the corpus, and a search
descends the kd-trees per query — the greedy leaf plus the ``backtrack``
lowest-bound other branches of each tree — and seeds the walk with those
leaves.  On the card the descent is the walk's first kernel
(ops/kd_descent.py): each engine snapshot on a card holds the forest
there (`_kd_forest`), and a search passes ``kd_backtrack``
(`_kd_backtrack`),
so a small batch's captured walk holds it and the search uploads only its
queries.  On the CPU the walk takes the host descent's seeds
(`_walk_seeds`, ``engine.search(seeds=...)``), in the order the JAX
package's descent gives them, which its parity tests hold on tied rows.
``SearchMode=dense`` runs the block-dot kernels over a kd-cell partition
(`partition_from_kdtree`).  Storage, mutation, the delta shard,
persistence and the slot scheduler are BKTIndex's; with
``ContinuousBatching=1`` each query rides the scheduler with its host
kd-tree seeds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sptag_tpu_torch.algo.bkt import BKTIndex
from sptag_tpu_torch.algo.dense import partition_from_kdtree
from sptag_tpu_torch.core.index import register_algo
from sptag_tpu_torch.core.params import KDTParams
from sptag_tpu_torch.core.types import IndexAlgoType
from sptag_tpu_torch.trees.kdtree import KDTree

# floor of the other-children branches descended per tree at seed time
# (SPTAG's SPTQueue backtracking); the budget scales it, _backtrack_for
_MIN_BACKTRACK = 4


@register_algo
class KDTIndex(BKTIndex):
    algo = IndexAlgoType.KDT

    def _make_params(self) -> KDTParams:
        return KDTParams()

    def _new_tree(self) -> KDTree:
        p = self.params
        return KDTree(tree_number=p.tree_number, top_dims=p.kdt_top_dims,
                      samples=p.samples)

    def _load_tree(self, path: str) -> KDTree:
        p = self.params
        return KDTree.load(path, tree_number=p.tree_number,
                           top_dims=p.kdt_top_dims, samples=p.samples)

    def _pivot_ids(self, rows: Optional[int] = None) -> np.ndarray:
        """The shared pivots are only KDT's fallback (the graph build's
        and an add's searches): a uniform stride sample over the engine's
        `rows` rows."""
        n = self._main_rows() if rows is None else rows
        count = min(n, max(64, self.params.initial_dynamic_pivots * 32))
        return np.linspace(0, n - 1, count, dtype=np.int32)

    def _backtrack_for(self, max_check: int) -> int:
        """Per-tree seed budget: SPTAG keeps tree-checked >= checked / 10
        by re-descending mid-walk; the batched walk seeds up front, so
        ~max_check / 10 tree leaves split across the forest, floored by
        NumberOfInitialDynamicPivots."""
        p = self.params
        trees = max(p.tree_number, 1)
        per_tree = max(max_check // 10, p.initial_dynamic_pivots) // trees
        return int(np.clip(per_tree, _MIN_BACKTRACK, 64))

    def _kd_forest(self):
        # the card descends the forest; the CPU seeds on the host
        tree = self._tree
        if (torch.device(self.device).type != "cuda" or tree is None
                or tree.num_nodes == 0):
            return None
        return tree.nodes, tree.tree_starts

    def _kd_backtrack(self, engine, max_check: int) -> int:
        if engine.kd_nodes is None:
            return 0
        return self._backtrack_for(max_check)

    def _walk_seeds(self, queries: np.ndarray,
                    max_check: Optional[int] = None) -> np.ndarray:
        backtrack = self._backtrack_for(
            max_check if max_check is not None else self.params.max_check)
        return self._tree.collect_seeds(queries, backtrack=backtrack)

    def _partition_tree(self, rows: Optional[int] = None):
        return partition_from_kdtree(
            self._tree, self._main_rows() if rows is None else rows,
            self.params.dense_cluster_size)

    def _scheduler_submit(self, queries: np.ndarray, k: int,
                          max_check: int,
                          rids: Optional[list] = None) -> list:
        # each query's kd-tree seeds ride with it; the scheduler pools KDT
        # queries by their seed width
        p = self.params
        return self._submit_each(
            queries, k, max_check, rids,
            seeds=self._walk_seeds(queries, max_check),
            beam_width=getattr(p, "beam_width", 16),
            nbp_limit=p.no_better_propagation_limit)
