"""BKT index, dense-search slice (port of ``sptag_tpu/algo/bkt.py``).

Build with ``BuildGraph=0``: the balanced k-means forest only, with an
all ``-1`` graph of the configured width so the saved folder has the JAX
package's bytes.  Search with ``SearchMode=dense`` (the default): the
forest's first tree is cut into the block layout of algo/dense.py.  A
folder that holds a real ``graph.bin`` (``BuildGraph=1``) loads, keeps the
graph bytes and serves dense search.  The RNG graph build and the beam
walk are later slices of the port.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.dense import (MAX_DIST, DenseTreeSearcher,
                                        partition_from_tree)
from sptag_tpu_torch.core.index import VectorIndex, not_ported, register_algo
from sptag_tpu_torch.core.params import BKTParams
from sptag_tpu_torch.core.types import (DistCalcMethod, IndexAlgoType,
                                        VectorValueType, dtype_of)
from sptag_tpu_torch.io import atomic
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.trees.bktree import BKTree

_GRAPH = "RNG graph build, beam walk and scheduler"

# knobs baked into the dense snapshot: a change rebuilds it
_DENSE_PARAMS = frozenset({"densereplicas", "denseclustersize",
                           "cascadesearch"})


@register_algo
class BKTIndex(VectorIndex):
    algo = IndexAlgoType.BKT

    def __init__(self, value_type: VectorValueType, device: torch.device):
        super().__init__(value_type, device)
        self._host: Optional[np.ndarray] = None
        self._n = 0
        self._deleted = np.zeros(0, bool)
        self._tree: Optional[BKTree] = None
        self._graph: Optional[np.ndarray] = None
        self._dense: Optional[DenseTreeSearcher] = None

    def _make_params(self) -> BKTParams:
        return BKTParams()

    # ---- storage ----------------------------------------------------------

    @property
    def num_samples(self) -> int:
        return self._n

    @property
    def num_deleted(self) -> int:
        return int(self._deleted[:self._n].sum())

    @property
    def feature_dim(self) -> int:
        return 0 if self._host is None else self._host.shape[1]

    def contains_sample(self, vid: int) -> bool:
        return 0 <= vid < self._n and not self._deleted[vid]

    def set_parameter(self, name: str, value: str) -> bool:
        ok = super().set_parameter(name, value)
        if ok and name.lower() in _DENSE_PARAMS:
            with self._lock:
                self._dense = None
        return ok

    def _new_tree(self) -> BKTree:
        p = self.params
        return BKTree(tree_number=p.tree_number, kmeans_k=p.kmeans_k,
                      leaf_size=p.leaf_size, samples=p.samples,
                      metric=int(self.dist_calc_method), base=self.base,
                      device=self.device)

    # ---- build ------------------------------------------------------------

    def _build(self, data: np.ndarray) -> None:
        if getattr(self.params, "build_graph", 1):
            raise not_ported("BuildGraph=1 (set BuildGraph=0 for the "
                             "dense-only build)", _GRAPH)
        self._host = np.ascontiguousarray(data)
        self._n = data.shape[0]
        self._deleted = np.zeros(self._n, bool)
        self._dense = None
        self._tree = self._new_tree()
        self._tree.build(self._host)
        # the saved graph stays shape-correct: all -1 at the configured width
        self._graph = np.full((self._n, self.params.neighborhood_size), -1,
                              np.int32)

    # ---- dense snapshot ---------------------------------------------------

    def _dense_clusters(self):
        """Tree partition, plus nearest-center assignment of any row the
        tree does not cover."""
        n = self._n
        data = self._host[:n]
        centers, clusters = partition_from_tree(
            self._tree, n, self.params.dense_cluster_size)
        covered = np.zeros(n, bool)
        for c in clusters:
            covered[c] = True
        missing = np.flatnonzero(~covered)
        if len(missing):
            q = data[missing].astype(np.float32)
            c = data[centers].astype(np.float32)
            dot = q @ c.T
            if self.dist_calc_method == DistCalcMethod.Cosine:
                owner = dot.argmax(axis=1)
            else:
                owner = ((c ** 2).sum(1)[None, :] - 2.0 * dot).argmin(axis=1)
            for ci in range(len(clusters)):
                extra = missing[owner == ci]
                if len(extra):
                    clusters[ci] = np.concatenate([clusters[ci], extra])
        return centers, clusters

    def _build_dense_searcher(self) -> DenseTreeSearcher:
        """Cluster-contiguous device snapshot from the current tree."""
        if int(getattr(self.params, "cascade_search", 0)):
            raise not_ported("CascadeSearch=1", "cascade")
        _, clusters = self._dense_clusters()
        return DenseTreeSearcher(
            self._host[:self._n], clusters, self._deleted[:self._n],
            self.dist_calc_method, self.base,
            replicas=getattr(self.params, "dense_replicas", 1),
            device=self.device)

    def _get_dense(self) -> DenseTreeSearcher:
        """The dense snapshot, built at first use."""
        dense = self._dense
        if dense is not None:
            return dense
        with self._lock:
            if self._dense is None:
                self._dense = self._build_dense_searcher()
            return self._dense

    # ---- search -----------------------------------------------------------

    def resolve_search_mode(self, mode: str, max_check: int) -> str:
        """"auto" -> beam below AutoModeThreshold, dense at or above it;
        always dense on a dense-only index."""
        if mode != "auto":
            return mode
        if not getattr(self.params, "build_graph", 1):
            return "dense"
        thr = int(getattr(self.params, "auto_mode_threshold", 1024))
        return "beam" if max_check < thr else "dense"

    def _search_batch(self, queries: np.ndarray, k: int,
                      max_check: Optional[int] = None,
                      search_mode: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        if self._n == 0:
            raise RuntimeError("index is empty")
        p = self.params
        mc = max_check if max_check is not None else p.max_check
        mode = search_mode or getattr(p, "search_mode", "beam")
        if mode not in ("beam", "dense", "auto"):
            raise ValueError(f"unknown search mode {mode!r}")
        mode = self.resolve_search_mode(mode, mc)
        if mode != "dense":
            if not getattr(p, "build_graph", 1):
                raise RuntimeError(
                    "beam search needs the RNG graph, but this index was "
                    "built with BuildGraph=0 (dense-only); use "
                    "SearchMode=dense or rebuild with BuildGraph=1")
            raise not_ported("SearchMode=beam", _GRAPH)
        d, ids = self._get_dense().search(
            queries, min(k, self._n), max_check=mc,
            group=getattr(p, "dense_query_group", 0),
            union_factor=getattr(p, "dense_union_factor", 2),
            binned=str(getattr(p, "binned_topk", "off")))
        if ids.shape[1] < k:
            q = ids.shape[0]
            d = np.concatenate(
                [d, np.full((q, k - d.shape[1]), MAX_DIST, np.float32)], 1)
            ids = np.concatenate(
                [ids, np.full((q, k - ids.shape[1]), -1, np.int32)], 1)
        return d, ids

    @property
    def last_effective_group(self) -> int:
        """Query-group size the last dense search actually ran with."""
        return 0 if self._dense is None else self._dense.last_effective_group

    # ---- persistence ------------------------------------------------------

    def _save_index_data(self, folder: str) -> None:
        """Blob order: vectors, tree, graph, deletes."""
        p = self.params
        writers = [
            (p.vector_file,
             lambda f: fmt.write_matrix(f, self._host[:self._n])),
            (p.tree_file, lambda f: self._tree.save(f)),
            (p.graph_file, lambda f: fmt.write_graph(f, self._graph)),
            (p.delete_file,
             lambda f: fmt.write_deletes(f, self._deleted[:self._n])),
        ]
        for name, writer in writers:
            with atomic.checked_open(os.path.join(folder, name), "wb") as f:
                writer(f)

    def _load_index_data(self, folder: str) -> None:
        p = self.params

        def path(name: str) -> str:
            full = os.path.join(folder, name)
            if not os.path.exists(full):
                raise FileNotFoundError(full)
            return full

        data = fmt.read_matrix(path(p.vector_file), dtype_of(self.value_type))
        self._host = np.ascontiguousarray(data)
        self._n = data.shape[0]
        self._tree = BKTree.load(
            path(p.tree_file), kmeans_k=p.kmeans_k, leaf_size=p.leaf_size,
            samples=p.samples, metric=int(self.dist_calc_method),
            base=self.base, device=self.device)
        self._graph = fmt.read_graph(path(p.graph_file))
        self._deleted = np.zeros(self._n, bool)
        dpath = os.path.join(folder, p.delete_file)
        if os.path.exists(dpath):
            mask = fmt.read_deletes(dpath)
            self._deleted[:len(mask)] = mask[:self._n]
        self._dense = None
