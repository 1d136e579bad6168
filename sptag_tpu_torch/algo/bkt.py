"""BKT index: balanced k-means forest + RNG graph + search (port of
``sptag_tpu/algo/bkt.py``).

Build: the forest (trees/bktree.py), then — with ``BuildGraph=1``, the
default — the RNG graph (graph/rng.py), whose refine passes search the
half-built index through the dense tree-partition scan
(``RefineSearchMode=dense``, the hand-written block-dot kernels) or the
beam walk, the final pass as ``FinalRefineSearchMode`` says.
``BuildGraph=0`` skips the graph and saves an all ``-1`` graph of the
configured width.  Search: ``SearchMode=dense`` (algo/dense.py), ``beam``
(the graph walk, algo/engine.py) or ``auto`` (beam below
``AutoModeThreshold``, dense at or above it).  Folders interchange with
the JAX package's both ways.  ``ContinuousBatching=1`` (the slot
scheduler), mutation and build checkpoints are later slices of the port.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.dense import DenseTreeSearcher, partition_from_tree
from sptag_tpu_torch.algo.engine import SCHEDULER_ITEM, GraphSearchEngine
from sptag_tpu_torch.core.index import (VectorIndex, not_ported, pad_results,
                                        register_algo)
from sptag_tpu_torch.core.params import BKTParams
from sptag_tpu_torch.core.types import (DistCalcMethod, IndexAlgoType,
                                        VectorValueType, dtype_of)
from sptag_tpu_torch.graph.rng import RelativeNeighborhoodGraph
from sptag_tpu_torch.io import atomic
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.trees.bktree import BKTree

log = logging.getLogger(__name__)

# knobs baked into the dense snapshot: a change rebuilds it
_DENSE_PARAMS = frozenset({"densereplicas", "denseclustersize",
                           "cascadesearch"})
# knobs baked into the walk's engine snapshot
_ENGINE_PARAMS = frozenset({"beampackedneighbors", "beamscoredtype",
                            "binnedtopk", "approxrecalltarget",
                            "cascadesearch"})


def pivot_budget(params, n: int = 0) -> int:
    """Shared-pivot set size before the corpus-size clamp: at least 64 and
    NumberOfInitialDynamicPivots * 32, growing as n / SeedPivotAutoScale
    up to 16,384 (the walk's recall ceiling is seed coverage)."""
    base = max(64, params.initial_dynamic_pivots * 32)
    div = int(getattr(params, "seed_pivot_auto_scale", 24))
    if n and div > 0:
        base = max(base, min(n // div, 16384))
    return base


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
        self._engine: Optional[GraphSearchEngine] = None
        self._refine_dense = None     # the dense searcher of a graph build
        #: wall seconds of each stage of the last build (tree, then the
        #: graph's stages)
        self.build_stages = {}

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
        low = name.lower()
        if ok and (low in _DENSE_PARAMS or low in _ENGINE_PARAMS):
            with self._lock:
                if low in _DENSE_PARAMS:
                    self._dense = None
                if low in _ENGINE_PARAMS:
                    self._engine = None
        return ok

    def _new_tree(self) -> BKTree:
        p = self.params
        return BKTree(tree_number=p.tree_number, kmeans_k=p.kmeans_k,
                      leaf_size=p.leaf_size, samples=p.samples,
                      metric=int(self.dist_calc_method), base=self.base,
                      device=self.device)

    def _new_graph(self) -> RelativeNeighborhoodGraph:
        p = self.params
        return RelativeNeighborhoodGraph(
            neighborhood_size=p.neighborhood_size, tpt_number=p.tpt_number,
            tpt_leaf_size=p.tpt_leaf_size,
            neighborhood_scale=p.neighborhood_scale, cef_scale=p.cef_scale,
            refine_iterations=p.refine_iterations, cef=p.cef,
            tpt_top_dims=p.tpt_top_dims, tpt_samples=p.samples,
            refine_accuracy_guard=bool(p.refine_accuracy_guard),
            refine_accuracy_floor=float(p.refine_accuracy_floor),
            device=self.device)

    def _pivot_ids(self) -> np.ndarray:
        """Seed-pivot ids: the forest's centers breadth-first, at most
        `pivot_budget` of them."""
        rows = self._n
        max_pivots = min(rows, pivot_budget(self.params, rows))
        pivots = self._tree.collect_pivots(max_pivots)
        return pivots[pivots < rows]

    # ---- build ------------------------------------------------------------

    def _build(self, data: np.ndarray) -> None:
        self._host = np.ascontiguousarray(data)
        self._n = data.shape[0]
        self._deleted = np.zeros(self._n, bool)
        self._dense = None
        self._engine = None
        t0 = time.perf_counter()
        self._tree = self._new_tree()
        self._tree.build(self._host)
        self.build_stages = {"tree": time.perf_counter() - t0}
        p = self.params
        if not getattr(p, "build_graph", 1):
            # dense-only build: the saved graph stays shape-correct
            self._graph = np.full((self._n, p.neighborhood_size), -1,
                                  np.int32)
            return
        rng = self._new_graph()
        fmode = getattr(p, "final_refine_search_mode", "beam")
        # a final pass on a different engine optimizes walk navigability,
        # which the accuracy guard cannot judge: it is never rolled back
        same_engine = fmode == "same" or \
            fmode == getattr(p, "refine_search_mode", "beam")
        try:
            rng.build(self._host, int(self.dist_calc_method), self.base,
                      self._refine_search_factory, guard_final=same_engine)
        finally:
            self._refine_dense = None       # free the build's snapshot
        self._graph = rng.graph
        self.build_stages.update(rng.stage_seconds)

    def _refine_search_factory(self, graph: np.ndarray, final: bool = False):
        """SearchFn over a mid-build graph at the refine budget
        (MaxCheckForRefineGraph).  RefineSearchMode=dense searches the
        tree partition (block-dot kernels); the final pass honours
        FinalRefineSearchMode ("same" keeps the refine mode)."""
        p = self.params
        budget = p.max_check_for_refine_graph
        mode = getattr(p, "refine_search_mode", "beam")
        if final:
            fmode = getattr(p, "final_refine_search_mode", "beam")
            if fmode != "same":
                mode = fmode
        if mode == "dense" and self._tree is not None:
            # the searcher depends on the tree, not the graph: one per build
            searcher = self._refine_dense
            if searcher is None:
                searcher = self._build_dense_searcher(replicas=1,
                                                      cascade_ok=False)
                self._refine_dense = searcher
                eff = max(budget, 2 * (p.cef + 1))
                nprobe_est = max(1, -(-eff // searcher.cluster_size))
                if searcher.num_clusters >= 8 and nprobe_est < 2:
                    log.warning(
                        "dense refine budget MaxCheckForRefineGraph=%d "
                        "(effective %d) probes only %d of %d clusters "
                        "(cluster size %d): refine at this coverage can "
                        "degrade the graph; raise the budget or set "
                        "RefineIterations=0", budget, eff, nprobe_est,
                        searcher.num_clusters, searcher.cluster_size)
            # RefineQueryGroup selects the refine knob pair; without it
            # both dense search knobs apply
            rg = getattr(p, "refine_query_group", 0)
            if rg:
                group, union = rg, getattr(p, "refine_union_factor", 4)
            else:
                group = getattr(p, "dense_query_group", 0)
                union = getattr(p, "dense_union_factor", 2)

            def search(queries: np.ndarray, k: int):
                # a pool at least as big as k keeps the RNG prune supplied
                return searcher.search(
                    queries, k, max_check=max(budget, 2 * k),
                    group=group, union_factor=union)
            return search

        engine = self._make_engine(graph)

        def search(queries: np.ndarray, k: int):
            return engine.search(
                queries, k, max_check=budget,
                beam_width=getattr(p, "beam_width", 16),
                pool_size=max(2 * k, 64),
                nbp_limit=p.no_better_propagation_limit)
        return search

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

    def _build_dense_searcher(self, replicas: Optional[int] = None,
                              cascade_ok: bool = True) -> DenseTreeSearcher:
        """Cluster-contiguous device snapshot from the current tree.  The
        graph build's refine searcher passes replicas=1 and no cascade
        (full precision edges)."""
        if cascade_ok and int(getattr(self.params, "cascade_search", 0)):
            raise not_ported("CascadeSearch=1", "cascade")
        if replicas is None:
            replicas = getattr(self.params, "dense_replicas", 1)
        _, clusters = self._dense_clusters()
        return DenseTreeSearcher(
            self._host[:self._n], clusters, self._deleted[:self._n],
            self.dist_calc_method, self.base, replicas=replicas,
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

    # ---- walk snapshot ----------------------------------------------------

    def _make_engine(self, graph: np.ndarray) -> GraphSearchEngine:
        p = self.params
        n = self._n
        return GraphSearchEngine(
            self._host[:n], graph[:n], self._pivot_ids(), self._deleted[:n],
            self.dist_calc_method, self.base,
            score_dtype=str(getattr(p, "beam_score_dtype", "auto")),
            packed_neighbors=bool(int(getattr(p, "beam_packed_neighbors",
                                              0))),
            binned_topk=str(getattr(p, "binned_topk", "off")),
            recall_target=float(getattr(p, "approx_recall_target", 0.99)),
            cascade_search=bool(int(getattr(p, "cascade_search", 0))),
            device=self.device)

    def _get_engine(self) -> GraphSearchEngine:
        """The walk's snapshot, built at first use."""
        eng = self._engine
        if eng is not None:
            return eng
        with self._lock:
            if self._engine is None:
                self._engine = self._make_engine(self._graph)
            return self._engine

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
        if mode == "dense":
            d, ids = self._get_dense().search(
                queries, min(k, self._n), max_check=mc,
                group=getattr(p, "dense_query_group", 0),
                union_factor=getattr(p, "dense_union_factor", 2),
                binned=str(getattr(p, "binned_topk", "off")),
                recall_target=float(
                    getattr(p, "approx_recall_target", 0.99)))
        else:
            if not getattr(p, "build_graph", 1):
                raise RuntimeError(
                    "beam search needs the RNG graph, but this index was "
                    "built with BuildGraph=0 (dense-only); use "
                    "SearchMode=dense or rebuild with BuildGraph=1")
            d, ids = self._engine_search(queries, min(k, self._n), mc)
        return pad_results(d, ids, k)

    def _engine_search(self, queries: np.ndarray, k: int, max_check: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """The beam-walk branch of _search_batch."""
        p = self.params
        if int(getattr(p, "continuous_batching", 0)):
            raise not_ported("ContinuousBatching=1", SCHEDULER_ITEM)
        seg = int(getattr(p, "beam_segment_iters", 0))
        return self._get_engine().search(
            queries, k, max_check=max_check,
            beam_width=getattr(p, "beam_width", 16),
            nbp_limit=p.no_better_propagation_limit,
            dynamic_pivots=p.other_dynamic_pivots,
            segment_iters=seg or None)

    def _exact_scan(self, queries: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The exact scan over the walk snapshot's resident corpus."""
        return self._get_engine().exact_scan(queries, k)

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
        self._engine = None
