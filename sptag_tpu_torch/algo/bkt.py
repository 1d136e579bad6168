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
the JAX package's both ways.

Mutation (SPTAG AddIndex / DeleteIndex / RefineIndex): an add links its
rows inline — one walk per added batch at ``AddCEF + 1`` with
``MaxCheckForRefineGraph``, ``rng_select`` for the new rows, one batched
RNG re-prune of every row that gains a reverse edge — or, with
``DeltaShardCapacity``, lands unlinked in the delta shard, which a single
background worker links into a copy of the graph off the lock once
``AutoRefineThreshold`` rows wait, then swaps a new engine in under the
lock.  ``AddCountForRebuild`` linked adds queue a background tree rebuild
on the same worker.  Deletes swap the snapshots' tombstone masks;
``refine_index`` compacts (id remap, new forest, one refine pass, orphan
repair).  Readers pin the engine and the dense searcher by one local
reference; every publish happens under the lock.

``ContinuousBatching=1`` runs beam searches through the slot scheduler
(algo/scheduler.py) over the current engine: ``search_batch`` waits for
its queries' futures, ``submit_batch`` hands them out, resolving each as
its query retires (the delta shard is scanned once per batch and merged
per query).  A background swap retires the old scheduler, which finishes
its queries on the old snapshot.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.dense import DenseTreeSearcher, partition_from_tree
from sptag_tpu_torch.algo.engine import GraphSearchEngine
from sptag_tpu_torch.algo.scheduler import (BeamSlotScheduler,
                                            SchedulerStopped, gather_futures,
                                            pad_result_row)
from sptag_tpu_torch.core.delta import merge_topk
from sptag_tpu_torch.core.index import (MAX_DIST, VectorIndex, grow_rows,
                                        pad_results, register_algo)
from sptag_tpu_torch.core.params import BKTParams
from sptag_tpu_torch.core.types import (DistCalcMethod, IndexAlgoType,
                                        VectorValueType, dtype_of)
from sptag_tpu_torch.graph.rng import RelativeNeighborhoodGraph
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.ops import graph as graph_ops
from sptag_tpu_torch.trees.bktree import BKTree
from sptag_tpu_torch.utils import flightrec, metrics, recompile_guard, trace

log = logging.getLogger(__name__)

# touched rows per chunk of an add's reverse-edge re-prune
_LINK_CHUNK = 4096

# the flight recorder's knobs, applied process-wide at set_parameter
_FLIGHT_PARAMS = frozenset({"flightrecorder", "flightrecorderevents",
                            "flightdumponslowquery"})
# the cascade's knobs: its int8 rows, their residency tier and the fp
# re-rank budget are snapshot state, rebuilt on a change
_CASCADE_PARAMS = frozenset({"cascadesearch", "corpustier",
                             "tierbudgetint8", "tierbudgetsketch"})
# knobs baked into the dense snapshot: a change rebuilds it
_DENSE_PARAMS = frozenset({"densereplicas", "denseclustersize"}) \
    | _CASCADE_PARAMS
# knobs baked into the walk's engine snapshot
_ENGINE_PARAMS = frozenset({"beampackedneighbors", "beamscoredtype",
                            "binnedtopk", "approxrecalltarget",
                            # baked into the engine at _make_engine
                            "flightdevicesamplerate", "rooflineprobe"}) \
    | _CASCADE_PARAMS


def _wait_for_card(result) -> None:
    """Block until the card's stream has done the work behind `result`'s
    tensors; numpy answers are back already."""
    for x in result:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
            return


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
        self._num_deleted = 0
        self._tree: Optional[BKTree] = None
        self._graph: Optional[np.ndarray] = None
        self._dense: Optional[DenseTreeSearcher] = None
        self._engine: Optional[GraphSearchEngine] = None
        # the slot scheduler over the current engine (ContinuousBatching)
        self._scheduler = None
        # the snapshots are stale (rows or structure changed) / only their
        # tombstone masks are
        self._dirty = True
        self._tombstones_dirty = False
        self._refine_dense = None     # the dense searcher of a graph build
        self._adds_since_rebuild = 0
        # the one background worker (tree rebuild, delta refine), lazy
        self._rebuild_pool = None
        self._rebuild_done = threading.Event()
        self._rebuild_done.set()      # no rebuild in flight
        self._rebuild_pending = False
        # bumped when row ids are remapped (build, load, compaction): an
        # in-flight background job detects that its snapshot went stale
        self._structure_gen = 0
        # bumped when an engine-baked parameter changes: a background
        # refine built under the old values must not publish
        self._engine_param_gen = 0
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
        return self._num_deleted

    @property
    def feature_dim(self) -> int:
        return 0 if self._host is None else self._host.shape[1]

    def contains_sample(self, vid: int) -> bool:
        return 0 <= vid < self._n and not self._deleted[vid]

    def get_sample(self, vid: int) -> np.ndarray:
        return self._host[vid]

    def _reserve(self, extra: int) -> None:
        self._host, self._deleted = grow_rows(self._host, self._deleted,
                                              self._n, extra)

    def _retrack_devmem(self) -> None:
        # DeviceBytesLedger re-enabled on a warm index: re-register the
        # materialized snapshots; slot pools re-track at their next resize
        with self._lock:
            if self._engine is not None:
                self._engine.register_devmem()
            if self._dense is not None:
                self._dense.register_devmem()

    def set_parameter(self, name: str, value: str) -> bool:
        ok = super().set_parameter(name, value)
        low = name.lower()
        if ok and (low in _DENSE_PARAMS or low in _ENGINE_PARAMS):
            with self._lock:
                if low in _DENSE_PARAMS:
                    self._dense = None
                if low in _ENGINE_PARAMS:
                    self._engine = None
                    self._engine_param_gen += 1
        if ok and low in _FLIGHT_PARAMS:
            # the flight recorder is process-wide: applied at once
            p = self.params
            flightrec.configure(
                enabled=(bool(int(getattr(p, "flight_recorder", 0)))
                         if low == "flightrecorder" else None),
                max_events=(int(getattr(p, "flight_recorder_events", 0))
                            or None
                            if low == "flightrecorderevents" else None),
                dump_dir=(getattr(p, "flight_dump_on_slow_query", "")
                          if low == "flightdumponslowquery" else None))
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

    def _load_tree(self, path: str):
        p = self.params
        return BKTree.load(
            path, kmeans_k=p.kmeans_k, leaf_size=p.leaf_size,
            samples=p.samples, metric=int(self.dist_calc_method),
            base=self.base, device=self.device)

    def _pivot_ids(self, rows: Optional[int] = None) -> np.ndarray:
        """Seed-pivot ids for an engine over `rows` corpus rows (default:
        the main tier): the forest's centers breadth-first, at most
        `pivot_budget` of them.  A tree newer than a delta absorb may name
        ids past a smaller engine's corpus; those are dropped."""
        rows = self._main_rows() if rows is None else rows
        max_pivots = min(rows, pivot_budget(self.params, rows))
        pivots = self._tree.collect_pivots(max_pivots)
        return pivots[pivots < rows]

    # ---- build ------------------------------------------------------------

    def _build(self, data: np.ndarray, checkpoint=None) -> None:
        self._host = np.ascontiguousarray(data)
        self._n = data.shape[0]
        self._deleted = np.zeros(self._n, bool)
        self._num_deleted = 0
        self._adds_since_rebuild = 0
        self._structure_gen += 1
        self._dirty = True
        # each stage is a span (utils/trace.py) whose duration build_stages
        # keeps too; the graph's stages are rng.stage_seconds'
        with trace.span("build.bkt_tree") as tree_span:
            # resumable build (utils/build_ckpt.py): the tree stage is
            # loaded from the checkpoint when a prior run already
            # finished it
            self._tree = None
            if checkpoint is not None:
                raw = checkpoint.get_bytes("tree")
                if raw is not None:
                    try:
                        self._tree = self._load_tree(io.BytesIO(raw))
                        log.info("build resume: tree stage from checkpoint")
                    except Exception:                  # noqa: BLE001
                        self._tree = None              # corrupt -> rebuild
            if self._tree is None:
                self._tree = self._new_tree()
                self._tree.build(self._host)
                if checkpoint is not None:
                    buf = io.BytesIO()
                    self._tree.save(buf)
                    checkpoint.put_bytes("tree", buf.getvalue())
        self.build_stages = {"tree": tree_span.seconds}
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
            with trace.span("build.rng_graph"):
                rng.build(self._host, int(self.dist_calc_method), self.base,
                          self._refine_search_factory,
                          checkpoint=checkpoint, guard_final=same_engine)
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
        """Tree partition of the main rows, plus nearest-center assignment
        of any row the tree does not cover (rows added since the last
        tree rebuild)."""
        n = self._main_rows()
        data = self._host[:n]
        centers, clusters = self._partition_tree(n)
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

    def _partition_tree(self, rows: Optional[int] = None):
        """Cut the tree into the dense layout's partition of `rows` rows
        (KDT cuts kd cells)."""
        return partition_from_tree(
            self._tree, self._main_rows() if rows is None else rows,
            self.params.dense_cluster_size)

    def _build_dense_searcher(self, replicas: Optional[int] = None,
                              cascade_ok: bool = True) -> DenseTreeSearcher:
        """Cluster-contiguous device snapshot from the current tree.  The
        graph build's refine searcher passes replicas=1 and no cascade: a
        quantized refine would bake its noise into the saved edges.  With
        ``CascadeSearch`` on a float corpus the layout is int8 with an
        exact fp re-rank of a ``TierBudgetInt8`` shortlist."""
        if replicas is None:
            replicas = getattr(self.params, "dense_replicas", 1)
        n = self._main_rows()
        data = self._host[:n]
        _, clusters = self._dense_clusters()
        cascade_cfg = None
        if cascade_ok and int(getattr(self.params, "cascade_search", 0)) \
                and np.issubdtype(data.dtype, np.floating):
            cascade_cfg = {
                "tier": str(getattr(self.params, "corpus_tier", "device")),
                "rerank_budget": int(getattr(self.params,
                                             "tier_budget_int8", 0)),
            }
        return DenseTreeSearcher(
            data, clusters, self._deleted[:n], self.dist_calc_method,
            self.base, replicas=replicas, device=self.device,
            cascade_cfg=cascade_cfg)

    def _get_dense(self) -> DenseTreeSearcher:
        """The dense snapshot, built at first use after a change and
        pinned by local reference like the engine."""
        if not getattr(self.params, "build_graph", 1):
            # dense-only: refresh without materializing the walk's engine
            # (a second device copy of data and graph no search reads).
            # Every add dirties the snapshot, so the next search rebuilds
            # the whole layout, as in the JAX package
            with self._lock:
                if self._dirty:
                    self._engine = None
                    self._dense = None
                    self._dirty = False
                    self._tombstones_dirty = False
                    self._snapshot_epoch += 1
                elif self._tombstones_dirty:
                    if self._dense is not None:
                        self._dense.set_deleted(
                            self._deleted[:self._main_rows()])
                    self._tombstones_dirty = False
                if self._dense is None:
                    self._dense = self._build_dense_searcher()
                return self._dense
        self._get_engine()          # refresh the dirty state under one lock
        dense = self._dense
        if dense is not None:
            return dense
        with self._lock:
            if self._dense is None:
                self._dense = self._build_dense_searcher()
            return self._dense

    # ---- walk snapshot ----------------------------------------------------

    def _make_engine(self, graph: np.ndarray,
                     rows: Optional[int] = None) -> GraphSearchEngine:
        """An engine snapshot over `rows` corpus rows (default: the main
        tier; delta rows are served by the delta scan)."""
        p = self.params
        n = self._main_rows() if rows is None else rows
        return GraphSearchEngine(
            self._host[:n], graph[:n], self._pivot_ids(n), self._deleted[:n],
            self.dist_calc_method, self.base,
            score_dtype=str(getattr(p, "beam_score_dtype", "auto")),
            packed_neighbors=bool(int(getattr(p, "beam_packed_neighbors",
                                              0))),
            binned_topk=str(getattr(p, "binned_topk", "off")),
            recall_target=float(getattr(p, "approx_recall_target", 0.99)),
            cascade_search=bool(int(getattr(p, "cascade_search", 0))),
            corpus_tier=str(getattr(p, "corpus_tier", "device")),
            device=self.device,
            device_sample_rate=float(getattr(
                p, "flight_device_sample_rate", 0.0)),
            roofline_probe=bool(int(getattr(p, "roofline_probe", 0))),
            kd_forest=self._kd_forest())

    def _kd_forest(self):
        """The (nodes, tree starts) a snapshot's engine puts on its device
        to seed from (KDT's kd forest); None seeds from the pivots."""
        return None

    def _get_engine(self) -> GraphSearchEngine:
        """Pin the current engine snapshot: readers take one unlocked
        reference of an immutable snapshot and keep it even if a writer
        publishes a newer one mid-search; every publish happens under the
        lock with an epoch bump."""
        eng = self._engine
        if eng is not None and not self._dirty \
                and not self._tombstones_dirty:
            return eng
        with self._lock:
            if self._dirty or self._engine is None:
                self._engine = self._make_engine(self._graph)
                self._dense = None
                self._dirty = False
                self._tombstones_dirty = False
                self._snapshot_epoch += 1
            elif self._tombstones_dirty:
                # delete-only change: swap the masks, keep the snapshots
                self._engine.set_deleted(self._deleted)
                if self._dense is not None:
                    self._dense.set_deleted(self._deleted)
                self._tombstones_dirty = False
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

    def search_mode_ready(self, mode: str, max_check: int = 0) -> bool:
        """True when serving `mode` needs no new device snapshot: what a
        server checks before it honours a client's search-mode override
        (a dense layout is about a second corpus copy on the card).  The
        configured mode is always ready; a pending mutation makes the
        other one not ready."""
        default_mc = int(getattr(self.params, "max_check", 8192))
        mode = self.resolve_search_mode(mode, max_check or default_mc)
        configured = self.resolve_search_mode(
            getattr(self.params, "search_mode", "beam"), default_mc)
        if mode == configured:
            return True
        if mode == "beam" and not getattr(self.params, "build_graph", 1):
            # no graph to walk: the search raises without allocating
            return True
        if self._dirty:
            return False
        return (self._dense if mode == "dense" else self._engine) is not None

    def _search_batch(self, queries: np.ndarray, k: int,
                      max_check: Optional[int] = None,
                      search_mode: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The mode's search and the front end's end of it, each a span
        (utils/trace.py): ``search.dispatch`` launching the work,
        ``search.wait`` the host blocked on the card's stream,
        ``search.readback`` the copy back and the padding."""
        with trace.span("search.dispatch"):
            out = self._search_launch(queries, k, max_check, search_mode)
        with trace.span("search.wait"):
            _wait_for_card(out)
        with trace.span("search.readback"):
            d, ids = recompile_guard.device_get(out)
            return pad_results(d, ids, k)

    def _search_launch(self, queries: np.ndarray, k: int,
                       max_check: Optional[int] = None,
                       search_mode: Optional[str] = None):
        """The mode's (Q, k') dists and ids, unpadded: numpy (the dense
        scan) or tensors on the card, possibly still in flight (the
        walk)."""
        if self._n == 0:
            raise RuntimeError("index is empty")
        p = self.params
        mc = max_check if max_check is not None else p.max_check
        mode = search_mode or getattr(p, "search_mode", "beam")
        if mode not in ("beam", "dense", "auto"):
            raise ValueError(f"unknown search mode {mode!r}")
        mode = self.resolve_search_mode(mode, mc)
        if mode == "dense":
            return self._get_dense().search(
                queries, min(k, self._n), max_check=mc,
                group=getattr(p, "dense_query_group", 0),
                union_factor=getattr(p, "dense_union_factor", 2),
                binned=str(getattr(p, "binned_topk", "off")),
                recall_target=float(
                    getattr(p, "approx_recall_target", 0.99)))
        if not getattr(p, "build_graph", 1):
            raise RuntimeError(
                "beam search needs the RNG graph, but this index was "
                "built with BuildGraph=0 (dense-only); use "
                "SearchMode=dense or rebuild with BuildGraph=1")
        return self._engine_search(queries, min(k, self._n), mc)

    def _engine_search(self, queries: np.ndarray, k: int, max_check: int):
        """The beam-walk branch of _search_launch: the walk's (Q, k)
        dists and ids as tensors on the card, still in flight (numpy
        through the slot scheduler, whose futures are waited for here).
        The walk's bodies count into ``search.walk_bodies``, those that
        ran the exact body's kernels (ops/walk_body.py) also into
        ``search.walk_fused_bodies``, and those of them that ran as one
        resident launch (a captured walk) into
        ``search.walk_resident_bodies``."""
        p = self.params
        if int(getattr(p, "continuous_batching", 0)):
            # the same results, continuously batched with concurrent
            # submitters
            return gather_futures(
                self._scheduler_submit(queries, k, max_check), k)
        seg = int(getattr(p, "beam_segment_iters", 0))
        engine = self._get_engine()
        kd = self._kd_backtrack(engine, max_check)
        out = engine.search_tensors(
            queries, k, max_check=max_check,
            beam_width=getattr(p, "beam_width", 16),
            nbp_limit=p.no_better_propagation_limit,
            seeds=None if kd else self._walk_seeds(queries, max_check),
            dynamic_pivots=p.other_dynamic_pivots,
            segment_iters=seg or None, kd_backtrack=kd)
        metrics.inc("search.walk_bodies", engine.last_iterations)
        metrics.inc("search.walk_fused_bodies", engine.last_fused_iterations)
        metrics.inc("search.walk_resident_bodies",
                    engine.last_resident_iterations)
        return out

    def _walk_seeds(self, queries: np.ndarray, max_check: int
                    ) -> Optional[np.ndarray]:
        """Per-query seeds of the walk (KDT's kd-tree descent); None
        seeds every query from the shared pivots."""
        return None

    def _kd_backtrack(self, engine: GraphSearchEngine,
                      max_check: int) -> int:
        """Other branches a tree that `engine` descends its kd forest for
        on its device, the walk's first step (KDT); 0 seeds as
        `_walk_seeds` says."""
        return 0

    def _get_scheduler(self) -> BeamSlotScheduler:
        """The slot scheduler over the current engine snapshot, made at
        first use.  When the engine changed, the old scheduler is retired:
        it takes no new queries and finishes those it has on its own
        (immutable) snapshot, as searches already running do."""
        engine = self._get_engine()
        with self._lock:
            sched = self._scheduler
            if (sched is not None and sched._engine is engine
                    and not sched._stopped and not sched._draining):
                return sched
            old = sched
            p = self.params
            sched = BeamSlotScheduler(
                engine, slots=int(getattr(p, "beam_slots", 1024)),
                segment_iters=int(getattr(p, "beam_segment_iters", 0)),
                name="beam-sched")
            self._scheduler = sched
        if old is not None:
            old.retire()
        return sched

    def _scheduler_submit(self, queries: np.ndarray, k: int,
                          max_check: int,
                          rids: Optional[list] = None) -> list:
        """Submit prepared queries to the slot scheduler; KDT overrides it
        to attach its per-query kd-tree seeds."""
        p = self.params
        return self._submit_each(
            queries, k, max_check, rids,
            beam_width=getattr(p, "beam_width", 16),
            nbp_limit=p.no_better_propagation_limit,
            dynamic_pivots=p.other_dynamic_pivots)

    def _submit_each(self, queries: np.ndarray, k: int, max_check: int,
                     rids: Optional[list], seeds: Optional[np.ndarray] = None,
                     **kw) -> list:
        """One scheduler future per query.  A background swap may retire
        the scheduler in the middle of the batch: the queries left go to
        its replacement.  Each query walks one snapshot either way, and
        the delta union drops a row that the shard and the new snapshot
        both hold (merge_topk)."""
        sched = self._get_scheduler()
        futs = []
        for i in range(queries.shape[0]):
            while True:
                try:
                    futs.append(sched.submit(
                        queries[i], k, max_check,
                        seeds=None if seeds is None else seeds[i],
                        rid=rids[i] if rids else "", **kw))
                    break
                except SchedulerStopped:
                    if not sched.draining:       # stopped, or it failed
                        raise
                    sched = self._get_scheduler()
        return futs

    def submit_batch(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     search_mode: Optional[str] = None,
                     rids: Optional[list] = None) -> list:
        """Per-query futures (core/index.py's contract).  With
        ContinuousBatching=1 and a mode that resolves to beam, each
        future resolves as its query retires from the slot scheduler;
        otherwise the base class's resolved futures.  The delta shard is
        scanned once for the whole batch and merged into each query's row
        as it resolves; the scheduler walks the engine pinned at submit,
        so the two tiers stay disjoint across a swap."""
        p = self.params
        mc = max_check if max_check is not None else p.max_check
        mode = search_mode or getattr(p, "search_mode", "beam")
        if (self._n == 0 or not int(getattr(p, "continuous_batching", 0))
                or mode not in ("beam", "auto")
                or self.resolve_search_mode(mode, mc) != "beam"
                or not getattr(p, "build_graph", 1)):
            return super().submit_batch(queries, k, max_check=max_check,
                                        search_mode=search_mode)
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.feature_dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim "
                f"{self.feature_dim}")
        queries = self._prepare_query(queries)
        delta = self._delta
        delta_res = None
        if delta is not None and delta.count:
            delta_res = delta.search(queries, min(k, delta.count),
                                     self._tombstone_mask())
        out = []
        for row, inner in enumerate(
                self._scheduler_submit(queries, min(k, self._n), mc,
                                       rids=rids)):
            outer: Future = Future()

            def _pad(f, outer=outer, row=row):
                e = f.exception()
                if e is not None:
                    outer.set_exception(e)
                    return
                d, ids = pad_result_row(*f.result(), k)
                if delta_res is not None:
                    md, mi = merge_topk(d[None, :], ids[None, :],
                                        delta_res[0][row:row + 1],
                                        delta_res[1][row:row + 1], k)
                    d, ids = md[0], mi[0]
                outer.set_result((d, ids))
            inner.add_done_callback(_pad)
            out.append(outer)
        return out

    def _health_payload(self) -> Optional[dict]:
        """Graph navigability (qualmon.graph_health): degree histogram,
        sampled reciprocal-edge fraction and the fraction of live rows
        reachable from the tree seeds, over the main-tier rows (a live
        delta's tail is unlinked by design); the scalars also ride
        qualmon gauges."""
        from sptag_tpu_torch.utils import qualmon

        if self._graph is None:
            return None
        n = min(self._main_rows(), len(self._graph))
        health = qualmon.graph_health(self._graph[:n], self._deleted[:n],
                                      self._pivot_ids())
        shard = getattr(self, "_quality_shard",
                        type(self).__name__.lower())
        qualmon.gauge("graph.mean_degree",
                      health.get("degree_mean", 0.0), shard=shard)
        qualmon.gauge("graph.reciprocal_fraction",
                      health.get("reciprocal_fraction", 0.0), shard=shard)
        qualmon.gauge("graph.reachable_fraction",
                      health.get("reachable_fraction", 0.0), shard=shard)
        return health

    def _exact_scan(self, queries: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The exact scan over the walk snapshot's resident corpus."""
        return self._get_engine().exact_scan(queries, k)

    @property
    def last_effective_group(self) -> int:
        """Query-group size the last dense search actually ran with."""
        return 0 if self._dense is None else self._dense.last_effective_group

    # ---- mutation ---------------------------------------------------------

    def _add(self, data: np.ndarray) -> int:
        begin = self._n
        count = data.shape[0]
        link = bool(getattr(self.params, "build_graph", 1))
        # the snapshot before the rows land; a dense-only index has no
        # graph to link into (new rows join their nearest cluster at the
        # next snapshot until the tree is rebuilt)
        engine = self._get_engine() if link else None
        self._reserve(count)
        self._host[begin:begin + count] = data
        self._n += count
        if link:
            self._graph = self._linked_graph(engine, self._graph[:begin],
                                             begin, count, self._host)
        else:
            self._graph = np.concatenate(
                [self._graph, np.full((count, self._graph.shape[1]), -1,
                                      np.int32)], axis=0)
        self._adds_since_rebuild += count
        if self._adds_since_rebuild >= self.params.add_count_for_rebuild:
            self._adds_since_rebuild = 0
            self._schedule_rebuild()
        self._dirty = True
        return begin

    def _linked_graph(self, engine: GraphSearchEngine,
                      graph_base: np.ndarray, begin: int, count: int,
                      host: np.ndarray) -> np.ndarray:
        """The linking pass, pure: a (begin + count, m') graph whose first
        `begin` rows extend `graph_base` with reverse edges and whose tail
        rows are freshly RNG-pruned.  Shared by the inline add and the
        background delta absorb, which runs it off the lock (rows
        [0, begin + count) of `host` are append-only stable).

        SPTAG's AddIndex searches each new node at AddCEF, RebuildNeighbors
        its row and InsertNeighbors the reverse edges one pair at a time;
        here the searches of a batch are one walk, and the reverse edges
        one batched RNG re-prune of every touched row: its old neighbours
        plus all its inserts, sorted by distance (stable), pruned by the
        same rule."""
        p = self.params
        m = p.neighborhood_size
        dev = self.device
        metric = int(self.dist_calc_method)
        new_rows = np.full((count, graph_base.shape[1]), -1, np.int32)
        grown = np.concatenate([graph_base, new_rows], axis=0)

        add_k = min(p.add_cef + 1, max(begin, 1))
        queries = host[begin:begin + count]
        d, ids = engine.search(
            queries, add_k, max_check=p.max_check_for_refine_graph,
            nbp_limit=p.no_better_propagation_limit)
        vecs = host[np.maximum(ids, 0)].astype(np.float32)
        keep = graph_ops.rng_select(
            torch.from_numpy(vecs).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(ids >= 0).to(dev), m, metric,
            self.base).cpu().numpy()
        sel = np.where(keep >= 0,
                       np.take_along_axis(ids, np.maximum(keep, 0), axis=1),
                       -1)
        grown[begin:begin + count, :m] = sel

        pairs = sel >= 0                                    # (count, m)
        if not pairs.any():
            return grown
        tgt = sel[pairs].astype(np.int64)                   # (P,) old nodes
        vid = np.broadcast_to(
            np.arange(begin, begin + count)[:, None], sel.shape)[pairs]
        uniq, inv = np.unique(tgt, return_inverse=True)
        U = len(uniq)
        # each target's inserted ids in a (U, max_ins) pad table
        order = np.argsort(inv, kind="stable")
        sorted_inv = inv[order]
        group_start = np.searchsorted(sorted_inv, np.arange(U))
        pos = np.arange(len(tgt)) - group_start[sorted_inv]
        max_ins = int(pos.max()) + 1
        ins = np.full((U, max_ins), -1, np.int64)
        ins[sorted_inv, pos] = vid[order]
        cand = np.concatenate([grown[uniq].astype(np.int64), ins], axis=1)
        width = grown.shape[1]
        # rows are independent: chunk them to bound the gathered vectors
        for lo in range(0, U, _LINK_CHUNK):
            c = cand[lo:lo + _LINK_CHUNK]
            valid = c >= 0
            cvecs = torch.from_numpy(
                host[np.maximum(c, 0)].astype(np.float32)).to(dev)
            tvecs = torch.from_numpy(
                host[uniq[lo:lo + _LINK_CHUNK]].astype(np.float32)).to(dev)
            cd = graph_ops.node_candidate_dists(tvecs, cvecs, metric,
                                                self.base).cpu().numpy()
            cd = np.where(valid, cd, MAX_DIST).astype(np.float32)
            ordc = np.argsort(cd, axis=1, kind="stable")
            cand_s = np.take_along_axis(c, ordc, axis=1)
            cd_s = np.take_along_axis(cd, ordc, axis=1)
            valid_s = np.take_along_axis(valid, ordc, axis=1)
            ordc_t = torch.from_numpy(ordc).to(dev)
            keep_r = graph_ops.rng_select(
                torch.gather(cvecs, 1, ordc_t[..., None].expand_as(cvecs)),
                torch.from_numpy(cd_s).to(dev),
                torch.from_numpy(valid_s).to(dev), width, metric,
                self.base).cpu().numpy()
            grown[uniq[lo:lo + _LINK_CHUNK]] = np.where(
                keep_r >= 0,
                np.take_along_axis(cand_s, np.maximum(keep_r, 0), axis=1),
                -1).astype(np.int32)
        return grown

    def _delete_id(self, vid: int) -> bool:
        if self._deleted[vid]:
            return False
        self._deleted[vid] = True
        self._num_deleted += 1
        # tombstones ride a mask swap, not a snapshot rebuild
        self._tombstones_dirty = True
        return True

    # ---- background tree rebuild ------------------------------------------

    def _pool(self):
        """The index's one background worker (lock held)."""
        if self._rebuild_pool is None:
            from sptag_tpu_torch.utils.threadpool import ThreadPool

            self._rebuild_pool = ThreadPool(name="bkt-rebuild")
            self._rebuild_pool.init(1)
        return self._rebuild_pool

    def _schedule_rebuild(self) -> None:
        """Queue a forest rebuild on the background worker (SPTAG's
        RebuildJob); searches keep serving the current snapshot.  At most
        one runs; a request arriving meanwhile coalesces into one more
        pass."""
        with self._lock:
            if not self._rebuild_done.is_set():
                self._rebuild_pending = True
                return
            pool = self._pool()
            self._rebuild_pending = False
            # enqueue before clearing: if add() raises (a concurrent
            # close()), _rebuild_done must stay set
            pool.add(self._rebuild_job)
            self._rebuild_done.clear()

    def _rebuild_job(self) -> None:
        try:
            while True:
                with self._lock:
                    gen = self._structure_gen
                    # main rows only: delta rows would put out-of-engine
                    # ids into the pivot set
                    snapshot = self._host[:self._main_rows()].copy()
                tree = self._new_tree()
                tree.build(snapshot)      # the long pass, no lock held
                with self._lock:
                    # a compaction or a rebuild remapped ids: drop it
                    if self._structure_gen == gen:
                        self._tree = tree
                        self._dirty = True    # the pivot set changed
                    if not self._rebuild_pending:
                        self._rebuild_done.set()
                        return
                    self._rebuild_pending = False
        except BaseException:
            # leave the old tree serving and unblock the waiters; the next
            # add schedules a fresh attempt
            with self._lock:
                self._rebuild_pending = False
                self._rebuild_done.set()
            raise

    def wait_for_rebuild(self, timeout: Optional[float] = None) -> None:
        """Block until an in-flight background rebuild has finished."""
        self._rebuild_done.wait(timeout)

    def stop_scheduler(self) -> None:
        """Stop the slot scheduler's worker, if one runs (queries it still
        holds fail with SchedulerStopped); the next scheduled search makes
        a new one.  A server calls it when it stops."""
        with self._lock:
            sched, self._scheduler = self._scheduler, None
        if sched is not None:
            sched.stop()

    def close(self) -> None:
        """Stop the background worker and the scheduler (idempotent); the
        swaps happen under the lock, the joins outside it (a running job
        needs the lock to finish)."""
        with self._lock:
            pool, self._rebuild_pool = self._rebuild_pool, None
        if pool is not None:
            pool.stop()
        self.stop_scheduler()

    def __del__(self):                    # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:                              # noqa: BLE001
            pass

    # ---- delta shard and the background swap -------------------------------

    def _append_rows_unlinked(self, data: np.ndarray) -> Optional[int]:
        """Rows land in host storage, unlinked, and the snapshots stay:
        the delta scan serves them until a refine absorbs the tail.  The
        graph keeps exactly `_main_rows()` rows meanwhile."""
        begin = self._n
        count = data.shape[0]
        self._reserve(count)
        self._host[begin:begin + count] = data
        self._n += count
        return begin

    def _tombstone_mask(self) -> Optional[np.ndarray]:
        return self._deleted[:self._n]

    def _absorb_delta_impl(self, begin: int, count: int) -> None:
        """The synchronous absorb (lock held; overflow, save, refine):
        link the tail against an engine over [0, begin), then let the
        next snapshot cover everything."""
        if getattr(self.params, "build_graph", 1):
            engine = self._engine
            if engine is None or engine.n != begin or self._dirty:
                engine = self._make_engine(self._graph, rows=begin)
            self._graph = self._linked_graph(
                engine, self._graph[:begin], begin, count, self._host)
            self._adds_since_rebuild += count
            if self._adds_since_rebuild >= \
                    self.params.add_count_for_rebuild:
                self._adds_since_rebuild = 0
                self._schedule_rebuild()
        else:
            self._graph = np.concatenate(
                [self._graph[:begin],
                 np.full((count, self._graph.shape[1]), -1, np.int32)])
        self._dirty = True

    def _schedule_auto_refine(self) -> None:
        """Queue the background absorb + swap; at most one in flight (the
        job re-checks the threshold when it ends)."""
        with self._lock:
            if self._refine_in_flight:
                return
            d = self._delta
            if d is None or not d.count:
                return
            if not getattr(self.params, "build_graph", 1):
                # dense-only: absorbing is a partition reassignment at the
                # next snapshot, cheap enough inline
                self._absorb_delta_locked()
                return
            pool = self._pool()
            self._refine_in_flight = True
            try:
                pool.add(self._auto_refine_job)
            except BaseException:
                self._refine_in_flight = False
                raise

    def _auto_refine_job(self) -> None:
        """The background refine and snapshot swap, without drain: link
        the delta tail into a copy of the graph and build the new engine
        off the lock (searches and acks go on), then publish under the
        lock.  A compaction, a synchronous absorb or an engine-baked
        set_parameter that raced the build wins: the result is dropped.
        Staleness is bounded by this job's wall time."""
        t0 = time.monotonic()
        try:
            with self._lock:
                d = self._delta
                if d is None or not d.count:
                    return
                gen = self._structure_gen
                pgen = self._engine_param_gen
                b0 = d.base_id
                n0 = b0 + d.count
                host = self._host          # pinned; rows [0, n0) stable
                graph_base = self._graph[:b0].copy()
                engine = self._engine
                if engine is None or engine.n != b0 or self._dirty:
                    engine = None
            if flightrec.enabled():
                flightrec.record("index", "swap_begin",
                                 payload={"rows": n0 - b0, "base": b0})
            if engine is None:
                engine = self._make_engine(graph_base, rows=b0)
            new_graph = self._linked_graph(engine, graph_base, b0,
                                           n0 - b0, host)
            new_engine = self._make_engine(new_graph, rows=n0)
            if new_engine.device.type == "cuda":
                # the snapshot is complete on the card before any reader
                # can pin it
                torch.cuda.synchronize(new_engine.device)
            with self._lock:
                d = self._delta
                if self._structure_gen != gen or d is None \
                        or d.base_id != b0 \
                        or self._engine_param_gen != pgen:
                    metrics.inc("mutation.swap_stale_discards")
                    return
                # the whole linked graph: its prefix rows carry the
                # reverse edges into the absorbed tail
                self._graph = new_graph
                # tombstones that landed during the build, then publish
                new_engine.set_deleted(self._deleted[:n0])
                self._engine = new_engine
                self._dense = None
                self._dirty = False
                self._tombstones_dirty = False
                self._snapshot_epoch += 1
                self._swap_count += 1
                tail = (self._host[n0:self._n].copy()
                        if self._n > n0 else None)
                self._delta = d.rebased(n0, tail)
                metrics.set_gauge(
                    "mutation.delta_rows",
                    self._delta.count if self._delta is not None else 0)
                self._adds_since_rebuild += n0 - b0
                if self._adds_since_rebuild >= \
                        self.params.add_count_for_rebuild:
                    self._adds_since_rebuild = 0
                    self._schedule_rebuild()
                old_sched, self._scheduler = self._scheduler, None
            if old_sched is not None:
                old_sched.retire()       # its resident queries finish
            t1 = time.monotonic()
            with self._lock:
                self._swap_windows = tuple(self._swap_windows[-15:]) + (
                    (t0 * 1000.0, t1 * 1000.0),)
            metrics.inc("mutation.swaps")
            metrics.observe("mutation.swap_s", t1 - t0)
            if flightrec.enabled():
                flightrec.record("index", "swap_publish",
                                 dur_ns=int((t1 - t0) * 1e9),
                                 payload={"rows": n0 - b0,
                                          "epoch": self._snapshot_epoch})
            self.publish_quality_health(background=True)
        except BaseException:
            # the delta keeps serving; the next trigger retries
            metrics.inc("mutation.refine_errors")
            log.exception("background delta refine failed")
        finally:
            with self._lock:
                self._refine_in_flight = False
            self._maybe_auto_refine()

    # ---- refine (compaction) ----------------------------------------------

    def _refine_impl(self) -> None:
        """SPTAG BKT::RefineIndex: drop the tombstoned rows, remap ids,
        rebuild the forest, run one refine pass (the final pass of the
        rebuild: FinalRefineSearchMode applies) and repair orphans."""
        self._structure_gen += 1     # stale for an in-flight rebuild
        keep = np.flatnonzero(~self._deleted[:self._n])
        remap = np.full(self._n, -1, np.int64)
        remap[keep] = np.arange(len(keep))
        self._host = np.ascontiguousarray(self._host[keep])
        g = self._graph[keep]
        g = np.where(g >= 0, remap[np.maximum(g, 0)], -1).astype(np.int32)
        # each row's surviving neighbours to the front
        order = np.argsort(g < 0, axis=1, kind="stable")
        g = np.take_along_axis(g, order, axis=1)
        self._graph = g
        self._n = len(keep)
        self._deleted = np.zeros(self._n, bool)
        self._num_deleted = 0
        if self.metadata is not None:
            self.metadata = self.metadata.refine(keep.tolist())
        if self._meta_to_vec is not None:
            self.build_meta_mapping()
        with trace.span("build.bkt_tree") as tree_span:
            self._tree = self._new_tree()
            self._tree.build(self._host[:self._n])
        self.build_stages = {"tree": tree_span.seconds}
        if getattr(self.params, "build_graph", 1):
            rng = self._new_graph()
            rng.graph = g
            with trace.span("build.refine_pass") as refine_span:
                try:
                    rng.refine_once(
                        self._host[:self._n],
                        self._refine_search_factory(g, final=True),
                        g.shape[1], int(self.dist_calc_method), self.base)
                finally:
                    self._refine_dense = None   # free the refine snapshot
                rng.repair_connectivity()
            self._graph = rng.graph
            self.build_stages["refine_pass"] = refine_span.seconds
        self._adds_since_rebuild = 0
        self._dirty = True

    # ---- persistence ------------------------------------------------------

    def _blob_writers(self):
        """Blob order: vectors, tree, graph, deletes (SPTAG's)."""
        p = self.params
        return [
            (p.vector_file,
             lambda f: fmt.write_matrix(f, self._host[:self._n])),
            (p.tree_file, lambda f: self._tree.save(f)),
            (p.graph_file, lambda f: fmt.write_graph(f, self._graph)),
            (p.delete_file,
             lambda f: fmt.write_deletes(f, self._deleted[:self._n])),
        ]

    def _load_vectors_stream(self, f) -> None:
        data = fmt.read_matrix(f, dtype_of(self.value_type))
        self._host = np.ascontiguousarray(data)
        self._n = data.shape[0]
        self._deleted = np.zeros(self._n, bool)
        self._num_deleted = 0
        self._adds_since_rebuild = 0
        self._structure_gen += 1     # stale for an in-flight rebuild
        self._dense = None
        self._engine = None
        self._dirty = True

    def _load_tree_stream(self, f) -> None:
        self._tree = self._load_tree(f)

    def _load_graph_stream(self, f) -> None:
        self._graph = fmt.read_graph(f)

    def _load_deletes_stream(self, f) -> None:
        mask = fmt.read_deletes(f)
        self._deleted[:len(mask)] = mask[:self._n]
        self._num_deleted = int(self._deleted.sum())

    def _blob_loaders(self):
        p = self.params
        return [(p.vector_file, self._load_vectors_stream, False),
                (p.tree_file, self._load_tree_stream, False),
                (p.graph_file, self._load_graph_stream, False),
                (p.delete_file, self._load_deletes_stream, True)]
