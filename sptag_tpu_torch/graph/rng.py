"""RelativeNeighborhoodGraph — the k-NN graph with RNG pruning (port of
``sptag_tpu/graph/rng.py``).

The build (SPTAG NeighborhoodGraph::BuildGraph / RefineGraph):

1. ``TPTNumber`` random-projection trees (graph/tptree.py, host numpy, the
   JAX package's generator stream) cut the corpus into leaves of at most
   ``TPTLeafSize`` rows; each leaf is joined all-pairs on the device and
   every row keeps its best ``NeighborhoodSize * GraphNeighborhoodScale``
   candidates, merged across trees (ops/graph.py);
2. the candidate lists are RNG-pruned once at that wide width;
3. ``RefineIterations`` passes re-search every row through the index's
   search function (dense or beam) and RNG-prune the results — non-final
   passes at ``CEF * GraphCEFScale`` and wide width, the final pass at
   ``CEF`` and ``NeighborhoodSize``; a sampled accuracy guard rolls back a
   pass that collapses the graph;
4. every zero-in-degree row gets a reverse edge (``repair_connectivity``).

The corpus is copied to the device once per build; gathers of candidate
vectors happen there.  Everything that decides an edge — the generator
streams, the chunking and padding of the refine searches, tie rules, the
guard — is the JAX package's, so the same search function gives the same
graph.

A resumable build (`checkpoint`, utils/build_ckpt.py) saves the TPT
candidate merge (throttled, always after the last tree) and every
non-final refine pass, in the JAX package's stage names and layouts, and
resumes at the first incomplete stage.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.graph.tptree import tpt_partition
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import graph as graph_ops
from sptag_tpu_torch.utils import round_up

log = logging.getLogger(__name__)

MAX_DIST = np.float32(3.4e38)

# device budget for one (B, P, P) all-pairs tensor (floats)
_ALLPAIRS_BUDGET = 1 << 26
# node rows per rng_select / refine chunk
_PRUNE_CHUNK = 4096
# min seconds between candidate-stage checkpoint rewrites (build_candidates)
_CKPT_MIN_INTERVAL_S = 60.0

# SearchFn(queries (Q, D), k) -> (dists (Q, k), ids (Q, k)), numpy
SearchFn = Callable[[np.ndarray, int], Tuple[np.ndarray, np.ndarray]]


def _pad_rows(arr: np.ndarray, rows: int, fill) -> np.ndarray:
    """Pad arr's first axis up to `rows` with `fill`."""
    if arr.shape[0] >= rows:
        return arr
    pad = np.full((rows - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


class RelativeNeighborhoodGraph:
    def __init__(self, neighborhood_size: int = 32, tpt_number: int = 32,
                 tpt_leaf_size: int = 2000, neighborhood_scale: int = 2,
                 cef_scale: int = 2, refine_iterations: int = 2,
                 cef: int = 1000, tpt_top_dims: int = 5,
                 tpt_samples: int = 1000,
                 refine_accuracy_guard: bool = True,
                 refine_accuracy_floor: float = 0.35,
                 device: DeviceLike = None):
        self.neighborhood_size = neighborhood_size
        self.tpt_number = tpt_number
        self.tpt_leaf_size = tpt_leaf_size
        self.neighborhood_scale = neighborhood_scale
        self.cef_scale = cef_scale
        self.refine_iterations = refine_iterations
        self.cef = cef
        self.tpt_top_dims = tpt_top_dims
        self.tpt_samples = tpt_samples
        self.refine_accuracy_guard = refine_accuracy_guard
        self.refine_accuracy_floor = refine_accuracy_floor
        self.device = device          # resolved by build(), which needs it
        self._data_d = self._data_f = None
        # (N, row_width) int32 neighbour ids, -1 padded
        self.graph = np.zeros((0, neighborhood_size), np.int32)
        #: wall seconds of each stage of the last build
        self.stage_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------ build

    def _upload(self, data: np.ndarray) -> None:
        """Device copies of the corpus for one build: as stored (exact
        distances of the accuracy estimate) and as float32 (the graph
        functions' input)."""
        self.device = resolve_device(self.device)
        self._data_d = torch.from_numpy(np.ascontiguousarray(data)).to(
            self.device)
        self._data_f = self._data_d.to(torch.float32)

    def build(self, data: np.ndarray, metric: int, base: int,
              search_fn_factory: Optional[Callable[..., SearchFn]] = None,
              seed: int = 31, checkpoint=None,
              guard_final: bool = True) -> None:
        """Full build: TPT candidates, the wide prune, then refine passes.

        `search_fn_factory(graph, final=bool)` returns a SearchFn over the
        current graph (`final` marks the pass that defines the saved
        edges); without it the build stops after the prune.
        `checkpoint` (utils/build_ckpt.BuildCheckpoint): each non-final
        refine pass saves its output graph and a resumed build skips every
        pass a prior run completed (the candidate stage checkpoints inside
        build_candidates)."""
        self.stage_seconds = {}
        self._upload(data)
        try:
            self._build(data, metric, base, search_fn_factory, seed,
                        guard_final, checkpoint)
        finally:
            self._data_d = self._data_f = None

    def _timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stage_seconds[name] = time.perf_counter() - t0
        return out

    def _build(self, data, metric, base, search_fn_factory, seed,
               guard_final, checkpoint=None) -> None:
        m = self.neighborhood_size
        # RefineIterations counts SEARCH passes, like the reference's
        # m_iRefineIter (its first pass walks the raw TPT candidate rows)
        passes = self.refine_iterations if search_fn_factory is not None \
            else 0
        width_wide = min(max(m * self.neighborhood_scale, 1),
                         max(data.shape[0] - 1, 1))
        start = 0
        if checkpoint is not None and passes > 0:
            for it in reversed(range(passes - 1)):     # last pass not saved
                saved = checkpoint.get_arrays(f"graph_pass{it}")
                if saved is not None:
                    self.graph = saved["graph"]
                    start = it + 1
                    log.info("build resume: refine pass %d/%d from "
                             "checkpoint", it + 1, passes)
                    break
        if start == 0:
            cand_ids, cand_d = self._timed(
                "tpt_candidates", self.build_candidates, data, metric, base,
                seed, checkpoint=checkpoint)
            # prune-only width: wide when refine passes will narrow it,
            # the final width when none will (RefineIterations=0)
            self.graph = self._timed(
                "prune", self.prune_candidates, data, cand_ids, cand_d,
                width_wide if passes > 0 else m, metric, base)
        # accuracy guard: a pass that both drops the paired estimate and
        # lands below the absolute floor is rolled back and the remaining
        # passes skipped.  An engine-switch final pass (guard_final=False)
        # is measured but never rolled back
        guard = self.refine_accuracy_guard and passes > 0 and \
            (guard_final or passes > 1)
        acc_truth = pre_acc = None
        if guard and start < passes:
            acc_truth = self.accuracy_truth(data, metric, base, width=m)
            pre_acc = self.accuracy_estimation(data, metric, base,
                                               width=m, truth=acc_truth)
        for it in range(start, passes):
            last = it == passes - 1
            width = m if last else width_wide
            before = self.graph if guard else None
            t0 = time.perf_counter()
            fn = search_fn_factory(self.graph, final=last)
            self.refine_once(data, fn, width, metric, base,
                             cef=(self.cef if last
                                  else self.cef * self.cef_scale))
            self.stage_seconds[f"refine_pass_{it + 1}"] = \
                time.perf_counter() - t0
            if guard or log.isEnabledFor(logging.INFO):
                acc = self.accuracy_estimation(data, metric, base,
                                               width=(m if guard else None),
                                               truth=acc_truth)
                log.info("RNG refine pass %d/%d width=%d acc=%.4f",
                         it + 1, passes, width, acc)
                if guard and acc < pre_acc - 0.02 and \
                        acc < self.refine_accuracy_floor and \
                        (guard_final or not last):
                    log.warning(
                        "RNG refine pass %d/%d DEGRADED sampled graph "
                        "accuracy %.4f -> %.4f (starved search budget? "
                        "MaxCheckForRefineGraph raises it) — pass rolled "
                        "back, remaining passes skipped; lower "
                        "RefineAccuracyFloor (now %.2f) or set "
                        "RefineAccuracyGuard=0 to keep degrading passes",
                        it + 1, passes, pre_acc, acc,
                        self.refine_accuracy_floor)
                    # rows are in RNG-keep order, so truncation keeps the
                    # top-m picks
                    self.graph = (before[:, :m].copy()
                                  if before.shape[1] > m else before)
                    break
                pre_acc = acc
            if checkpoint is not None and not last:
                # the final pass is not checkpointed: the build's own save
                # captures the finished graph
                checkpoint.put_arrays(f"graph_pass{it}", graph=self.graph)
        self.repair_connectivity()

    def repair_connectivity(self) -> None:
        """Give every zero-in-degree node a reverse edge from its own
        nearest stored neighbour: the batched walk seeds from a bounded
        pivot set, so an orphan row would be findable by no budget.
        Overwriting the last (farthest) slot costs the least-useful edge,
        and only tails with other in-edges are evicted."""
        g = self.graph
        n = g.shape[0]
        if n == 0:
            return
        indeg = np.bincount(np.clip(g[g >= 0].ravel(), 0, n - 1),
                            minlength=n)
        fixed = 0
        for _ in range(16):                    # cascade bound
            orphans = np.flatnonzero(indeg[:n] == 0)
            progress = False
            for v in orphans:
                nbrs = g[v][g[v] >= 0]
                placed = False
                for t in nbrs:                 # free slot costs nothing
                    row = g[t]
                    empty = np.flatnonzero(row < 0)
                    if len(empty):
                        row[empty[0]] = v
                        placed = True
                        break
                if not placed:
                    for t in nbrs:
                        row = g[t]
                        tail = int(row[-1])
                        if tail >= 0 and tail != v and indeg[tail] > 1:
                            row[-1] = v
                            indeg[tail] -= 1
                            placed = True
                            break
                if placed:
                    indeg[v] += 1
                    fixed += 1
                    progress = True
            if not progress or not len(orphans):
                break
        if fixed:
            log.info("connectivity repair: %d orphan nodes linked", fixed)

    def build_candidates(self, data: np.ndarray, metric: int, base: int,
                         seed: int, checkpoint=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """TPT forest -> (N, C) best-candidate lists, ascending distance.
        Each tree draws from its own ``[seed, t]``-keyed generator, as in
        the JAX package, so a checkpointed resume (`checkpoint` stage
        "candidates") reproduces the interrupted run's partition stream;
        the running lists stay on the device and go to the host only to be
        written."""
        n = data.shape[0]
        C = min(max(self.neighborhood_size * self.neighborhood_scale, 1),
                max(n - 1, 1))
        dev = self._data_f.device
        cand_ids = torch.full((n, C), -1, dtype=torch.int32, device=dev)
        cand_d = torch.full((n, C), float(MAX_DIST), device=dev)
        start_t = 0
        if checkpoint is not None:
            saved = checkpoint.get_arrays("candidates")
            if (saved is not None
                    and saved["cand_ids"].shape == tuple(cand_ids.shape)):
                cand_ids = torch.from_numpy(saved["cand_ids"]).to(dev)
                cand_d = torch.from_numpy(saved["cand_d"]).to(dev)
                start_t = int(saved["trees_done"])
                log.info("build resume: %d/%d TPT trees from checkpoint",
                         start_t, self.tpt_number)
        last_save = time.monotonic()
        for t in range(start_t, self.tpt_number):
            rng = np.random.default_rng([seed, t])
            leaves = tpt_partition(data, self.tpt_leaf_size,
                                   self.tpt_top_dims, self.tpt_samples, rng)
            new_ids, new_d = self._tree_candidates(leaves, C, metric, base)
            cand_ids, cand_d = graph_ops.merge_candidates(
                cand_ids, cand_d, new_ids, new_d)
            if checkpoint is not None:
                # throttled: the (N, C) lists can be ~100 MB, so rewriting
                # them after every tree would put O(trees x N x C) of
                # synchronous IO on the build; the last tree always writes
                now = time.monotonic()
                if (t + 1 == self.tpt_number
                        or now - last_save >= _CKPT_MIN_INTERVAL_S):
                    checkpoint.put_arrays(
                        "candidates", cand_ids=cand_ids.cpu().numpy(),
                        cand_d=cand_d.cpu().numpy(),
                        trees_done=np.int64(t + 1))
                    last_save = now
        return cand_ids.cpu().numpy(), cand_d.cpu().numpy()

    def _tree_candidates(self, leaves, C, metric, base):
        """All-pairs join of one tree's leaves -> (N, C) device candidates.
        The leaf pad P is the largest leaf rounded up to 32: padding rows
        score MAX_DIST, so it does not change a result."""
        data_f = self._data_f
        n, dev = data_f.shape[0], data_f.device
        new_ids = torch.full((n, C), -1, dtype=torch.int32, device=dev)
        new_d = torch.full((n, C), float(MAX_DIST), device=dev)
        P = round_up(max(len(leaf) for leaf in leaves), 32)
        batch = max(1, _ALLPAIRS_BUDGET // (P * P))
        for off in range(0, len(leaves), batch):
            chunk = leaves[off:off + batch]
            B = len(chunk)
            ids_pad = np.full((B, P), -1, np.int64)
            for b, leaf in enumerate(chunk):
                ids_pad[b, :len(leaf)] = leaf
            ids_t = torch.from_numpy(ids_pad).to(dev)
            valid = ids_t >= 0
            vecs = data_f[ids_t.clamp_min(0)] * valid[..., None]
            pos, d = graph_ops.leaf_allpairs_topk(vecs, valid, C, metric,
                                                  base)
            k = pos.shape[2]
            gids = torch.gather(
                ids_t, 1, pos.clamp_min(0).to(torch.int64).reshape(B, P * k)
            ).reshape(B, P, k)
            gids = torch.where(pos >= 0, gids, -1)
            rows = ids_t[valid]
            new_ids[rows] = gids[valid].to(torch.int32)
            new_d[rows] = d[valid]
        return new_ids, new_d

    # ----------------------------------------------------------------- refine

    def _rng_rows(self, cand_ids: np.ndarray, cand_d: np.ndarray, width: int,
                  metric: int, base: int) -> np.ndarray:
        """RNG-prune (B, C) sorted candidate rows into (B, width) ids."""
        dev = self._data_f.device
        ids_t = torch.from_numpy(np.ascontiguousarray(cand_ids)).to(dev)
        vecs = self._data_f[ids_t.clamp_min(0).to(torch.int64)]
        keep = graph_ops.rng_select(
            vecs, torch.from_numpy(np.ascontiguousarray(cand_d)).to(dev),
            ids_t >= 0, width, metric, base).cpu().numpy()
        return np.where(keep >= 0,
                        np.take_along_axis(cand_ids, np.maximum(keep, 0),
                                           axis=1), -1).astype(np.int32)

    def prune_candidates(self, data: np.ndarray, cand_ids: np.ndarray,
                         cand_d: np.ndarray, width: int, metric: int,
                         base: int) -> np.ndarray:
        """RNG-prune sorted candidate lists into rows of `width` neighbours
        (each row independently, in chunks of `_PRUNE_CHUNK`)."""
        n = cand_ids.shape[0]
        out = np.full((n, width), -1, np.int32)
        for off in range(0, n, _PRUNE_CHUNK):
            stop = min(off + _PRUNE_CHUNK, n)
            out[off:stop] = self._rng_rows(cand_ids[off:stop],
                                           cand_d[off:stop], width, metric,
                                           base)
        return out

    def refine_once(self, data: np.ndarray, search_fn: SearchFn, width: int,
                    metric: int, base: int,
                    cef: Optional[int] = None) -> None:
        """One refine pass: re-search every node (self excluded) at a
        `cef` budget and RNG-prune the results; every search of the pass
        reads the pass-start graph.  The tail chunk is padded to the chunk
        size by repeating its first row, as in the JAX package: a grouped
        search's groups depend on the whole batch.  Outside a build (a
        compaction's pass) the corpus is uploaded for the pass."""
        if self._data_f is None:
            self._upload(data)
            try:
                self.refine_once(data, search_fn, width, metric, base, cef)
            finally:
                self._data_d = self._data_f = None
            return
        n = data.shape[0]
        cef = self.cef if cef is None else cef
        k = min(cef + 1, n)
        new_graph = np.full((n, width), -1, np.int32)
        for off in range(0, n, _PRUNE_CHUNK):
            stop = min(off + _PRUNE_CHUNK, n)
            cnt = stop - off
            pad = _PRUNE_CHUNK if n > _PRUNE_CHUNK else cnt
            queries = _pad_rows(data[off:stop], pad, 0)
            if cnt < pad:
                queries[cnt:] = data[off]
            d, ids = search_fn(queries, k)
            d, ids = d[:cnt], ids[:cnt]
            # drop self-hits, keep ascending order
            is_self = ids == np.arange(off, stop)[:, None]
            d = np.where(is_self, MAX_DIST, d)
            order = np.argsort(d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
            ids = np.where(d >= MAX_DIST, -1, ids)
            C = min(ids.shape[1], cef)
            new_graph[off:stop] = self._rng_rows(ids[:, :C], d[:, :C],
                                                 width, metric, base)
        self.graph = new_graph

    # ------------------------------------------------------- quality estimate

    def accuracy_truth(self, data: np.ndarray, metric: int, base: int,
                       samples: int = 100, seed: int = 0,
                       width: Optional[int] = None):
        """(pick, truth) for `accuracy_estimation`: a seeded sample of rows
        and each one's exact nearest `width` neighbours, self excluded."""
        n = data.shape[0]
        rng = np.random.default_rng(seed)
        pick = rng.choice(n, min(samples, n), replace=False)
        data_d = getattr(self, "_data_d", None)
        if data_d is None:
            self._upload(data)
            data_d = self._data_d
        q = data_d[torch.from_numpy(pick).to(data_d.device)]
        d = dist_ops.pairwise_distance(q, data_d, metric).cpu().numpy()
        d[np.arange(len(pick)), pick] = MAX_DIST
        m = min(width or self.graph.shape[1], max(n - 1, 1))
        part = np.argpartition(d, m - 1, axis=1)[:, :m]
        rows = np.take_along_axis(d, part, axis=1)
        order = np.argsort(rows, axis=1)
        return pick, np.take_along_axis(part, order, axis=1)

    def accuracy_estimation(self, data: np.ndarray, metric: int, base: int,
                            samples: int = 100,
                            seed: int = 0,
                            width: Optional[int] = None,
                            truth=None) -> float:
        """Sampled fraction of stored neighbours that are true nearest
        neighbours (SPTAG GraphAccuracyEstimation), over each row's first
        `width` neighbours."""
        n = data.shape[0]
        if n == 0 or self.graph.shape[0] == 0:
            return 0.0
        if truth is None:
            truth = self.accuracy_truth(data, metric, base, samples, seed,
                                        width=width)
        pick, true_ids = truth
        hits = 0
        total = 0
        for row, node in enumerate(pick):
            stored_row = self.graph[node] if width is None \
                else self.graph[node][:width]
            stored = set(int(x) for x in stored_row if x >= 0)
            if not stored:
                continue
            hits += len(stored & set(true_ids[row][:len(stored)].tolist()))
            total += len(stored)
        return hits / max(total, 1)

    # ------------------------------------------------------------ persistence

    def save(self, path_or_stream) -> None:
        fmt.write_graph(path_or_stream, self.graph)

    @classmethod
    def load(cls, path_or_stream, **kwargs) -> "RelativeNeighborhoodGraph":
        g = cls(**kwargs)
        g.graph = fmt.read_graph(path_or_stream)
        g.neighborhood_size = g.graph.shape[1]
        return g
