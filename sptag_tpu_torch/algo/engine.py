"""Batched beam-search engine (port of ``sptag_tpu/algo/engine.py``).

SPTAG's search pops one frontier node at a time, scores its graph
neighbours and stops when the MaxCheck budget is spent or
``ThresholdOfNumberOfContinuousNoBetterPropagation`` pops in a row fail to
improve the top-k.  Here a query batch walks together:

* seeding: one (Q, P) distance matrix against the pivot set collected
  from the BKT forest; the top-L pivots fill each query's beam, the rest
  form a sorted spare queue injected mid-walk when the frontier falls
  behind it or stalls (SPTAG's SearchTrees refill).  KDT seeds per
  query instead, from its kd forest: host ``seeds`` (trees/kdtree.py's
  descent), or, on an engine made with the forest (``kd_forest``) and a
  search given ``kd_backtrack``, the descent on the engine's device
  (ops/kd_descent.py) as the walk's first step, inside a captured graph
  too.  The seeds are de-duplicated, marked visited and scored as one
  batched contraction, and the walk runs without spares;
* each iteration pops the best B unexpanded beam entries at once, gathers
  their B*m neighbours, drops those already visited, scores the rest as
  one batched contraction and merges beam + candidates into the top-L;
  ``ceil(MaxCheck / B)`` iterations keep the budget;
* finalize: the exact float32 re-rank of the pool when the walk scored a
  bf16 shadow, tombstones filtered, final top-k.

The JAX package's ``lax.while_loop`` is a Python loop here.  Each row
carries its own iteration count and budget (``it``, ``t_limit``, (Q,)); a
row whose ``row_alive`` is false is an absorbing no-op (its pool no longer
changes), so the loop asks the card whether any row is alive only every
``_ALIVE_CHECK`` iterations — the one device-to-host sync of the body —
and the results are the same.  A row with ``t_limit`` 0 (a pad row, an
empty scheduler slot) is never alive.  On the card a chunk of at most
``_GRAPH_MAX_Q`` queries runs all T iterations with no sync inside one
CUDA graph, captured per padded shape and plan on each snapshot when
asked for the second time (at most ``_GRAPH_CACHE`` kept): the JAX
package's one compiled program per search, and the same results.  Rows
are independent, so chunking and batch padding do not change them either:
on the card every float32 distance of the walk (seeding, the in-loop
scoring, the re-rank) comes from ops/walk_dots.py's fixed-order kernels,
whose bits do not depend on the batch's shape, so a server that coalesces
requests answers a query alike in any batch.  ``chunk_size`` keeps the
JAX package's formula all the same.

Every capture, replay, CUDA event and stream of the walk runs under
``torch.cuda.device(self.device)`` and names that card's stream, so an
engine on ``cuda:1`` in a process whose current card is ``cuda:0``
captures, replays and times its own card's work (a mesh places one shard
a card, parallel/sharded.py).  ``search_tensors`` is ``search`` without
the readback: the (Q, k) distances and ids stay on the engine's card.

The walk's stages are spans (utils/trace.py), which every live
``torch.profiler`` session sees: per chunk ``walk.upload`` and either
``walk.seed``, ``walk.iterate`` and ``walk.finalize`` (the eager walk)
or ``walk.replay`` (a graph's copy-in, replay and clones), and
``walk.kd_seeds`` before ``walk.seed`` when the eager walk descends the
kd forest; every
``_ALIVE_CHECK`` eager bodies ``walk.alive_check``; and per eager body,
while a ``torch.profiler`` session is live, ``walk.pop``, ``walk.expand``
(the neighbour gather and the visited test), ``walk.score`` and
``walk.merge`` (spares, merge, top-L, counters): outside a session their
registry updates measured 1-3% of a host-paced walk.  On the card the
exact body's glue is ops/walk_body.py's two kernels around the scoring
launch: ``walk.pop`` wraps the pop-and-expand launch and ``walk.expand``
is entered empty.  A walk being
captured records none (`_Walk.run_all`); its capture is the port's
compile (``cuda.compile[graph_capture]``, utils/recompile_guard.py).  Such
a walk (a whole-walk graph, a captured segment) runs all its bodies as
one ``walk_resident`` launch where `walk_body.resident_walk` allows: one
cluster of CTAs a query row, the row's state in shared memory throughout
(``search.walk_resident_bodies`` counts its bodies).

The walk's state is the JAX package's (``seed_state``): ``run_segment``
advances it by at most S iterations and ``finalize`` retires it, so
``BeamSegmentIters`` (``_search_segmented``) and the slot scheduler
(algo/scheduler.py) run the same body as the monolithic walk and return
its results bit for bit.

The visited set is a (Q, N + 1) bool table per chunk (column N takes the
masked candidates) instead of the JAX package's packed bitset: PyTorch has
no scatter-OR, and setting bools needs none.  It is the same set, so the
walk is the same.  ``BinnedTopK`` switches the pop, the merge, the seeding
and the finalize to the bin-reduction forms (ops/topk_bins.py), with lazy
visited marking, exactly as the JAX package's binned body.  Every
``lax.top_k``/``argsort`` is a stable sort (lowest index first among ties).

``BeamScoreDtype=bf16`` keeps a bf16 shadow of a float32 corpus for the
in-loop scoring (half the bytes of the candidate-row gather; the queries
are cast to bf16 too) and re-ranks the final pool against the float32
rows, so returned distances are exact; seeds, pivots and the squared
norms stay float32.  The bf16 dots come out as float32 (ops/distance.py).
``BeamScoreDtype=auto`` is float32, as the JAX package resolves it off the
TPU.  ``BeamPackedNeighbors=1`` stores each node's m neighbour rows
contiguously in the scoring dtype (``nbr_vecs`` (N, m, D), ``nbr_sq``
(N, m)): B block reads per query instead of B*m scattered rows, at m times
the corpus's memory.

``CascadeSearch`` on a float corpus walks the int8 quantization
(ops/cascade.py): on ``CorpusTier=device`` it replaces the bf16 shadow as
the scoring corpus, dequantized in the load by ``walk_score_i8`` with the
float32 corpus's norms, and the finalize re-ranks the pool against the
resident float32 rows.  On ``host`` (``host_all`` acts as ``host``) the
int8 rows ARE the device corpus: their norms are rescaled by scale^2, the
pivots dequantized, KDT's seed rows dequantized in the load, and the
finalize reads the pool's ids back once and fetches only those float32
rows from host memory for the exact re-rank (the fixed-order kernel's
ROWS mode); such a walk always runs segmented.  Packed neighbours turn
off under the cascade.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.dense import _sorted_dup_mask
from sptag_tpu_torch.algo.flat import exact_device_scan
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.ops import cascade as cascade_ops
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import kd_descent
from sptag_tpu_torch.ops import walk_body
from sptag_tpu_torch.ops import walk_dots as walk_ops
from sptag_tpu_torch.ops import topk_bins
from sptag_tpu_torch.utils import (costmodel, devmem, flightrec, metrics,
                                   query_bucket, recompile_guard, roofline,
                                   trace)

MAX_DIST = walk_ops.MAX_DIST

# visited-table budget per search call in the JAX package's packed-bitset
# bytes (N/8 per query); it sets the chunk size
_VISITED_BUDGET = 1 << 29
# walk iterations between two "any row alive?" reads
_ALIVE_CHECK = 4
# query chunks of at most this many rows replay a CUDA graph on the card,
# padded up to the first bucket that holds them: one plan captures at most
# len(_GRAPH_BUCKETS) graphs.  On the H100 a replay beat the eager walk at
# every measured size up to 256 queries, padding included (PERF.md)
_GRAPH_BUCKETS = (4, 16, 64, 256)
_GRAPH_MAX_Q = _GRAPH_BUCKETS[-1]
# one CUDA-graph capture or replay at a time in the process, none while
# the profiler starts or stops, no capture while a profile runs
# (utils/trace.py); every capture and replay holds this lock
capture_lock = trace.capture_lock
# captured graphs kept per snapshot (each holds its own memory pool); the
# least recently replayed goes first.  A server's mixed traffic needs a
# graph per (padded size, plan): chip_smoke.py phase 12's option palette
# alone keeps 16-20 resident, and at 8 its ramp recaptured all along
# (PERF.md)
_GRAPH_CACHE = 32

#: the walk state's per-row tensors that a segment changes
STATE_KEYS = ("cand_ids", "cand_d", "expanded", "visited", "no_better",
              "ptr", "it")

# captures and replays of CUDA graphs, per card: the whole-walk graphs of
# small chunks and the scheduler's segment graphs
_graph_stats_lock = threading.Lock()
_graph_stats: Dict[str, Dict[str, int]] = {}
_GRAPH_STAT_KINDS = ("walk_captures", "walk_replays", "segment_captures",
                     "segment_replays")


def _note_graph(device, kind: str) -> None:
    with _graph_stats_lock:
        row = _graph_stats.setdefault(
            str(device), dict.fromkeys(_GRAPH_STAT_KINDS, 0))
        row[kind] += 1


def graph_stats() -> Dict[str, Dict[str, int]]:
    """Captures and replays of CUDA graphs since the last reset, by card
    (``str(device)``): ``walk_*`` the whole-walk graphs of small chunks,
    ``segment_*`` the scheduler's segment graphs (one a card for a mesh,
    parallel/mesh_engine.py)."""
    with _graph_stats_lock:
        return {dev: dict(row) for dev, row in _graph_stats.items()}


def reset_graph_stats() -> None:
    with _graph_stats_lock:
        _graph_stats.clear()


class DeviceGraph:
    """A captured CUDA graph and its card: `replay` counts each replay
    in `graph_stats`.  The caller holds `capture_lock`."""

    __slots__ = ("graph", "device", "kind")

    def __init__(self, graph, device, kind: str):
        self.graph, self.device, self.kind = graph, device, kind

    def replay(self) -> None:
        self.graph.replay()
        _note_graph(self.device, self.kind)


def capture_on(device, fn):
    """Warm `fn` up on a side stream of `device`, then capture it into a
    CUDA graph on that stream, with `device` current throughout: the
    graph and `fn`'s outputs, or (None, None) while a profile runs
    (utils/trace.py).  The capture holds `capture_lock`, so it holds back
    other cards' replays for as long as it lasts."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()                                             # warm-up
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture_lock:
            if trace.tracing():
                return None, None
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn()
        return graph, out


def _unmarked(name: str):
    """No span: what a walk captured into a CUDA graph records."""
    return contextlib.nullcontext()


def _num_words(n: int) -> int:
    """The JAX package's packed-bitset word count over ids [0, n]: the
    ledger's visited-set term (the port keeps a (Q, n + 1) bool table)."""
    return (n + 1 + 31) // 32


def beam_width_for(beam_width: int, max_check: int, L: int) -> int:
    """Budget-scaled beam width: max_check / 32 capped at 128, never below
    `beam_width`, never above L."""
    return max(1, min(max(beam_width, min(max_check // 32, 128)), L))


def beam_pool_size(k: int, max_check: int, n: int,
                   pool_size: Optional[int] = None) -> int:
    """Budget-scaled beam (frontier) capacity."""
    L = pool_size or max(2 * k, min(64 + max_check // 8, 1024))
    return min(max(L, k), n)


def _seed_from_pivots(pivot_ids, pivot_vecs, pivot_sqnorm, queries, L: int,
                      metric: int, n: int, seed_keep: int = 0):
    """Shared-pivot seeding: the top-L pivots by distance fill the beam,
    the rest (all, or `seed_keep` of them when binned) form the sorted
    spare queue; every pivot is marked visited.  `pivot_sqnorm` is the
    pivots' cached squared norms.  Returns (cand_ids, cand_d, visited
    (Q, n + 1) bool, spare_ids, spare_d)."""
    Q = queries.shape[0]
    P = pivot_ids.shape[0]
    dev = queries.device
    d0 = walk_ops.walk_distance(queries, pivot_vecs, metric, 1,
                                walk_ops.SHARED,
                                x_sqnorm=pivot_sqnorm)            # (Q, P)
    seed_ids = pivot_ids
    if P < L:
        d0 = torch.cat([d0, d0.new_full((Q, L - P), MAX_DIST)], dim=1)
        seed_ids = torch.cat([pivot_ids, pivot_ids.new_full((L - P,), -1)])
    if seed_keep > 0:
        K = min(L + seed_keep, d0.shape[1])
        sorted_d, cols = topk_bins.binned_topk(d0, K, topk_bins.pow2ceil(K))
    else:
        sorted_d, cols = dist_ops.smallest_k(d0, d0.shape[1])
    sorted_ids = torch.where(sorted_d < MAX_DIST, seed_ids[cols], -1)
    visited = torch.zeros((Q, n + 1), dtype=torch.bool, device=dev)
    # a -1 pivot (a mesh shard's padding, parallel/sharded.py) marks the
    # dump column only
    visited.index_fill_(1, torch.where(pivot_ids >= 0, pivot_ids, n), True)
    return (sorted_ids[:, :L], sorted_d[:, :L], visited,
            sorted_ids[:, L:], sorted_d[:, L:])


def _seed_from_seeds(data, sqnorm, seed_ids, queries, L: int, metric: int,
                     base: int, score_scale: float = 0.0):
    """Per-query seeding (KDT): the (Q, S) seed ids (-1 padded) are
    gathered and scored in one batched contraction; a seed reached twice
    keeps its first occurrence only, and every seed is marked visited.
    `score_scale` > 0 with int8 `data` (the host-tier cascade, whose device
    corpus IS the quantization) dequantizes the seed rows, so seeds live in
    the walk's scoring space; fp `data` (the device tier) is never scaled.
    Returns (cand_ids, cand_d, visited (Q, N + 1) bool)."""
    Q, S = seed_ids.shape
    N = data.shape[0]
    seed_ids = torch.where(seed_ids < N, seed_ids, -1)
    seeds_safe = torch.where(seed_ids >= 0, seed_ids, N)
    # a masked or repeated seed scores MAX_DIST and loads nothing
    d0 = walk_ops.walk_distance(
        queries, data, metric, base, walk_ops.GATHER,
        idx=torch.where(_sorted_dup_mask(seeds_safe), -1, seed_ids),
        x_sqnorm=sqnorm,
        score_scale=score_scale if data.dtype == torch.int8 else 0.0)
    visited = torch.zeros((Q, N + 1), dtype=torch.bool,
                          device=queries.device)
    visited.scatter_(1, seeds_safe, True)
    if S < L:
        d0 = torch.cat([d0, d0.new_full((Q, L - S), MAX_DIST)], dim=1)
        seed_ids = torch.cat([seed_ids, seed_ids.new_full((Q, L - S), -1)],
                             dim=1)
    cand_d, pos = dist_ops.smallest_k(d0, L)
    cand_ids = torch.where(cand_d < MAX_DIST, torch.gather(seed_ids, 1, pos),
                           -1)
    return cand_ids, cand_d, visited


def _init_state(queries, cand_ids, cand_d, visited, spare_ids=None,
                spare_d=None) -> Dict[str, Optional[torch.Tensor]]:
    """A fresh walk state over a seeded beam: the JAX package's 7-tuple
    (``cand_ids, cand_d, expanded, visited, no_better, ptr, it``) plus the
    queries and the spare queue (None without spares)."""
    Q = cand_ids.shape[0]
    dev = cand_ids.device
    zeros = torch.zeros(Q, dtype=torch.int64, device=dev)
    return {
        "queries": queries, "cand_ids": cand_ids, "cand_d": cand_d,
        # expanded has a dump column at L, visited one at N
        "expanded": torch.cat(
            [cand_ids < 0, torch.zeros((Q, 1), dtype=torch.bool,
                                       device=dev)], dim=1),
        "visited": visited, "no_better": zeros, "ptr": zeros.clone(),
        "it": zeros.clone(), "spare_ids": spare_ids, "spare_d": spare_d}


class _Walk:
    """The walk body over one state, the PyTorch form of the JAX package's
    ``_walk_machine``.  `t_limit` is the (Q,) per-row iteration budget;
    `visited` and `expanded` are updated in place, the rest replaced.

    The exact body (``merge_bins`` 0) is ops/walk_body.py's glue around
    the scoring launch: on the card its kernels (`fused`: two launches a
    body besides the scoring), on the CPU their plain versions; `run_all`
    runs all its bodies as one resident launch where `resident` holds.
    The binned body (``BinnedTopK``) keeps its PyTorch form here."""

    def __init__(self, eng: "GraphSearchEngine", state: dict, t_limit,
                 k: int, L: int, B: int, nbp_limit: int, inject: int,
                 merge_bins: int):
        if merge_bins:
            # the strided binning keeps the sorted beam prefix collision
            # free only when bins >= L
            assert merge_bins >= L, (merge_bins, L)
        self.eng = eng
        queries = state["queries"]
        self.queries = queries
        src = eng.score_src
        # the bf16 shadow scores bf16 queries; integer corpora keep theirs
        self.queries_s = (queries.to(src.dtype)
                          if queries.dtype != src.dtype
                          and queries.dtype.is_floating_point
                          and src.dtype.is_floating_point else queries)
        self.L, self.B, self.k_eff = L, B, min(k, L)
        self.t_limit = t_limit
        self.nbp_limit = nbp_limit
        self.merge_bins = merge_bins
        Q = queries.shape[0]
        dev = queries.device
        spare_ids = state.get("spare_ids")
        self.Ps = 0 if spare_ids is None else spare_ids.shape[1]
        self.inject = inject
        self.use_spares = self.Ps > 0 and inject > 0
        self.spare_ids, self.spare_d = spare_ids, state.get("spare_d")
        # only real spare entries count as remaining work
        self.n_spare = (spare_ids >= 0).sum(1) if self.use_spares else None
        for key in STATE_KEYS:
            setattr(self, key, state[key])
        #: the exact body runs ops/walk_body.py's kernels
        self.fused = eng.fused_body(dev, merge_bins)
        if self.fused:
            # the kernels read row-contiguous state (a seeded beam is a
            # slice of the seeding's sort); visited and expanded are
            # updated in place and must be contiguous already
            for key in ("cand_ids", "cand_d", "no_better", "ptr", "it"):
                setattr(self, key, getattr(self, key).contiguous())
            self.t_limit = t_limit.contiguous()
            if self.use_spares:
                self.spare_ids = spare_ids.contiguous()
                self.spare_d = self.spare_d.contiguous()
        #: `run_all` is one walk_body.walk_resident launch
        self.resident = self.fused and walk_body.resident_walk(
            dev, merge_bins, eng.f32_gather_scoring(self.queries_s), L, B,
            int(eng.graph.shape[1]), inject if self.use_spares else 0,
            eng.n, int(queries.shape[1]))
        if merge_bins:
            # the binned body's constants
            self._arange_L = torch.arange(L, device=dev)
            self._arange_inject = torch.arange(max(inject, 1), device=dev)
            self._zero_col = torch.zeros((Q, 1), dtype=torch.bool,
                                         device=dev)

    def state(self) -> dict:
        """The walk's state, in seed_state's layout."""
        out = {key: getattr(self, key) for key in STATE_KEYS}
        out.update(queries=self.queries, spare_ids=self.spare_ids,
                   spare_d=self.spare_d)
        return out

    def _active(self):
        return walk_body.row_active(self.no_better, self.ptr, self.n_spare,
                                    self.nbp_limit)

    def row_alive(self) -> torch.Tensor:
        """True while the next body could still change the row's pool."""
        has_work = ((~self.expanded[:, :self.L]) & (self.cand_ids >= 0)) \
            .any(1)
        if self.use_spares:
            has_work = has_work | (self.ptr < self.n_spare)
        return self._active() & has_work & (self.it < self.t_limit)

    def body(self, mark=_unmarked) -> None:
        """One walk iteration; `mark` (trace.fine_span in the eager walk)
        marks its phases, and a walk captured into a CUDA graph marks
        none."""
        if self.merge_bins:
            self._binned_body(mark)
            return
        eng = self.eng
        spares = self.n_spare, self.spare_ids, self.spare_d
        if self.fused:
            with mark("walk.pop"):
                sel_ids, fresh_ids, ctl = walk_body.walk_pop_expand(
                    self.cand_ids, self.cand_d, self.expanded, self.visited,
                    self.no_better, self.ptr, self.it, self.t_limit,
                    self.n_spare, eng.graph, self.k_eff, self.B,
                    self.nbp_limit)
            with mark("walk.expand"):
                pass                           # in the pop's launch
            merge = walk_body.walk_merge
        else:
            with mark("walk.pop"):
                sel_ok, sel_ids, ctl = walk_body.pop_reference(
                    self.cand_ids, self.cand_d, self.expanded,
                    self.no_better, self.ptr, self.it, self.t_limit,
                    self.n_spare, self.k_eff, self.B, self.nbp_limit)
            with mark("walk.expand"):
                fresh_ids = walk_body.expand_reference(
                    eng.graph, sel_ok, sel_ids, self.visited)
            merge = walk_body.merge_reference
        with mark("walk.score"):
            nd = self._score(sel_ids, fresh_ids)
        with mark("walk.merge"):
            (self.cand_ids, self.cand_d, self.expanded, self.no_better,
             self.ptr, self.it) = merge(
                self.cand_ids, self.cand_d, self.expanded, nd, fresh_ids,
                ctl, self.no_better, self.ptr, self.it, *spares,
                self.inject, self.nbp_limit)

    def _score(self, sel_ids, fresh_ids) -> torch.Tensor:
        """The fresh candidates' distances (Q, B * m), one launch: the
        slots that are not fresh are -1 and score MAX_DIST."""
        eng = self.eng
        if eng.nbr_vecs is not None:
            # packed neighbours: B block reads of (m, D) per query, in the
            # order of `flat`
            sel_safe = sel_ids.clamp_min(0)
            cvecs = eng.nbr_vecs[sel_safe].reshape(fresh_ids.numel(), -1)
            return walk_ops.walk_distance(self.queries_s, cvecs, eng.metric,
                                          eng.base, walk_ops.ROWS,
                                          idx=fresh_ids,
                                          x_sqnorm=eng.nbr_sq[sel_safe])
        return walk_ops.walk_distance(self.queries_s, eng.score_src,
                                      eng.metric, eng.base, walk_ops.GATHER,
                                      idx=fresh_ids, x_sqnorm=eng.sqnorm,
                                      score_scale=eng.score_scale)

    def _binned_body(self, mark) -> None:
        """The BinnedTopK body: the rank-select pop over the sorted pool,
        the bin shortlist merge and lazy visited marking (beam entrants
        only), as the JAX package's binned body."""
        eng = self.eng
        N = eng.n
        Q = self.queries.shape[0]
        L, B = self.L, self.B
        with mark("walk.pop"):
            # a row past its own budget is frozen exactly like an
            # nbp-tripped one: rows with different budgets share one batch
            active = self._active() & (self.it < self.t_limit)
            # exact rank-select over the sorted pool: the first B eligible
            # positions are the best B
            elig = (~self.expanded[:, :L]) & (self.cand_d < MAX_DIST)
            rank = torch.where(elig, torch.cumsum(elig, dim=1) - 1, B)
            buf = torch.full((elig.shape[0], B + 1), L,
                             device=elig.device)
            buf.scatter_(1, rank.clamp_max(B),
                         self._arange_L.expand_as(rank))
            spos = buf[:, :B]                                # B: dump column
            sel_ok = (spos < L) & active[:, None]
            spos = torch.clamp_max(spos, L - 1)
            sel_d = torch.where(sel_ok, torch.gather(self.cand_d, 1, spos),
                                MAX_DIST)
            best_pop_d = sel_d[:, 0]
            sel_ids = torch.where(sel_ok,
                                  torch.gather(self.cand_ids, 1, spos), -1)
            self.expanded.scatter_(1, torch.where(sel_ok, spos, L), True)
            frontier_worse = best_pop_d > self.cand_d[:, self.k_eff - 1]

        with mark("walk.expand"):
            # ---- gather neighbours, drop the visited ones (marked lazily,
            # at the merge)
            nbrs = eng.graph[sel_ids.clamp_min(0)].to(torch.int64)
            nbrs = torch.where(sel_ok[..., None], nbrs, -1)  # (Q, B, m)
            flat = nbrs.reshape(Q, -1)
            flat_safe = torch.where(flat >= 0, flat, N)
            seen = torch.gather(self.visited, 1, flat_safe)
            fresh = (flat >= 0) & ~seen

        with mark("walk.score"):
            nd = self._score(sel_ids, torch.where(fresh, flat, -1))

        with mark("walk.merge"):
            self._binned_merge(active, best_pop_d, frontier_worse, flat, nd)

    def _binned_merge(self, active, best_pop_d, frontier_worse, flat,
                      nd) -> None:
        """Spare injection, the binned merge of beam and candidates into
        the top L, and the counters: the binned body's last phase."""
        L, N = self.L, self.eng.n
        Q = self.queries.shape[0]
        flat_m = flat
        trigger = None
        if self.use_spares:
            trigger, inj_ids, inj_d, self.ptr = walk_body.spare_injection(
                self.spare_ids, self.spare_d, self.n_spare, self.ptr,
                self.no_better, active, best_pop_d, self.nbp_limit,
                self._arange_inject[:self.inject])
            nd = torch.cat([nd, inj_d], dim=1)
            flat_m = torch.cat([flat, inj_ids], dim=1)

        # ---- merge beam + candidates, keep the top L
        all_d = torch.cat([self.cand_d, nd], dim=1)
        all_ids = torch.cat([self.cand_ids, flat_m], dim=1)
        all_exp = torch.cat(
            [self.expanded[:, :L],
             torch.zeros((Q, all_d.shape[1] - L), dtype=torch.bool,
                         device=all_d.device)], dim=1)
        vals, cols = topk_bins.bin_shortlist(all_d, self.merge_bins)
        sh_ids = torch.gather(all_ids, 1, cols)
        sh_exp = torch.gather(all_exp, 1, cols)
        cand_d, mpos = dist_ops.smallest_k(vals, L)
        cand_ids = torch.gather(sh_ids, 1, mpos)
        cand_ids = torch.where(cand_d < MAX_DIST, cand_ids, -1)
        new_exp = torch.gather(sh_exp, 1, mpos)
        # copies from several parents of one iteration carry equal
        # distances: keep the better-ranked one, void the rest
        safe_ids = torch.where(cand_ids >= 0, cand_ids, N)
        dup = _sorted_dup_mask(safe_ids) & (cand_ids >= 0)
        self.cand_ids = torch.where(dup, -1, cand_ids)
        self.cand_d = torch.where(dup, MAX_DIST, cand_d)
        self.expanded = torch.cat([new_exp | dup, self._zero_col], dim=1)
        # lazy marking: beam entrants only
        self.visited.scatter_(1, safe_ids, True)

        # non-live rows freeze their counter
        nb = torch.where(active,
                         torch.where(frontier_worse, self.no_better + 1, 0),
                         self.no_better)
        if trigger is not None:
            nb = torch.where(trigger, 0, nb)     # a fresh re-seed resets it
        self.no_better = nb
        self.it = self.it + 1

    def run(self, max_iters: int) -> int:
        """At most `max_iters` bodies, ending early once no row is alive;
        returns the bodies run.  Each body's phases are spans while a
        profiler session is live (`trace.fine_span`)."""
        for step in range(max_iters):
            if step % _ALIVE_CHECK == 0:
                # the body's one intended sync: a blessed readback
                with trace.span("walk.alive_check"):
                    alive = bool(recompile_guard.device_get(
                        self.row_alive().any()))
                if not alive:
                    return step
            self.body(trace.fine_span)
        return max_iters

    def run_all(self, iters: int) -> int:
        """`iters` bodies with no host sync: the same pools as `run` (a
        dead row is an absorbing no-op), capturable in a graph, and with
        no spans (a captured walk's replay is one ``walk.replay``); one
        resident launch where `resident` holds."""
        if self.resident:
            eng = self.eng
            spares = ((self.n_spare, self.spare_ids, self.spare_d)
                      if self.use_spares else (None, None, None))
            (self.cand_ids, self.cand_d, self.expanded, self.no_better,
             self.ptr, self.it) = walk_body.walk_resident(
                self.queries_s, eng.score_src, eng.sqnorm, eng.metric,
                eng.base, self.cand_ids, self.cand_d, self.expanded,
                self.visited, self.no_better, self.ptr, self.it,
                self.t_limit, *spares, eng.graph, self.k_eff, self.B,
                self.nbp_limit, self.inject, iters)
            return iters
        for _ in range(iters):
            self.body()
        return iters


def _finalize(eng: "GraphSearchEngine", queries, cand_ids, cand_d,
              k_eff: int, binned_bins: int = 0):
    """Exact float32 re-rank of the pool when the walk scored the bf16
    shadow or the device-tier cascade's int8 rows, tombstone filter and
    final top-k (binned when `binned_bins` > 0).  The host-tier cascade
    finalizes through `_finalize_host` instead."""
    if eng.fp_host is not None:
        return _finalize_host(eng, queries, cand_ids, k_eff)
    if eng.rerank:
        cand_d = walk_ops.walk_distance(queries, eng.data, eng.metric,
                                        eng.base, walk_ops.GATHER,
                                        idx=cand_ids, x_sqnorm=eng.sqnorm)
    dead = eng.deleted[cand_ids.clamp_min(0)] | (cand_ids < 0)
    out_d = torch.where(dead, MAX_DIST, cand_d)
    if binned_bins:
        final_d, fpos = topk_bins.binned_topk(out_d, k_eff, binned_bins)
    else:
        final_d, fpos = dist_ops.smallest_k(out_d, k_eff)
    final_ids = torch.gather(cand_ids, 1, fpos)
    final_ids = torch.where(final_d < MAX_DIST, final_ids, -1)
    return final_d, final_ids.to(torch.int32)


def _finalize_host(eng: "GraphSearchEngine", queries, cand_ids,
                   k_eff: int):
    """Host-tier cascade finalize: the pool's ids read back once, their
    float32 rows and tombstones fetched from host memory, tombstones folded
    into the ids, and the cascade's fp re-rank (ROWS mode)."""
    ids_np = recompile_guard.device_get(cand_ids)
    safe = np.clip(ids_np, 0, eng.fp_host.shape[0] - 1)
    ids_np = np.where(eng._deleted_np[safe], -1, ids_np)
    return cascade_ops.rerank_gathered(
        queries, cascade_ops.fetch_rows(eng.fp_host, safe, queries.device),
        torch.from_numpy(ids_np).to(queries.device), k_eff, int(eng.metric),
        eng.base, walk_ops.ROWS)


class GraphSearchEngine:
    """Device snapshot of {vectors, graph, tombstones, pivots} and the
    walk over it."""

    def __init__(self, data: np.ndarray, graph: np.ndarray,
                 pivot_ids: np.ndarray, deleted: Optional[np.ndarray],
                 metric: DistCalcMethod, base: int,
                 score_dtype: str = "auto",
                 packed_neighbors: bool = False,
                 binned_topk: str = "off",
                 recall_target: float = topk_bins.DEFAULT_RECALL_TARGET,
                 cascade_search: bool = False,
                 corpus_tier: str = "device",
                 device: DeviceLike = None,
                 device_sample_rate: float = 0.0,
                 roofline_probe: bool = False,
                 quantized: Optional[Tuple[np.ndarray, float]] = None,
                 kd_forest: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        """`quantized` (int8 rows, scale): the cascade's quantization when
        the caller made it over a larger corpus (a mesh quantizes all its
        shards with one scale, parallel/sharded.py); None quantizes
        `data`.  `kd_forest` (KDTNode records, tree starts): a KDT index's
        forest, put on the device beside the rows and the graph, from
        which a search given ``kd_backtrack`` seeds its walk."""
        n = data.shape[0]
        assert graph.shape[0] == n, (graph.shape, n)
        self.device = resolve_device(device)
        self.n = n
        self.metric = DistCalcMethod(metric)
        self.base = int(base)
        self.binned_mode = topk_bins.normalize_mode(binned_topk)
        self.recall_target = topk_bins.validate_recall_target(recall_target)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # the cascade (integer corpora ignore it: already quantized)
        self.cascade = bool(cascade_search) and np.issubdtype(
            np.asarray(data).dtype, np.floating)
        self.corpus_tier = (cascade_ops.normalize_tier(corpus_tier)
                            if self.cascade else "device")
        if self.corpus_tier == "host_all":
            self.corpus_tier = "host"   # a graph engine has no sketch tier
        #: dequantization scale of the in-loop int8 scoring (0: off)
        self.score_scale = 0.0
        #: the host tier's float32 rows and tombstones
        self.fp_host: Optional[np.ndarray] = None
        self._deleted_np: Optional[np.ndarray] = None
        int8_np = None
        if self.cascade:
            int8_np, scale = (quantized if quantized is not None else
                              cascade_ops.quantize_int8(
                                  np.asarray(data, np.float32)))
            self.score_scale = cascade_ops.walk_score_scale(True, np.int8,
                                                            scale)
            # packed neighbours would copy the corpus in the scoring dtype
            packed_neighbors = False
        if self.corpus_tier == "host":
            # the int8 rows are the device corpus; float32 stays host-side
            self.data = put(int8_np)
            self.fp_host = np.ascontiguousarray(np.asarray(data, np.float32))
            self._deleted_np = np.ascontiguousarray(
                np.zeros(n, bool) if deleted is None
                else np.asarray(deleted[:n], bool))
        else:
            self.data = put(data)
        # the device-tier cascade takes the kernels' own norm function, the
        # bits the host tier's re-rank computes from fetched rows
        self.sqnorm = (walk_ops.row_sqnorms(self.data)
                       if self.corpus_tier == "device" and self.cascade
                       else dist_ops.row_sqnorms(self.data))
        if self.fp_host is not None:
            # int8 norms into the dequantized space of the walk's scoring
            self.sqnorm = self.sqnorm * cascade_ops.f32(
                self.score_scale * self.score_scale)
        if self.cascade and self.corpus_tier == "device":
            # the int8 quantization replaces the bf16 shadow
            self.data_score = put(int8_np)
        else:
            # the bf16 shadow of a float32 corpus ("auto" is float32 here,
            # as the JAX package resolves it off the TPU); integer corpora
            # ignore the option
            self.data_score = (self.data.to(torch.bfloat16)
                               if score_dtype == "bf16"
                               and self.data.dtype == torch.float32
                               else None)
        self.score_src = (self.data_score if self.data_score is not None
                          else self.data)
        #: finalize re-ranks the pool against the float32 rows
        self.rerank = self.data_score is not None
        self.graph = put(graph.astype(np.int32, copy=False))
        self.deleted = put(np.zeros(n, bool) if deleted is None
                           else np.asarray(deleted[:n], bool))
        pivot_ids = np.asarray(pivot_ids, np.int64)
        if len(pivot_ids) == 0:
            pivot_ids = np.zeros(1, np.int64)
        self.pivot_ids = put(pivot_ids)
        # a mesh shard pads its pivot list with -1 (parallel/sharded.py):
        # those score row 0, as the JAX mesh's padded pivot vectors do
        self.pivot_vecs = self.data[self.pivot_ids.clamp_min(0)]
        if self.fp_host is not None:
            # seed distances in the walk's dequantized space
            self.pivot_vecs = walk_ops.dequantize(self.pivot_vecs,
                                                  self.score_scale)
        # computed once a snapshot (a swap, a compaction or a load builds a
        # new engine): seeding reads them every walk
        self.pivot_sqnorm = walk_ops.row_sqnorms(self.pivot_vecs)
        #: the kd forest on the device: (M, 4) int32 node words, (trees,)
        #: int32 roots, its depth, and the (1,) int64 count of node
        #: records its descents read (``search.kd_node_reads``)
        self.kd_nodes = self.kd_starts = self.kd_reads = None
        self.kd_depth = 0
        if kd_forest is not None:
            words = kd_descent.forest_words(kd_forest[0])
            starts = np.asarray(kd_forest[1], np.int32)
            self.kd_nodes, self.kd_starts = put(words), put(starts)
            self.kd_depth = kd_descent.forest_depth(words, starts)
            self.kd_reads = torch.zeros(1, dtype=torch.int64,
                                        device=self.device)
            kd_reads = self.kd_reads
            # read when the registry is: no sync of its own a search
            metrics.register_source(
                "search.kd_node_reads", self,
                lambda: int(recompile_guard.device_get(kd_reads)[0]))
        # packed neighbours in the scoring dtype; a -1 slot points at row 0
        self.nbr_vecs = self.nbr_sq = None
        if packed_neighbors:
            g = self.graph.clamp_min(0).to(torch.int64)
            self.nbr_vecs = self.score_src[g]
            self.nbr_sq = self.sqnorm[g]
        #: walk iterations the last search ran, summed over its chunks (a
        #: replayed graph runs all T: a finished row is a no-op there; a
        #: segmented search counts S per segment)
        self.last_iterations = 0
        #: of those, the iterations that ran the exact body's kernels
        self.last_fused_iterations = 0
        #: of those, the iterations that ran as one resident launch
        self.last_resident_iterations = 0
        # CUDA graphs of small-chunk walks, by (shapes, plan), oldest first
        self._graphs = collections.OrderedDict()
        self._graph_lock = threading.Lock()
        self._graph_seen = set()        # keys asked for once
        # FlightDeviceSampleRate: the fraction of segment dispatches whose
        # device time is read (CUDA events around the dispatch or the
        # graph replay) and turned into the roofline gauges
        self.device_sample_rate = max(0.0, float(device_sample_rate))
        self._seg_dispatches = 0
        try:
            self._capability = roofline.capability(
                probe=bool(roofline_probe))
        except Exception:                               # noqa: BLE001
            self._capability = None
        # device-memory ledger: every resident tensor of this snapshot,
        # owned by the engine (a swap retires the entry when the
        # superseded engine is collected)
        self.register_devmem()

    def register_devmem(self) -> None:
        """(Re-)register this snapshot's resident bytes with the memory
        ledger, under the JAX package's components (the bf16 shadow rides
        in ``corpus``, the pivots in ``tree``); called at construction and
        when DeviceBytesLedger is re-enabled on a warm index.  The walk's
        captured CUDA graphs own private pools no component names: they
        show in `devmem.snapshot`'s untracked bytes."""
        parts = self.device_bytes()
        card = str(self.device)

        def on_card(nbytes):
            return {card: nbytes}
        if self.fp_host is not None:
            # host tier: the int8 rows are the device corpus; the float32
            # rows are host memory, excluded from the device total
            devmem.track("int8_blocks", self, parts["corpus"],
                         cards=on_card(parts["corpus"]))
            devmem.track("host_corpus", self, self.fp_host.nbytes,
                         host=True)
        else:
            corpus = (parts["corpus"] + parts.get("bf16_shadow", 0)
                      + parts.get("int8_shadow", 0))
            devmem.track("corpus", self, corpus, cards=on_card(corpus))
        devmem.track("graph", self, parts["graph"],
                     cards=on_card(parts["graph"]))
        tree = parts["pivots"] + parts.get("kd_forest", 0)
        devmem.track("tree", self, tree, cards=on_card(tree))
        if "packed_neighbors" in parts:
            devmem.track("packed_neighbors", self,
                         parts["packed_neighbors"],
                         cards=on_card(parts["packed_neighbors"]))

    def set_deleted(self, deleted: np.ndarray) -> None:
        """Swap only the tombstone mask (a delete-only change).  On the
        card the mask is copied in place: captured graphs read it there."""
        mask = torch.from_numpy(np.ascontiguousarray(deleted[:self.n], bool))
        if self.fp_host is not None:
            self._deleted_np = mask.numpy().copy()
        if self.device.type == "cuda":
            self.deleted.copy_(mask)
        else:
            self.deleted = mask

    def device_bytes(self) -> Dict[str, int]:
        """Bytes of the snapshot's resident tensors, by part."""
        out = {"corpus": self.data.nbytes + self.sqnorm.nbytes
               + self.deleted.nbytes,
               "graph": self.graph.nbytes,
               "pivots": self.pivot_ids.nbytes + self.pivot_vecs.nbytes
               + self.pivot_sqnorm.nbytes}
        if self.data_score is not None:
            out["int8_shadow" if self.cascade else "bf16_shadow"] = \
                self.data_score.nbytes
        if self.nbr_vecs is not None:
            out["packed_neighbors"] = (self.nbr_vecs.nbytes
                                       + self.nbr_sq.nbytes)
        if self.kd_nodes is not None:
            out["kd_forest"] = (self.kd_nodes.nbytes + self.kd_starts.nbytes
                                + self.kd_reads.nbytes)
        return out

    def exact_scan(self, queries: np.ndarray, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over this snapshot's corpus (the FLAT scan on the
        resident arrays): the oracle of `exact_search_batch`.  A host-tier
        cascade streams its host rows through the card in blocks."""
        if self.fp_host is not None:
            return cascade_ops.host_exact_scan(
                self.fp_host, self._deleted_np, queries, min(k, self.n),
                int(self.metric), self.base, device=self.device)
        return exact_device_scan(self.data, self.sqnorm, self.deleted,
                                 queries, k, int(self.metric), self.base)

    # ---- walk configuration -------------------------------------------------

    def walk_plan(self, k: int, max_check: int, beam_width: int = 16,
                  pool_size: Optional[int] = None, nbp_limit: int = 3
                  ) -> Tuple[int, int, int, int, int]:
        """(k_eff, L, B, T, limit): pool size, pops per iteration,
        iterations, and the no-better-propagation limit (maxCheck/64 pops
        in SPTAG, B pops per iteration here).  The slot scheduler keys its
        pools on all but T, which rides per row as `t_limit`."""
        k_eff = min(k, self.n)
        L = beam_pool_size(k_eff, max_check, self.n, pool_size)
        B = beam_width_for(beam_width, max_check, L)
        T = max(1, -(-max_check // B))
        limit = max(nbp_limit, (max_check // 64) // B, 1)
        return k_eff, L, B, T, limit

    def chunk_size(self) -> int:
        """Queries per chunk: the JAX package's packed-bitset budget
        (N/8 bytes a query), at most 1,024."""
        return max(1, min(_VISITED_BUDGET // max(self.n // 8, 1), 1024))

    def merge_bins_for(self, L: int, B: int) -> int:
        """Bin count of the binned frontier merge at pool size L (0 =
        exact), by the shared rule topk_bins.walk_merge_bins."""
        return topk_bins.walk_merge_bins(
            self.binned_mode, L, L + B * int(self.graph.shape[1]))

    @staticmethod
    def fused_body(device, merge_bins: int) -> bool:
        """Whether a walk on `device` runs the exact body's kernels
        (ops/walk_body.py): on the card and not binned."""
        return torch.device(device).type == "cuda" and not merge_bins

    def f32_gather_scoring(self, queries: torch.Tensor) -> bool:
        """Whether the walk scores float32 `queries` against the float32
        corpus by gather (what the resident kernel scores): no packed
        neighbours, no bf16 shadow, no int8 cascade, float cosine at base
        1."""
        return (queries.dtype == torch.float32
                and self.score_src.dtype == torch.float32
                and self.nbr_vecs is None and not self.score_scale
                and (self.metric != DistCalcMethod.Cosine
                     or self.base == 1))

    def seed_keep_for(self, L: int) -> int:
        """Spare-queue depth of the binned seeding (0 = exact seeding)."""
        return topk_bins.seed_spare_keep(
            self.binned_mode, L, max(int(self.pivot_ids.shape[0]), L))

    def finalize_bins_for(self, k_eff: int, L: int) -> int:
        """Bin count of the finalize top-k over the L-wide pool (0 =
        exact), by the recall-target rule."""
        if self.binned_mode == "off":
            return 0
        return topk_bins.resolve_bins(self.binned_mode, k_eff, L,
                                      self.recall_target)

    # ---- the walk as state: seed, segment, finalize -------------------------

    def seed_state(self, queries: torch.Tensor, L: int,
                   seeds: Optional[torch.Tensor] = None) -> dict:
        """A fresh walk state for the (Q, D) device `queries` (with
        (Q, S) int64 `seeds`, -1 padded, the per-query seeding): the
        loop-carried tensors, the spare queue (None when seeded) and the
        queries.  The slot scheduler inserts, compacts and blanks its rows
        between segments; `run_segment` advances it."""
        if seeds is None:
            cand_ids, cand_d, visited, spare_ids, spare_d = \
                _seed_from_pivots(self.pivot_ids, self.pivot_vecs,
                                  self.pivot_sqnorm, queries, L,
                                  int(self.metric), self.n,
                                  seed_keep=self.seed_keep_for(L))
            return _init_state(queries, cand_ids, cand_d, visited,
                               spare_ids, spare_d)
        cand_ids, cand_d, visited = _seed_from_seeds(
            self.data, self.sqnorm, seeds, queries, L, int(self.metric),
            self.base, self.score_scale)
        return _init_state(queries, cand_ids, cand_d, visited)

    def kd_seeds(self, queries: torch.Tensor, backtrack: int
                 ) -> torch.Tensor:
        """The (Q, trees * (1 + backtrack)) int64 seeds of the (Q, D)
        device `queries` from this snapshot's kd forest, on its device
        (ops/kd_descent.py); the node records read add into `kd_reads`."""
        return kd_descent.kd_seeds(queries, self.kd_nodes, self.kd_starts,
                                   backtrack, depth=self.kd_depth,
                                   reads=self.kd_reads)

    def run_segment(self, state: dict, t_limit: torch.Tensor, k_eff: int,
                    L: int, B: int, nbp_limit: int, S: int,
                    inject: int = 0, check_alive: bool = True
                    ) -> Tuple[dict, torch.Tensor]:
        """Advance every row of `state` by at most S walk iterations (all
        S, with no host sync, when `check_alive` is False: what a captured
        graph runs); returns (new state, (Q,) alive).  A row with alive
        False is done (absorbing): its pool is final and `finalize` may
        retire it.  `visited` and `expanded` of `state` are updated in
        place."""
        walk = _Walk(self, state, t_limit, k_eff, L, B, nbp_limit,
                     inject if state.get("spare_ids") is not None else 0,
                     self.merge_bins_for(L, B))
        timer = self.segment_timer() if check_alive else None
        if check_alive:
            walk.run(S)
        else:
            walk.run_all(S)
        alive = walk.row_alive()
        if timer is not None:
            self.publish_segment_sample(int(state["queries"].shape[0]), B,
                                        L, S, timer())
        return walk.state(), alive

    # ---- roofline attribution -----------------------------------------------

    def score_itemsize(self) -> int:
        """Bytes per element of the in-loop scoring corpus: the ledger's
        byte scale."""
        return int(self.score_src.element_size())

    def score_dtype_name(self) -> str:
        """Peak-selection dtype for the roofline, the JAX package's rule:
        a scoring shadow reads as bf16, an integer corpus as int8."""
        if self.data_score is not None:
            return "bf16"
        return "f32" if self.data.dtype.is_floating_point else "int8"

    def walk_iter_cost(self, rows: int, B: int, L: int = 0):
        """Ledger estimate of ONE walk-body iteration at batch `rows` (the
        ``beam.segment`` unit), shared by the sampled roofline gauges and
        the scheduler's per-query attribution.  `L` prices the binned body
        when the engine runs BinnedTopK."""
        return costmodel.estimate(
            "beam.segment", Q=rows, X=B * self.graph.shape[1],
            D=self.data.shape[1], W=_num_words(self.n),
            score_itemsize=self.score_itemsize(),
            merge_bins=self.merge_bins_for(L, B) if L else 0, L=L,
            N=self.n, score_scale=self.score_scale)

    def segment_timer(self):
        """None unless this segment dispatch is sampled
        (FlightDeviceSampleRate); else a callable that returns the
        nanoseconds since the call, read between CUDA events on the card
        (waiting for the end event: the sampled dispatch's one sync) and
        on the host clock on the CPU."""
        if self.device_sample_rate <= 0:
            return None
        self._seg_dispatches += 1
        every = (1 if self.device_sample_rate >= 1.0
                 else max(1, int(round(1.0 / self.device_sample_rate))))
        if self._seg_dispatches % every:
            return None
        if self.device.type == "cuda":
            # both events on this card's stream, whatever card is current
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))

            def elapsed_ns() -> int:
                end.record(torch.cuda.current_stream(self.device))
                end.synchronize()
                return int(start.elapsed_time(end) * 1e6)
            return elapsed_ns
        t0 = time.monotonic_ns()
        return lambda: time.monotonic_ns() - t0

    def publish_segment_sample(self, rows: int, B: int, L: int, S: int,
                               dev_ns: int) -> None:
        """The roofline gauges of one sampled segment: the ledger's work
        of S iterations at `rows` over the sampled device time.  S is the
        segment's iteration cap, so near a drain tail the estimate bounds
        the work from above."""
        metrics.observe("engine.segment_device_ns", dev_ns)
        est = self.walk_iter_cost(rows, B, L)
        flops = est.flops * S
        nbytes = est.hbm_bytes * S
        dev_s = max(dev_ns, 1) / 1e9
        metrics.set_gauge("engine.achieved_gflops", flops / dev_s / 1e9)
        metrics.set_gauge("engine.achieved_gbps", nbytes / dev_s / 1e9)
        pct = (self._capability.pct_of_peak(
            flops / dev_s, nbytes / dev_s, self.score_dtype_name())
            if self._capability is not None else None)
        if pct is not None:
            metrics.set_gauge("engine.roofline_pct_peak", pct)
        flightrec.record("engine", "segment_device", dur_ns=dev_ns,
                         payload={"rows": rows, "iters": S,
                                  "flops": int(flops),
                                  "bytes": int(nbytes)})

    def finalize(self, state: dict, k_eff: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Re-rank, tombstone filter and top-k over the state's pools, the
        monolithic walk's epilogue: ((Q, k') dists, (Q, k') int32 ids)."""
        return recompile_guard.device_get(self._finalize_state(state,
                                                               k_eff))

    def _finalize_state(self, state: dict, k_eff: int):
        return _finalize(self, state["queries"], state["cand_ids"],
                         state["cand_d"], k_eff, self.finalize_bins_for(
                             k_eff, int(state["cand_ids"].shape[1])))

    def capture_segment(self, state: dict, t_limit: torch.Tensor,
                        k_eff: int, L: int, B: int, nbp_limit: int, S: int,
                        inject: int = 0):
        """A CUDA graph of one S-iteration segment (the slot scheduler's,
        algo/scheduler.py) over static copies of `state` and `t_limit` on
        this engine's card: (graph, state buffers, t_limit buffer, alive
        output), the new state written back into the same buffers; None
        while a profile runs."""
        bufs = {name: arr.clone() for name, arr in state.items()
                if arr is not None}
        t_in = t_limit.clone()

        def segment():
            st = {name: bufs.get(name) for name in state}
            new, alive = self.run_segment(st, t_in, k_eff, L, B, nbp_limit,
                                          S, inject=inject,
                                          check_alive=False)
            for name in STATE_KEYS:
                if new[name] is not bufs[name]:
                    bufs[name].copy_(new[name])
            return alive

        graph, alive_out = capture_on(self.device, segment)
        if graph is None:
            return None
        _note_graph(self.device, "segment_captures")
        return (DeviceGraph(graph, self.device, "segment_replays"), bufs,
                t_in, alive_out)

    @property
    def index_device(self) -> torch.device:
        """Where the slot scheduler builds its row indices."""
        return self.device

    def _search_segmented(self, queries: np.ndarray,
                          seeds: Optional[np.ndarray], k_eff: int, L: int,
                          B: int, T: int, limit: int, inject: int,
                          chunk: int, S: int, kd_backtrack: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """search() as repeated segments of at most S iterations
        (BeamSegmentIters), the results of the monolithic walk bit for
        bit.  Chunks pad to `utils.query_bucket` with zero rows whose
        `t_limit` is 0: never alive, bit-frozen no-ops.  `kd_backtrack` > 0
        (with `seeds` None) seeds each chunk from the kd forest."""
        nq, D = queries.shape
        out_d = torch.zeros((nq, k_eff), dtype=torch.float32,
                            device=self.device)
        out_i = torch.zeros((nq, k_eff), dtype=torch.int32,
                            device=self.device)
        self.last_iterations = self.last_fused_iterations = 0
        self.last_resident_iterations = 0
        fused = self.fused_body(self.device, self.merge_bins_for(L, B))
        for start in range(0, nq, chunk):
            q = queries[start:start + chunk]
            nqc = q.shape[0]
            q_pad = query_bucket(nqc, chunk)
            if q_pad != nqc:
                q = np.concatenate([q, np.zeros((q_pad - nqc, D), q.dtype)])
            with trace.span("walk.upload"):
                s = None
                if seeds is not None:
                    s = np.asarray(seeds[start:start + nqc], np.int64)
                    if q_pad != nqc:
                        s = np.concatenate(
                            [s, np.full((q_pad - nqc, s.shape[1]), -1,
                                        np.int64)])
                    s = torch.from_numpy(s).to(self.device)
                qd = torch.from_numpy(np.ascontiguousarray(q)).to(
                    self.device)
            if kd_backtrack:
                with trace.span("walk.kd_seeds"):
                    s = self.kd_seeds(qd, kd_backtrack)
            with trace.span("walk.seed"):
                state = self.seed_state(qd, L, seeds=s)
                t_limit = torch.zeros(q_pad, dtype=torch.int64,
                                      device=self.device)
                t_limit[:nqc] = T
            with trace.span("walk.iterate"):
                while True:
                    state, alive = self.run_segment(state, t_limit, k_eff,
                                                    L, B, limit, S,
                                                    inject=inject)
                    self._count_iterations(S, fused)
                    # the segment loop's continue flag: its intended sync
                    with trace.span("walk.alive_check"):
                        any_alive = bool(recompile_guard.device_get(
                            alive.any()))
                    if not any_alive:
                        break
            with trace.span("walk.finalize"):
                d, ids = self._finalize_state(state, k_eff)
            out_d[start:start + nqc] = d[:nqc]
            out_i[start:start + nqc] = ids[:nqc]
        return out_d, out_i

    # ---- search -------------------------------------------------------------

    def _count_iterations(self, n: int, fused: bool,
                          resident: bool = False) -> None:
        self.last_iterations += n
        if fused:
            self.last_fused_iterations += n
        if resident:
            self.last_resident_iterations += n

    def _walk_chunk(self, queries, seeds, plan, check_alive: bool = True,
                    kd_backtrack: int = 0):
        """Seed, walk and finalize one chunk on the device: ((Q, k') dists,
        (Q, k') int32 ids, iterations run, whether they ran as one
        resident launch).  `seeds` is None or a (Q, S) int64 tensor; with
        None, `kd_backtrack` > 0 descends the kd forest for them first.
        The eager walk's stages are spans; a walk being captured
        (`check_alive` False) records none."""
        mark = trace.span if check_alive else _unmarked
        k_eff, L, B, T, limit, inject, mb, fb, sk = plan
        if seeds is None and kd_backtrack:
            with mark("walk.kd_seeds"):
                seeds = self.kd_seeds(queries, kd_backtrack)
        with mark("walk.seed"):
            state = self.seed_state(queries, L, seeds)
            t_limit = torch.full((queries.shape[0],), T, dtype=torch.int64,
                                 device=queries.device)
            walk = _Walk(self, state, t_limit, k_eff, L, B, limit,
                         inject if seeds is None else 0, mb)
        with mark("walk.iterate"):
            its = walk.run(T) if check_alive else walk.run_all(T)
        with mark("walk.finalize"):
            d, ids = _finalize(self, queries, walk.cand_ids, walk.cand_d,
                               min(k_eff, L), binned_bins=fb)
        return d, ids, its, walk.resident and not check_alive

    def _search_chunk(self, q: np.ndarray, seeds: Optional[np.ndarray],
                      *plan, kd_backtrack: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk's ((Q, k') dists, (Q, k') int32 ids), on the card."""
        with trace.span("walk.upload"):
            queries = torch.from_numpy(np.ascontiguousarray(q)).to(
                self.device)
            s = None if seeds is None else \
                torch.from_numpy(np.asarray(seeds, np.int64)).to(self.device)
        if self.device.type == "cuda" and q.shape[0] <= _GRAPH_MAX_Q:
            out = self._replay_chunk(queries, s, plan, kd_backtrack)
            if out is not None:
                return out
        d, ids, its, _ = self._walk_chunk(queries, s, plan,
                                          kd_backtrack=kd_backtrack)
        self._count_iterations(its, self.fused_body(self.device, plan[6]))
        return d, ids

    def _replay_chunk(self, queries, seeds, plan, kd_backtrack: int = 0
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """A small chunk on the card replays a CUDA graph of the whole
        walk — seeding, all T iterations, finalize — captured per (padded
        shape, plan) on this snapshot: one launch instead of ~150 small
        ones (three a body: pop and expand, scoring, merge; ~3,100 before
        the body's glue became ops/walk_body.py's kernels), which bound
        such searches (phase 9 of chip_smoke.py).  The
        chunk is padded to its bucket with copies of its first row (rows
        walk independently).  A key is captured the second time it is
        asked for (None the first time: the caller walks eagerly), so a
        snapshot searched once, as an add's linking walk is, pays no
        capture; at most `_GRAPH_CACHE` graphs are kept.  The graph reads
        the snapshot's tensors in place (set_deleted copies into them);
        its inputs and outputs are static buffers, so one replay at a time
        uses them."""
        nq, dim = queries.shape
        size = next(b for b in _GRAPH_BUCKETS + (nq,) if b >= nq)
        key = ((size, dim), queries.dtype,
               None if seeds is None else (size, seeds.shape[1]), plan,
               kd_backtrack)
        with self._graph_lock:
            entry = self._graphs.get(key)
            if entry is None and key not in self._graph_seen:
                if len(self._graph_seen) >= 4 * _GRAPH_CACHE:
                    self._graph_seen.clear()
                self._graph_seen.add(key)
                return None
        if size > nq:
            queries = torch.cat([queries, queries[:1].expand(size - nq, -1)])
            if seeds is not None:
                seeds = torch.cat([seeds, seeds[:1].expand(size - nq, -1)])
        with self._graph_lock:
            entry = self._graphs.get(key)
            if entry is None:
                t0 = time.perf_counter()
                entry = self._capture(queries, seeds, plan, kd_backtrack)
                if entry is None:
                    return None
                # a capture is the port's compile (recompile_guard)
                recompile_guard.note_compile(recompile_guard.CAPTURE,
                                             time.perf_counter() - t0)
                self._graphs[key] = entry
                while len(self._graphs) > _GRAPH_CACHE:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
        graph, q_in, s_in, d_out, i_out, lock, resident = entry
        with trace.span("walk.replay"), lock, \
                torch.cuda.device(self.device):
            q_in.copy_(queries)
            if s_in is not None:
                s_in.copy_(seeds)
            with capture_lock:       # not while the profiler starts / stops
                graph.replay()
            self._count_iterations(plan[3],
                                   self.fused_body(self.device, plan[6]),
                                   resident)
            # the static outputs are the next replay's: copies leave with
            # the caller
            return d_out[:nq].clone(), i_out[:nq].clone()

    def _capture(self, queries, seeds, plan, kd_backtrack: int = 0):
        """The graph and its static buffers, or None while a profile runs
        (the caller walks eagerly; the key is captured on a later call).
        With `kd_backtrack` > 0 the kd descent is the graph's first
        kernel."""
        if trace.tracing():
            return None
        q_in = queries.clone()
        s_in = None if seeds is None else seeds.clone()
        graph, out = capture_on(self.device, lambda: self._walk_chunk(
            q_in, s_in, plan, check_alive=False,
            kd_backtrack=kd_backtrack))
        if graph is None:
            return None
        _note_graph(self.device, "walk_captures")
        d_out, i_out, _, resident = out
        return (DeviceGraph(graph, self.device, "walk_replays"), q_in, s_in,
                d_out, i_out, threading.Lock(), resident)

    def search(self, queries: np.ndarray, k: int, max_check: int = 2048,
               beam_width: int = 16, pool_size: Optional[int] = None,
               nbp_limit: int = 3, seeds: Optional[np.ndarray] = None,
               dynamic_pivots: int = 4,
               segment_iters: Optional[int] = None,
               kd_backtrack: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Batched search -> ((Q, k) dists, (Q, k) int32 ids), ascending,
        -1 / MAX_DIST padded.  `dynamic_pivots` spare pivots are injected
        per mid-walk re-seed (NumberOfOtherDynamicPivots; 0 disables).
        `seeds` (Q, S), -1 padded, replaces the shared pivot seeding with
        per-query seed ids (KDT); so does `kd_backtrack` > 0 on an engine
        made with its kd forest, the seeds then descended on the engine's
        device with that many other branches a tree.  `segment_iters` > 0
        runs the walk as segments of that many iterations (state kept
        between them), with the same results bit for bit."""
        return recompile_guard.device_get(self.search_tensors(
            queries, k, max_check, beam_width, pool_size, nbp_limit, seeds,
            dynamic_pivots, segment_iters, kd_backtrack))

    def search_tensors(self, queries: np.ndarray, k: int,
                       max_check: int = 2048, beam_width: int = 16,
                       pool_size: Optional[int] = None, nbp_limit: int = 3,
                       seeds: Optional[np.ndarray] = None,
                       dynamic_pivots: int = 4,
                       segment_iters: Optional[int] = None,
                       kd_backtrack: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`search` without the readback: the (Q, k) float32 distances and
        int32 ids as tensors on this engine's card (a mesh merges its
        shards' there, parallel/sharded.py)."""
        kd = int(kd_backtrack) if seeds is None else 0
        if kd and self.kd_nodes is None:
            raise ValueError("kd_backtrack: this engine was made without "
                             "a kd forest")
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq = queries.shape[0]
        k_eff, L, B, T, limit = self.walk_plan(k, max_check, beam_width,
                                               pool_size, nbp_limit)
        chunk = self.chunk_size()
        out_d = torch.full((nq, k), float(MAX_DIST), dtype=torch.float32,
                           device=self.device)
        out_i = torch.full((nq, k), -1, dtype=torch.int32,
                           device=self.device)
        if self.fp_host is not None and not segment_iters:
            # the host tier's finalize reads the pool back: one segment of
            # the whole budget (the same walk)
            segment_iters = T
        # the trace sentinel's hot section (utils/recompile_guard.py): the
        # walk's readbacks are blessed, any other sync is a violation, and
        # a whole-walk graph's capture is charged to "engine.walk"
        with recompile_guard.hot_section("engine.walk"):
            if segment_iters:
                d, ids = self._search_segmented(
                    queries, seeds, k_eff, L, B, T, limit, dynamic_pivots,
                    chunk, int(segment_iters), kd_backtrack=kd)
                out_d[:, :k_eff] = d
                out_i[:, :k_eff] = ids
                return out_d, out_i
            plan = (k_eff, L, B, T, limit, dynamic_pivots,
                    self.merge_bins_for(L, B),
                    self.finalize_bins_for(k_eff, L), self.seed_keep_for(L))
            self.last_iterations = self.last_fused_iterations = 0
            self.last_resident_iterations = 0
            for lo in range(0, nq, chunk):
                s = None if seeds is None else seeds[lo:lo + chunk]
                d, ids = self._search_chunk(queries[lo:lo + chunk], s,
                                            *plan, kd_backtrack=kd)
                out_d[lo:lo + chunk, :d.shape[1]] = d
                out_i[lo:lo + chunk, :ids.shape[1]] = ids
        return out_d, out_i


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py; the JAX package's formulas).
# The walk formulas follow the count-body-once rule: ``beam.segment`` is ONE
# iteration of the body; runtime consumers scale by their iteration counts.
# The JAX package compiles a program per entry point; the port's walk is
# Python over the same body, so one function stands for several families:
# `GraphSearchEngine._walk_chunk` is the whole walk of one chunk (seeded by
# pivots or per-query seeds: ``beam.walk`` / ``beam.walk_seeded``; on the
# card a chunk of at most _GRAPH_MAX_Q queries replays it as one CUDA
# graph), and `GraphSearchEngine.search` loops it over chunks
# (``beam.walk_chunked`` / ``beam.walk_seeded_chunked``).
# ---------------------------------------------------------------------------

def _walk_iter_cost(Q, X, D, W, score_itemsize=4, merge_bins=0, L=0, N=0,
                    score_scale=0, **_):
    """One walk-body iteration at batch Q: the B*m = X candidate gather +
    scoring contraction dominates; the WALK_SORT_* constants carry the
    argsort/segmented-scan/top-k ensemble (fitted in the JAX package
    against its compiler's cost analysis).

    `merge_bins` > 0 prices the BINNED body instead: the X-wide sort
    ensemble is gone — what remains is the (L + X)-wide bin reduction +
    shortlist top-L (WALK_BINNED_* constants, per merged-row element)
    and the L-wide lazy-mark sort ensemble (the WALK_SORT_* constants at
    width L)."""
    # int8 cascade scoring (score_scale > 0): the dequantize cast +
    # multiply is another 2·Q·X·D elementwise ops, and the dequantized
    # f32 copy doubles the post-gather traffic words
    deq_f = 2.0 * Q * X * D if score_scale else 0.0
    deq_b = Q * X * D * 4.0 if score_scale else 0.0
    if merge_bins:
        wall = X + max(L, 1)
        flops = (2.0 * Q * X * D + deq_f
                 + costmodel.WALK_BINNED_FLOPS * Q * wall
                 + costmodel.WALK_SORT_FLOPS * Q * max(L, 1))
        nbytes = (2.0 * Q * X * D * score_itemsize + deq_b
                  + N * D * score_itemsize       # corpus gather operand
                  + costmodel.WALK_BINNED_TRAFFIC * Q * wall * 4
                  + costmodel.WALK_SORT_TRAFFIC * Q * max(L, 1) * 4
                  + 2.0 * Q * W * 4)
        return flops, nbytes
    flops = 2.0 * Q * X * D + deq_f + costmodel.WALK_SORT_FLOPS * Q * X
    nbytes = (2.0 * Q * X * D * score_itemsize + deq_b
              + costmodel.WALK_SORT_TRAFFIC * Q * X * 4
              + 2.0 * Q * W * 4)
    return flops, nbytes


def _seed_pivot_cost(Q, P, D, L, W, **_):
    flops = (costmodel.matmul_flops(Q, P, D) + 32.0 * Q * P
             + 2.0 * D * (Q + P))
    nbytes = (P * D * 4 + Q * D * 4 + 8.0 * Q * P * 4 + Q * W * 4
              + Q * L * 8)
    return flops, nbytes


def _seed_seeded_cost(Q, S, D, N, L, W, itemsize=4, **_):
    flops = 2.0 * Q * S * D + 64.0 * Q * S + 2.0 * D * Q
    nbytes = (2.0 * Q * S * D * itemsize + N * D * itemsize
              + 16.0 * Q * S * 4 + Q * W * 4 + Q * L * 8)
    return flops, nbytes


def _finalize_cost(Q, L, D, N, rerank=True, itemsize=4, **_):
    flops = (2.0 * Q * L * D if rerank else 0.0) + 4.0 * Q * L
    nbytes = ((2.0 * Q * L * D * itemsize + N * D * itemsize) * rerank
              + 6.0 * Q * L * 4 + N)
    return flops, nbytes


def _segment_cost(Q, X, D, W, score_itemsize=4, merge_bins=0, L=0, N=0,
                  score_scale=0, **_):
    return _walk_iter_cost(Q, X, D, W, score_itemsize,
                           merge_bins=merge_bins, L=L, N=N,
                           score_scale=score_scale)


def _walk_full_cost(Q, P, X, D, L, W, N, score_itemsize=4, merge_bins=0,
                    **_):
    """Monolithic seed + walk + finalize, body counted once."""
    fs, bs = _seed_pivot_cost(Q, P, D, L, W)
    fi, bi = _walk_iter_cost(Q, X, D, W, score_itemsize,
                             merge_bins=merge_bins, L=L, N=N)
    ff, bf = _finalize_cost(Q, L, D, N, rerank=False)
    return fs + fi + ff, bs + bi + bf


def _walk_seeded_cost(Q, S, X, D, L, W, N, score_itemsize=4, itemsize=4,
                      merge_bins=0, **_):
    fs, bs = _seed_seeded_cost(Q, S, D, N, L, W, itemsize)
    fi, bi = _walk_iter_cost(Q, X, D, W, score_itemsize,
                             merge_bins=merge_bins, L=L, N=N)
    ff, bf = _finalize_cost(Q, L, D, N, rerank=False)
    return fs + fi + ff, bs + bi + bf


def _walk_chunked_cost(M_chunks, **shape):
    f, b = _walk_full_cost(**shape)
    return M_chunks * f, M_chunks * b


def _walk_seeded_chunked_cost(M_chunks, **shape):
    f, b = _walk_seeded_cost(**shape)
    return M_chunks * f, M_chunks * b


def _finalize_gathered_cost(Q, L, D, itemsize=4, **_):
    flops = 2.0 * Q * L * D + 3.0 * Q * L * D / 2.0 + 4.0 * Q * L
    nbytes = 2.0 * Q * L * D * itemsize + 6.0 * Q * L * 4
    return flops, nbytes


costmodel.register("beam.finalize_gathered", _finalize_host,
                   _finalize_gathered_cost)
costmodel.register("beam.seed", _seed_from_pivots, _seed_pivot_cost)
costmodel.register("beam.seed_seeded", _seed_from_seeds, _seed_seeded_cost)
costmodel.register("beam.segment", GraphSearchEngine.run_segment,
                   _segment_cost)
costmodel.register("beam.finalize", _finalize, _finalize_cost)
costmodel.register("beam.walk", GraphSearchEngine._walk_chunk,
                   _walk_full_cost)
costmodel.register("beam.walk_seeded", GraphSearchEngine._walk_chunk,
                   _walk_seeded_cost)
costmodel.register("beam.walk_chunked", GraphSearchEngine.search,
                   _walk_chunked_cost)
costmodel.register("beam.walk_seeded_chunked", GraphSearchEngine.search,
                   _walk_seeded_chunked_cost)
