"""Slot scheduler — continuous batching for the beam walk (port of
``sptag_tpu/algo/scheduler.py``).

The monolithic walk (algo/engine.py) runs a batch until its last row is
done: every query pays for the slowest one's iterations.  Here queries
occupy SLOTS of a fixed-shape walk state, one segment advances every
resident row by at most ``segment_iters`` iterations, and between segments
the worker

* RETIRES rows whose ``alive`` flag dropped (their pool is final: the
  engine's absorbing-state contract) and resolves their futures, so
  callers stream results as queries finish;
* REFILLS freed slots from the pending queue, seeding the newcomers at a
  ``utils.QUERY_BUCKETS`` batch shape;
* COMPACTS the survivors into a smaller capacity bucket when occupancy
  drops and nothing is pending.

Parity: rows are independent in the walk body, rows that are not alive
are bit-frozen and every pick is a stable first-occurrence sort, so a
scheduled query returns the ids that ``engine.search`` returns for it,
whatever shares its slots.  Distances may differ in the last ulp only
where a refill bucket's shape differs from the monolithic batch's (the
float32 contractions are tiled per shape).

Pools: one per ``(k_eff, L, B, nbp_limit, inject, seed_width)``; budgets
ride per row as ``t_limit``, so queries whose MaxCheck values agree on the
rest share a pool.  Capacities and refill sizes follow ``QUERY_BUCKETS``;
slots are clamped to ``engine.chunk_size()``.

Unlike the JAX package, whose pools round-trip through host numpy every
segment, the slot state stays on the device (the visited table alone is
(slots, N + 1) bool, 205 MB per pool at 200k rows): inserts, retires and
compactions are index operations there, and the worker reads back only
the (slots,) ``alive`` flags and the retiring rows' results.

On the card a segment at a capacity of at most ``graph_max_slots``
replays a CUDA graph, captured per ``(pool, capacity, S)`` the second
time that key runs (static state buffers the pool's state is copied in
and out of; ``capture_error_mode="thread_local"``, since the worker is
not the main thread; at most ``_GRAPH_CACHE`` kept).  The engine
captures it on its own card (``capture_segment``); a mesh engine
captures one graph a shard, each on its shard's card.  There the host's
launches bound an eager segment; at 1,024 slots the card does, and a
replay did not pay (PERF.md), so larger capacities run eagerly.

Observability as in the JAX package: the ``scheduler.*`` metrics the
serving layer reads (slot wait, occupancy, pending, submitted, segments,
retired, worker errors, leaked workers), the flight recorder's
``scheduler`` events and per-rid stats for the slow-query log, the host
profiler's execute-stage pin, and the lock sanitizer (``SanLock``,
``race_track``), and the device-memory ledger (the slot pool as the
``slot_pool`` component, ``utils/devmem.py``).  The trace sentinel's hot
sections (``scheduler.seed`` / ``scheduler.cycle`` /
``scheduler.finalize``, utils/recompile_guard.py) guard the worker's device
work and its readbacks are blessed; a segment graph's capture counts as a
compile there.  Each retired query's slow-query stats carry its roofline
attribution (``gflops`` / ``pct_peak``: the ledger's ``beam.segment`` work
of its iterations over its resident time), and a mesh engine
(parallel/mesh_engine.py) adds the shard-skew telemetry: per-shard
iterations, the straggler and each query's shard imbalance.  A mesh
engine's state values hold one tensor a shard on that shard's card
(``ShardSlices``): the pool's row bookkeeping indexes them as it indexes
a tensor, with row indices built where the engine asks
(``index_device``), and allocates, reads back and tracks them through
`_empty_rows`, `_readback` and `_card_bytes`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.engine import STATE_KEYS, capture_lock
from sptag_tpu_torch.utils import (costmodel, devmem, flightrec, hostprof,
                                   locksan, metrics, query_bucket,
                                   recompile_guard, trace)

log = logging.getLogger(__name__)

#: sentinel distance, shared with engine.py
MAX_DIST = np.float32(3.4e38)

# segments at a capacity up to this replay CUDA graphs on the card (the
# default of graph_max_slots); a larger one runs eagerly
_GRAPH_MAX_SLOTS = 256
# captured segments kept per scheduler (each holds its own memory pool
# and a copy of its pool's state); the least recently replayed goes first
_GRAPH_CACHE = 8


# ---------------------------------------------------------------------------
# mesh shard-skew telemetry: per-shard work from a mesh pool's (cap,
# n_shards) iteration counters, published as a labeled family so /metrics
# shows ``scheduler_shard_iters{shard=}`` and the timeline its history
# ---------------------------------------------------------------------------

_skew_lock = locksan.make_lock("scheduler._skew_lock")
#: shard -> mean resident iterations per live row (last cycle)
_shard_iters: Dict[int, float] = {}


def _publish_shard_skew(it: np.ndarray, shards: int) -> None:
    """Per-shard work and skew gauges from the live rows' (live,
    n_shards) iteration counters; once per cycle."""
    if not it.shape[0]:
        return
    per_shard = it.reshape(-1, shards).sum(axis=0).astype(np.float64)
    mean = float(per_shard.mean())
    with _skew_lock:
        _shard_iters.clear()
        for s in range(shards):
            _shard_iters[s] = round(float(per_shard[s]) / it.shape[0], 3)
    if mean > 0:
        # skew: the straggler's excess over the mesh mean (0 = balanced);
        # the straggler's sub-walks converge last and hold every slot row
        metrics.set_gauge("scheduler.shard_skew",
                          float(per_shard.max()) / mean - 1.0)
        metrics.set_gauge("scheduler.straggler_shard",
                          int(per_shard.argmax()))


def _shard_iter_families() -> List[metrics.Family]:
    with _skew_lock:
        if not _shard_iters:
            return []
        fam = metrics.Family(
            "scheduler.shard_iters",
            help="mean resident walk iterations per live slot row, "
                 "per mesh shard (straggler telemetry)")
        for s, v in sorted(_shard_iters.items()):
            fam.samples.append(({"shard": str(s)}, v))
    return [fam]


def reset_shard_skew() -> None:
    """Drop the published per-shard series (test isolation)."""
    with _skew_lock:
        _shard_iters.clear()


metrics.register_family_provider("mesh_skew", _shard_iter_families)


def _empty_rows(arr, capacity: int):
    """Uninitialised slot rows shaped like `arr`'s rows (a mesh state
    value allocates one tensor a shard, each on its card)."""
    new_rows = getattr(arr, "new_rows", None)
    if new_rows is not None:
        return new_rows(capacity)
    return torch.empty((capacity,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                       device=arr.device)


def _readback(arr) -> np.ndarray:
    """A blessed readback of slot rows; a mesh state value stacks its
    shards' rows along axis 1."""
    to_host = getattr(arr, "to_host", None)
    if to_host is not None:
        return to_host()
    return recompile_guard.device_get(arr)


def _card_bytes(state: dict, t_limit) -> Dict[str, int]:
    """Resident bytes of a pool's slot state by card."""
    out: Dict[str, int] = {}
    for arr in list(state.values()) + [t_limit]:
        if arr is None:
            continue
        for part in getattr(arr, "parts", (arr,)):
            out[str(part.device)] = out.get(str(part.device), 0) \
                + part.nbytes
    return out


class SchedulerStopped(RuntimeError):
    """submit() after stop() or retire(), or the worker thread died."""


def pad_result_row(d: np.ndarray, ids: np.ndarray, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad one query's (k_eff,) results out to (k,) with the MAX_DIST /
    -1 sentinels (gather_futures and the streaming submit_batch)."""
    dd = np.full((k,), MAX_DIST, np.float32)
    ii = np.full((k,), -1, np.int32)
    kc = min(k, d.shape[0])
    dd[:kc] = d[:kc]
    ii[:kc] = ids[:kc]
    return dd, ii


def gather_futures(futs, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve per-query (dists, ids) futures into search_batch's output
    contract: (Q, k) float32 / int32, MAX_DIST / -1 padded."""
    out_d = np.zeros((len(futs), k), np.float32)
    out_i = np.zeros((len(futs), k), np.int32)
    for i, f in enumerate(futs):
        d, ids = f.result()
        out_d[i], out_i[i] = pad_result_row(d, ids, k)
    return out_d, out_i


class _Item:
    __slots__ = ("query", "seeds", "t_limit", "future", "t_enq", "rid",
                 "slot_wait", "segments", "refills")

    def __init__(self, query, seeds, t_limit, future, t_enq, rid=""):
        self.query = query
        self.seeds = seeds
        self.t_limit = t_limit
        self.future = future
        self.t_enq = t_enq
        # flight-recorder attribution: the request id, the time queued
        # before a slot opened, the segments resident and the refill
        # batches that joined the pool while resident
        self.rid = rid
        self.slot_wait = 0.0
        self.segments = 0
        self.refills = 0


class _SlotPool:
    """Slot state of one static walk configuration, on the device.
    Capacity rides the QUERY_BUCKETS ladder."""

    def __init__(self, key, engine, seg_iters: int, slots: int):
        self.key = key
        (self.k_eff, self.L, self.B, self.nbp_limit, self.inject,
         self.seed_width) = key
        self.engine = engine
        self.seg_iters = seg_iters
        self.max_slots = slots
        self.capacity = 0
        self.entries: List[Optional[_Item]] = []
        self.state: Dict[str, Optional[torch.Tensor]] = {}
        self.t_limit: Optional[torch.Tensor] = None
        self._iter_cost1 = None

    def iter_cost1(self):
        """Ledger cost of ONE walk iteration for ONE query of this pool
        (the slow-query roofline attribution), or None.  Estimated at the
        pool's slot count and divided down: the binned body's bytes carry
        a per-dispatch corpus term a one-row estimate would charge in full
        to every query."""
        if self._iter_cost1 is None:
            try:
                rows = max(int(self.max_slots), 1)
                est = self.engine.walk_iter_cost(rows, self.B, self.L)
                self._iter_cost1 = costmodel.CostEstimate(
                    est.family, est.flops / rows, est.hbm_bytes / rows)
            except Exception:                             # noqa: BLE001
                self._iter_cost1 = False
        return self._iter_cost1 or None

    def live_count(self) -> int:
        return sum(e is not None for e in self.entries)

    def _blank_rows(self, idx) -> None:
        """Reset slots `idx` (a slice or an int64 index tensor) to the
        empty-row encoding: t_limit 0 (never alive: a segment leaves the
        row as it is), -1 / MAX_DIST pools, nothing visited."""
        s = self.state
        s["cand_ids"][idx] = -1
        s["cand_d"][idx] = float(MAX_DIST)
        s["expanded"][idx] = True
        s["expanded"][idx, ..., self.L] = False     # the dump column
        s["visited"][idx] = False
        s["no_better"][idx] = 0
        s["ptr"][idx] = 0
        s["it"][idx] = 0
        self.t_limit[idx] = 0
        s["queries"][idx] = 0
        if s.get("spare_ids") is not None:
            s["spare_ids"][idx] = -1
            s["spare_d"][idx] = float(MAX_DIST)

    def _alloc(self, capacity: int, like: Dict[str, torch.Tensor]) -> None:
        """(Re)allocate the slot tensors at `capacity`, the live rows
        moved to the front (the compaction step); `like` gives dtypes and
        widths: the previous state or a freshly seeded bucket."""
        old_state, old_entries, old_tl = self.state, self.entries, \
            self.t_limit
        dev = self.engine.device
        self.state = {name: (None if arr is None
                             else _empty_rows(arr, capacity))
                      for name, arr in like.items()}
        self.t_limit = torch.empty(capacity, dtype=torch.int64, device=dev)
        self.entries = [None] * capacity
        self.capacity = capacity
        # device-memory ledger: the pool's slot-state footprint,
        # re-tracked at every grow/compact so the gauge follows occupancy.
        # The port keeps the slot state on the device between segments
        # (the JAX package round-trips it through the host and marks the
        # entry host=True), so it counts toward the device total here
        cards = _card_bytes(self.state, self.t_limit)
        devmem.track("slot_pool", self, sum(cards.values()), cards=cards)
        self._blank_rows(slice(None))
        src = [i for i, e in enumerate(old_entries) if e is not None]
        if src:
            idx_dev = self.engine.index_device
            dst = torch.arange(len(src), device=idx_dev)
            src_t = torch.tensor(src, device=idx_dev)
            for name, arr in old_state.items():
                if arr is not None:
                    self.state[name][dst] = arr[src_t]
            self.t_limit[dst] = old_tl[src_t]
            for d, s_i in enumerate(src):
                self.entries[d] = old_entries[s_i]

    def target_capacity(self, incoming: int) -> int:
        need = max(self.live_count() + incoming, 1)
        return query_bucket(min(need, self.max_slots), self.max_slots)


@locksan.race_track
class BeamSlotScheduler:
    """Continuous-batching front end over one GraphSearchEngine snapshot.

    `submit()` returns a `concurrent.futures.Future` resolving to
    `(dists (k_eff,), ids (k_eff,))` for that query; `search_batch()` is
    the submit-all-and-wait form with engine.search's output contract.
    One daemon worker thread does all device work; submitters only touch
    the pending queue."""

    def __init__(self, engine, slots: int = 1024, segment_iters: int = 0,
                 name: str = "beam-sched",
                 graph_max_slots: int = _GRAPH_MAX_SLOTS):
        self._engine = engine
        self._slots = max(1, min(slots, engine.chunk_size()))
        self._segment_iters = segment_iters
        self._graph_max_slots = (graph_max_slots
                                 if engine.device.type == "cuda" else 0)
        # captured segments by (pool key, capacity, S), oldest first; keys
        # seen once (captured at the second)
        self._graphs = collections.OrderedDict()
        self._graph_seen = set()
        self._lock = locksan.make_lock("BeamSlotScheduler._lock")
        self._cv = threading.Condition(self._lock)
        self._pending: Dict[tuple, collections.deque] = {}
        self._pools: Dict[tuple, _SlotPool] = {}
        self._stopped = False
        self._draining = False
        self._worker_error: Optional[BaseException] = None
        self._counts = {"retired": 0, "resident_iters_sum": 0,
                        "resident_iters_max": 0, "segments_eager": 0,
                        "segments_replayed": 0, "segment_s_eager": 0.0,
                        "segment_s_replayed": 0.0, "graphs_captured": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    # ---- submission surface ----------------------------------------------

    def submit(self, query: np.ndarray, k: int, max_check: int,
               beam_width: int = 16, pool_size: Optional[int] = None,
               nbp_limit: int = 3, dynamic_pivots: int = 4,
               seeds: Optional[np.ndarray] = None,
               rid: str = "") -> Future:
        """Queue one query; the future resolves to (dists, ids), the
        values `engine.search` returns for it.  `rid` tags the query's
        flight-recorder events and per-rid stats."""
        k_eff, L, B, T, limit = self._engine.walk_plan(
            k, max_check, beam_width, pool_size, nbp_limit)
        seeds_row = None
        seed_width = -1
        if seeds is not None:
            seeds_row = np.asarray(seeds, np.int64).reshape(-1)
            seed_width = seeds_row.shape[0]
            inject = 0
        else:
            inject = dynamic_pivots
        key = (k_eff, L, B, limit, inject, seed_width)
        fut: Future = Future()
        item = _Item(np.asarray(query).reshape(-1), seeds_row, T, fut,
                     time.perf_counter(), rid=rid)
        if flightrec.enabled():
            flightrec.record("scheduler", "pending", rid,
                             payload={"max_check": max_check})
        with self._cv:
            if (self._stopped or self._draining
                    or self._worker_error is not None):
                raise SchedulerStopped(
                    f"scheduler is stopped ({self._worker_error!r})")
            self._pending.setdefault(key, collections.deque()).append(item)
            metrics.set_gauge("scheduler.pending", self._pending_count())
            self._cv.notify()
        metrics.inc("scheduler.submitted")
        return fut

    def search_batch(self, queries: np.ndarray, k: int, max_check: int,
                     beam_width: int = 16, pool_size: Optional[int] = None,
                     nbp_limit: int = 3, dynamic_pivots: int = 4,
                     seeds: Optional[np.ndarray] = None,
                     rids: Optional[List[str]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Submit a whole (Q, D) batch and wait; engine.search's output
        contract ((Q, k) dists / ids, MAX_DIST / -1 padded)."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        futs = [self.submit(queries[i], k, max_check,
                            beam_width=beam_width, pool_size=pool_size,
                            nbp_limit=nbp_limit,
                            dynamic_pivots=dynamic_pivots,
                            seeds=None if seeds is None else seeds[i],
                            rid=rids[i] if rids else "")
                for i in range(queries.shape[0])]
        return gather_futures(futs, k)

    def stats(self) -> Dict[str, float]:
        """Live / pending / capacity (the no-slot-leak probe after a
        drain), and the worker's counters: queries retired, the walk
        iterations they were resident for (sum, max), and segments run
        eagerly or replayed with their wall seconds (the alive read-back
        included)."""
        with self._lock:
            return {
                "live": sum(p.live_count() for p in self._pools.values()),
                "pending": self._pending_count(),
                "capacity": sum(p.capacity for p in self._pools.values()),
                "pools": len(self._pools), **self._counts}

    def retire(self) -> None:
        """Stop accepting NEW queries but let everything already pending
        or resident finish; the worker exits on its own once drained.
        The snapshot-swap path: a superseded scheduler walks its in-flight
        queries on the old engine snapshot while the new one serves new
        traffic."""
        with self._cv:
            already = self._draining
            self._draining = True
            self._cv.notify()
            resident = (sum(p.live_count() for p in self._pools.values())
                        + self._pending_count())
        if not already:
            # how many schedulers a mutation stream retired and how much
            # work each drained: the witness that a swap dropped nothing
            metrics.inc("scheduler.retired_schedulers")
            if flightrec.enabled():
                flightrec.record("scheduler", "retire_drain",
                                 payload={"resident": resident})

    def stop(self) -> None:
        """Stop the worker and fail outstanding queries with
        SchedulerStopped (idempotent).  The engine snapshot is untouched."""
        with self._cv:
            self._stopped = True
            self._cv.notify()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():    # pragma: no cover - wedged card
                metrics.inc("scheduler.leaked_workers")
                log.warning("scheduler worker still running after stop "
                            "join")
        leftovers: List[_Item] = []
        with self._lock:
            for dq in self._pending.values():
                leftovers.extend(dq)
                dq.clear()
            for pool in self._pools.values():
                leftovers.extend(e for e in pool.entries if e is not None)
                pool.entries = [None] * pool.capacity
                devmem.untrack(pool)
        for item in leftovers:
            if not item.future.done():
                item.future.set_exception(
                    SchedulerStopped("scheduler stopped"))

    @property
    def draining(self) -> bool:
        """Retired, and neither stopped nor failed: it refuses new
        queries while it finishes those it holds."""
        return (self._draining and not self._stopped
                and self._worker_error is None)

    @property
    def alive(self) -> bool:
        """Whether the worker thread is still running."""
        return self._thread.is_alive()

    # ---- internals --------------------------------------------------------

    def _pending_count(self) -> int:
        return sum(len(dq) for dq in self._pending.values())

    def _has_work_locked(self) -> bool:
        return (self._pending_count() > 0
                or any(p.live_count() for p in self._pools.values()))

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._stopped and not self._has_work_locked():
                        if self._draining:
                            self._release()
                            return            # retired and drained
                        self._cv.wait(timeout=1.0)
                    if self._stopped:
                        self._release()
                        return
                    # pending items move into their pools' intake under
                    # the lock; device work happens outside it
                    intake: Dict[tuple, List[_Item]] = {}
                    for key, dq in self._pending.items():
                        pool = self._pools.get(key)
                        if pool is None:
                            pool = self._make_pool(key, dq[0].t_limit)
                            self._pools[key] = pool
                        take = min(pool.max_slots - pool.live_count(),
                                   len(dq))
                        if take:
                            intake[key] = [dq.popleft()
                                           for _ in range(take)]
                    metrics.set_gauge("scheduler.pending",
                                      self._pending_count())
                    active_pools = [p for p in self._pools.values()
                                    if p.live_count() or intake.get(p.key)]
                for pool in active_pools:
                    self._cycle(pool, intake.get(pool.key, []))
        except Exception as e:      # noqa: BLE001 - the worker must report
            log.exception("scheduler worker died")
            with self._cv:
                self._worker_error = e
                self._stopped = True
            metrics.inc("scheduler.worker_errors")
            # fail everything in flight so no caller blocks forever
            with self._lock:
                items = [i for dq in self._pending.values() for i in dq]
                for dq in self._pending.values():
                    dq.clear()
                for pool in self._pools.values():
                    items.extend(x for x in pool.entries if x is not None)
                    pool.entries = [None] * pool.capacity
            for item in items:
                if not item.future.done():
                    item.future.set_exception(e)
            self._release()

    def _release(self) -> None:
        """Drop the captured graphs and the pools' device tensors: a
        retired scheduler may stay referenced long after its last query
        (the entries stay, for stop() to fail)."""
        self._graphs.clear()
        for pool in self._pools.values():
            pool.state = {}
            pool.t_limit = None
            pool.capacity = 0
            devmem.untrack(pool)

    def _make_pool(self, key, first_t: int) -> _SlotPool:
        seg = self._segment_iters
        if seg <= 0:
            # a quarter of the first submitter's budget: short enough that
            # retire and refill bite, long enough to amortize a cycle
            seg = max(1, -(-first_t // 4))
        return _SlotPool(key, self._engine, seg, self._slots)

    def _cycle(self, pool: _SlotPool, incoming: List[_Item]) -> None:
        engine = self._engine
        now = time.perf_counter()
        rec = flightrec.enabled()
        if hostprof.armed():
            # everything this worker does is execute-stage serve work;
            # re-pinned per cycle so a profiler armed mid-flight
            # attributes the very next cycle
            hostprof.set_stage("execute")
        # ---- resize (grow for the intake / compact a drained pool)
        target = pool.target_capacity(len(incoming))
        residents = pool.live_count()
        if incoming and residents:
            # a refill: count it against every resident query
            for e in pool.entries:
                if e is not None:
                    e.refills += 1
            if rec:
                flightrec.record("scheduler", "refill",
                                 payload={"count": len(incoming),
                                          "live": residents})
        if incoming and pool.capacity == 0:
            # the first allocation takes dtypes and widths from a seeded
            # bucket
            seeded = self._seed_bucket(pool, incoming)
            pool._alloc(target, seeded)
            self._insert(pool, incoming, seeded)
        else:
            if target != pool.capacity:
                if rec and target < pool.capacity and residents:
                    flightrec.record("scheduler", "compact",
                                     payload={"from": pool.capacity,
                                              "to": target})
                pool._alloc(target, pool.state)
            if incoming:
                self._insert(pool, incoming,
                             self._seed_bucket(pool, incoming))
        for item in incoming:
            item.slot_wait = now - item.t_enq
            metrics.observe("scheduler.slot_wait", item.slot_wait)
            if rec:
                flightrec.record("scheduler", "slot_assign", item.rid,
                                 dur_ns=int(item.slot_wait * 1e9))
        metrics.set_gauge("scheduler.occupancy",
                          pool.live_count() / max(pool.capacity, 1))
        if not pool.live_count():
            return
        t_seg0 = time.monotonic_ns() if rec else 0
        # hot section: implicit syncs in here are the sentinel's
        # violations; the segment's readbacks are blessed
        with recompile_guard.hot_section("scheduler.cycle"):
            alive = self._segment(pool)
        metrics.inc("scheduler.segments")
        # a mesh segment advances the walk on every shard at once: the
        # device-work counter scales by the shard count
        shards = int(getattr(engine, "n_shards", 1))
        if shards > 1:
            metrics.inc("scheduler.shard_segments", shards)
            metrics.set_gauge("scheduler.mesh_shards", shards)
            live = [i for i, e in enumerate(pool.entries) if e is not None]
            with recompile_guard.hot_section("scheduler.cycle"):
                it_live = _readback(pool.state["it"][
                    torch.tensor(live, device=engine.index_device)])
            _publish_shard_skew(it_live, shards)
        live_now = 0
        for e in pool.entries:
            if e is not None:
                e.segments += 1
                live_now += 1
        if rec:
            flightrec.record("scheduler", "segment",
                             dur_ns=time.monotonic_ns() - t_seg0,
                             payload={"live": live_now,
                                      "capacity": pool.capacity})
        done = [i for i, e in enumerate(pool.entries)
                if e is not None and not alive[i]]
        if not done:
            metrics.set_gauge("scheduler.occupancy",
                              pool.live_count() / max(pool.capacity, 1))
            return
        # ---- retire: finalize only the retiring rows, gathered to a
        # bucketed sub-batch
        Rb = query_bucket(len(done), pool.capacity)
        rows = torch.tensor(done + [done[0]] * (Rb - len(done)),
                            device=engine.index_device)
        with recompile_guard.hot_section("scheduler.finalize"):
            sub = {name: pool.state[name][rows]
                   for name in ("queries", "cand_ids", "cand_d")}
            d, ids = engine.finalize(sub, pool.k_eff)
            row_it = _readback(pool.state["it"][rows[:len(done)]])
        t_done = time.perf_counter()
        # a mesh row holds one counter a shard: device residency follows
        # the slowest shard's walk
        row_it = row_it.reshape(len(done), -1)
        iters = [int(v) for v in row_it.max(axis=1)]
        cost1 = pool.iter_cost1()
        cap = getattr(engine, "_capability", None)
        items = [pool.entries[i] for i in done]
        for i in done:
            pool.entries[i] = None
        with self._lock:
            c = self._counts
            c["retired"] += len(done)
            c["resident_iters_sum"] += int(sum(iters))
            c["resident_iters_max"] = max(c["resident_iters_max"],
                                          max(iters))
        # every observation of the retiring queries is published before
        # any future resolves: a caller reading metrics or flight stats
        # at result time finds its own query's numbers
        metrics.inc("scheduler.retired", len(done))
        if shards > 1:
            # retire frees one slot row per shard
            metrics.inc("scheduler.shard_retired", len(done) * shards)
        for j, item in enumerate(items):
            metrics.observe("scheduler.query_s", t_done - item.t_enq)
            if rec:
                flightrec.record(
                    "scheduler", "retire", item.rid,
                    dur_ns=int((t_done - item.t_enq) * 1e9),
                    payload={"segments": item.segments,
                             "refills": item.refills})
            if item.rid:
                # iters against the budget is the quality monitor's
                # triage input (qualmon.classify_low_recall); retire owns
                # the query's lifecycle, so it replaces a reused rid's
                # stats
                stats = dict(
                    _replace=True,
                    slot_wait_ms=round(item.slot_wait * 1000.0, 3),
                    segments=item.segments, refills=item.refills,
                    iters=int(iters[j]), t_budget=int(item.t_limit))
                if row_it.shape[1] > 1:
                    # per-query shard skew: qualmon names a straggler-
                    # dominated budget exhaustion after the slow shard
                    row_mean = float(row_it[j].mean())
                    if row_mean > 0:
                        stats["shard_imbalance"] = round(
                            float(row_it[j].max()) / row_mean, 3)
                        stats["slow_shard"] = int(row_it[j].argmax())
                if cost1 is not None:
                    # roofline attribution: the row's iterations x the
                    # one-row ledger cost over its resident time
                    exec_s = max(t_done - item.t_enq - item.slot_wait,
                                 1e-9)
                    q_flops = cost1.flops * iters[j]
                    q_bytes = cost1.hbm_bytes * iters[j]
                    stats["gflops"] = round(q_flops / exec_s / 1e9, 3)
                    if cap is not None:
                        pct = cap.pct_of_peak(q_flops / exec_s,
                                              q_bytes / exec_s,
                                              engine.score_dtype_name())
                        if pct is not None:
                            stats["pct_peak"] = round(pct, 4)
                flightrec.note_query_stats(item.rid, **stats)
        for j, item in enumerate(items):
            if not item.future.done():
                item.future.set_result((d[j].copy(), ids[j].copy()))
        pool._blank_rows(torch.tensor(done, device=engine.index_device))
        metrics.set_gauge("scheduler.occupancy",
                          pool.live_count() / max(pool.capacity, 1))

    def _segment(self, pool: _SlotPool) -> np.ndarray:
        """One segment over the pool's slots (replayed from a captured
        graph where one exists); the (capacity,) alive flags."""
        t0 = time.perf_counter()
        entry = (self._graph_for(pool)
                 if pool.capacity <= self._graph_max_slots else None)
        if entry is None:
            new_state, alive = self._engine.run_segment(
                pool.state, pool.t_limit, pool.k_eff, pool.L, pool.B,
                pool.nbp_limit, pool.seg_iters, inject=pool.inject)
            pool.state.update(new_state)
            mode = "eager"
        else:
            graph, bufs, t_in, alive = entry
            for name, arr in pool.state.items():
                if arr is not None:
                    bufs[name].copy_(arr)
            t_in.copy_(pool.t_limit)
            timer = self._engine.segment_timer()
            with capture_lock:       # not while the profiler starts / stops
                graph.replay()
            if timer is not None:
                self._engine.publish_segment_sample(
                    pool.capacity, pool.B, pool.L, pool.seg_iters, timer())
            for name in STATE_KEYS:
                pool.state[name].copy_(bufs[name])
            mode = "replayed"
        alive_np = recompile_guard.device_get(alive)
        with self._lock:
            self._counts[f"segments_{mode}"] += 1
            self._counts[f"segment_s_{mode}"] += time.perf_counter() - t0
        return alive_np

    def _graph_for(self, pool: _SlotPool):
        """The captured segment of this pool at its capacity: None the
        first time a key is asked for (the caller runs it eagerly)."""
        key = (pool.key, pool.capacity, pool.seg_iters)
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            return entry
        if key not in self._graph_seen:
            self._graph_seen.add(key)
            return None
        t0 = time.perf_counter()
        entry = self._capture(pool)
        if entry is None:
            return None
        # a capture is the port's compile (utils/recompile_guard.py)
        recompile_guard.note_compile(recompile_guard.CAPTURE,
                                     time.perf_counter() - t0)
        self._graphs[key] = entry
        while len(self._graphs) > _GRAPH_CACHE:
            self._graphs.popitem(last=False)
        with self._lock:
            self._counts["graphs_captured"] += 1
        return entry

    def _capture(self, pool: _SlotPool):
        """A CUDA graph of one S-iteration segment over static copies of
        the pool's state, captured by the engine on its card(s): (graph,
        state buffers, t_limit buffer, alive output); the new state is
        written back into the same buffers.  None while a profile runs
        (utils/trace.py): the caller runs the segment eagerly."""
        if trace.tracing():
            return None
        return self._engine.capture_segment(
            pool.state, pool.t_limit, pool.k_eff, pool.L, pool.B,
            pool.nbp_limit, pool.seg_iters, inject=pool.inject)

    def _seed_bucket(self, pool: _SlotPool,
                     incoming: List[_Item]) -> Dict[str, torch.Tensor]:
        """Seed `incoming` at a QUERY_BUCKETS batch shape (zero rows pad
        it); the seeded state, on the device."""
        engine = self._engine
        R = len(incoming)
        Rb = query_bucket(R, pool.max_slots)
        D = incoming[0].query.shape[0]
        q = np.zeros((Rb, D), incoming[0].query.dtype)
        for i, item in enumerate(incoming):
            q[i] = item.query
        seeds = None
        if pool.seed_width >= 0:
            s = np.full((Rb, pool.seed_width), -1, np.int64)
            for i, item in enumerate(incoming):
                s[i] = item.seeds
            seeds = torch.from_numpy(s).to(engine.device)
        with recompile_guard.hot_section("scheduler.seed"):
            return engine.seed_state(torch.from_numpy(q).to(engine.device),
                                     pool.L, seeds=seeds)

    @staticmethod
    def _insert(pool: _SlotPool, incoming: List[_Item],
                seeded: Dict[str, torch.Tensor]) -> None:
        free = [i for i, e in enumerate(pool.entries) if e is None]
        if len(free) < len(incoming):
            raise RuntimeError("scheduler intake exceeded the free slots")
        R = len(incoming)
        dev = pool.engine.device
        dst = torch.tensor(free[:R], device=pool.engine.index_device)
        for name, arr in pool.state.items():
            if arr is not None:
                arr[dst] = seeded[name][:R]
        pool.t_limit[dst] = torch.tensor([it.t_limit for it in incoming],
                                         dtype=torch.int64, device=dev)
        for slot, item in zip(free, incoming):
            pool.entries[slot] = item
