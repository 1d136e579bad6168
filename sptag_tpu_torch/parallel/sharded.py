"""Sharded (multi-GPU) search (port of ``sptag_tpu/parallel/sharded.py``).

The reference serves a partitioned corpus with one index per server process
and an Aggregator that scatters each query and merges the per-server lists.
The JAX package runs that as ONE compiled program over a device mesh:
``shard_map`` over a 'shard' axis, a per-shard search, an ``all_gather`` of
every shard's (distance, global id) top-k and a final ``lax.top_k``.

Here a mesh is an ordered list of torch devices, one per shard, and it may
repeat a device: the default mesh puts one shard on each card of the host
(``cuda:0`` ... ``cuda:3`` on a four-card host), ``[cuda:0, cuda:0]`` runs
two shards side by side on one card, and a CPU mesh (``["cpu", "cpu"]``)
runs the same code in the tests.  A shard's state (its rows, graph,
pivots, dense layout and walk state) lives on its own card for the whole
residency.  A mesh call issues every shard's work from one thread, shard
after shard, before it reads anything back: the dense and FLAT scans
queue on all the cards at once, while the beam walk asks its card every
few iterations whether a row is still alive, so one shard's walk ends
before the next one's starts.  The walk is host-bound (PERF.md, phase
16), so in one process the cards share one host's launch rate;
processes (parallel/multihost.py) give each card its own.  Each shard
searches through the port's single-index machinery over its own block of
the corpus:

* the beam walk: one `GraphSearchEngine` a shard (algo/engine.py and its
  ``walk_dots.cu`` kernels), over the shard's block padded to the mesh's
  common row count exactly as the JAX mesh pads it;
* the dense scan: the shard's block layout scored by ``block_dots.cu``'s
  ``probe_block_dots`` (algo/dense.py ``_dense_search_kernel``) where the
  JAX mesh gathers and scores with ``batched_gathered_distance``: the same
  function, within float32;
* FLAT's exact scan (algo/flat.py ``_flat_search_kernel``).

The merge is `_gather_merge`: the shards' (Q, k_local) distances and
global ids copied peer to peer to the mesh's first card (`to_card`, which
counts the bytes that cross between cards and raises where two cards have
no peer access: nothing is staged through the host), concatenated in shard
order and reduced by one stable top-k — ``all_gather`` + ``lax.top_k``
with the lowest index winning a tie.  Across processes the same merge runs
over a ``torch.distributed`` all-gather, NCCL on the cards
(parallel/multihost.py).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sptag_tpu_torch.algo.flat import _flat_search_kernel
from sptag_tpu_torch.core.index import MAX_DIST
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import topk_bins
from sptag_tpu_torch.utils import (costmodel, devmem, locksan,
                                   metrics, recompile_guard, round_up)

# queries per dense-scan dispatch a shard (rows are independent)
_DENSE_CHUNK = 1024


class Mesh:
    """An ordered list of torch devices, one per shard; a device may
    appear more than once (several shards on one card)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_card(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def map(self, fn: Callable[[int], object]) -> list:
        """``[fn(s) for s in range(size)]``, shard after shard from the
        caller's thread.  Work queued on one card runs while the next
        shard's is issued; only a shard that reads back (the walk's
        convergence test) holds the next one."""
        return [fn(s) for s in range(self.size)]


def _card(device: torch.device) -> torch.device:
    """A CUDA device without an index names the current card: pin it, so
    shards that name ``cuda`` and ``cuda:0`` are seen on one card."""
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


# bytes copied between two cards, by what they carry (the merge's
# candidates, the mesh scheduler's seated queries, t_limit and alive flags)
_xfer_lock = threading.Lock()
_xfer_bytes: Dict[str, int] = {}
_peer: Dict[Tuple[int, int], bool] = {}


def card_transfer_bytes() -> Dict[str, int]:
    """Bytes copied card to card by `to_card` since the last reset, by
    kind."""
    with _xfer_lock:
        return dict(_xfer_bytes)


def reset_card_transfer_bytes() -> None:
    with _xfer_lock:
        _xfer_bytes.clear()


def peer_access(src: int, dst: int) -> bool:
    """Whether card `dst` can read card `src`'s memory (cached)."""
    key = (src, dst)
    with _xfer_lock:
        ok = _peer.get(key)
    if ok is None:
        ok = bool(torch.cuda.can_device_access_peer(dst, src))
        with _xfer_lock:
            _peer[key] = ok
    return ok


def to_card(t: torch.Tensor, device: torch.device, kind: str
            ) -> torch.Tensor:
    """`t` on `device`.  A copy from one card to another goes peer to
    peer and counts its bytes under `kind`; two cards without peer access
    raise (the mesh stages nothing through the host)."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        if not peer_access(t.device.index, device.index):
            raise RuntimeError(
                f"{device} has no peer access to {t.device}: a mesh copies "
                "between its cards peer to peer and stages nothing through "
                "the host")
        with _xfer_lock:
            _xfer_bytes[kind] = _xfer_bytes.get(kind, 0) + t.nbytes
    return t.to(device)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (torch devices or their names); by default
    every CUDA card of the host, one shard each (four on a four-card
    host), and without CUDA a RuntimeError: nothing moves to the CPU on
    its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass an explicit mesh (for "
                "example make_mesh(['cpu', 'cpu'])) to run a mesh on the "
                "CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def _pad_to_k(d: np.ndarray, ids: np.ndarray, k: int, k_final: int):
    """Host-side sentinel padding of merged results out to k columns."""
    if k_final < k:
        q = d.shape[0]
        d = np.concatenate(
            [d, np.full((q, k - k_final), MAX_DIST, np.float32)], 1)
        ids = np.concatenate(
            [ids, np.full((q, k - k_final), -1, np.int32)], 1)
    return d, ids


def _global_ids(ids: torch.Tensor, shard: int, n_local: int) -> torch.Tensor:
    """Shard-local ids -> global ids (contiguous shards of n_local rows);
    -1 stays -1."""
    ids = ids.to(torch.int64)
    return torch.where(ids >= 0, ids + shard * n_local, -1)


def _gather_merge(parts: List[Tuple[torch.Tensor, torch.Tensor]],
                  k_final: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global merge: every shard's (Q, k_local) distances and global
    ids copied to `device` (peer to peer from another card) and
    concatenated in shard order, one stable top-k_final (the lowest index
    wins a tie, as ``lax.top_k`` over the JAX mesh's tiled all-gather),
    sentinel rows -> -1."""
    all_d = torch.cat([to_card(d, device, "candidates").to(torch.float32)
                       for d, _ in parts], 1)
    all_i = torch.cat([to_card(i, device, "candidates").to(torch.int64)
                       for _, i in parts], 1)
    gd, gpos = dist_ops.smallest_k(all_d, k_final)
    gi = torch.gather(all_i, 1, gpos)
    return gd, torch.where(gd >= MAX_DIST, -1, gi).to(torch.int32)


class ShardedFlatIndex:
    """Exact search over a corpus split in contiguous row blocks over a
    mesh: the data-parallel face of one server a shard behind an
    aggregator, minus the sockets."""

    def __init__(self, data: np.ndarray, metric: DistCalcMethod, base: int,
                 mesh: Optional[Mesh] = None,
                 deleted: Optional[np.ndarray] = None,
                 normalized: bool = False):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.metric = DistCalcMethod(metric)
        self.base = base
        self.n = data.shape[0]
        n_dev = self.mesh.size
        if self.metric == DistCalcMethod.Cosine and not normalized:
            data = dist_ops.normalize(data, base)
        n_pad = round_up(max(self.n, n_dev), n_dev * 8)
        padded = np.zeros((n_pad, data.shape[1]), data.dtype)
        padded[:self.n] = data
        invalid = np.ones(n_pad, dtype=bool)
        invalid[:self.n] = (deleted[:self.n] if deleted is not None
                            else np.zeros(self.n, bool))
        self.n_local = n_pad // n_dev
        self.dtype = padded.dtype
        self.dim = int(padded.shape[1])

        def place(s):
            dev = self.mesh.devices[s]
            rows = slice(s * self.n_local, (s + 1) * self.n_local)
            blk = torch.from_numpy(np.ascontiguousarray(padded[rows])).to(dev)
            inv = torch.from_numpy(np.ascontiguousarray(invalid[rows])).to(
                dev)
            # the cosine scan never reads the norms
            sq = (dist_ops.row_sqnorms(blk)
                  if self.metric == DistCalcMethod.L2
                  else torch.zeros(self.n_local, dtype=torch.float32,
                                   device=dev))
            return blk, sq, inv
        self.shards = self.mesh.map(place)
        cards: Dict[str, int] = {}
        for blk, sq, inv in self.shards:
            card = str(blk.device)
            cards[card] = cards.get(card, 0) + blk.nbytes + sq.nbytes \
                + inv.nbytes
        devmem.track("shard_blocks", self, sum(cards.values()), cards=cards)

    def search(self, queries: np.ndarray, k: int = 10,
               normalized: bool = False, max_check: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        # max_check is accepted (the scan is exact) so the flat mesh index
        # serves behind ServingAdapter, which forwards $maxcheck
        del max_check
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == DistCalcMethod.Cosine and not normalized:
            queries = dist_ops.normalize(queries, self.base)
        n_dev = self.mesh.size
        k_local = min(k, self.n_local)
        k_final = min(k, k_local * n_dev)
        qn = np.ascontiguousarray(queries)

        def scan(s):
            blk, sq, inv = self.shards[s]
            q = torch.from_numpy(qn).to(blk.device)
            d, ids = _flat_search_kernel(blk, sq, inv, q, k_local,
                                         int(self.metric), self.base)
            return d, _global_ids(ids, s, self.n_local)
        parts = self.mesh.map(scan)
        d, ids = _gather_merge(parts, k_final, self.mesh.devices[0])
        return _pad_to_k(*recompile_guard.device_get((d, ids)), k, k_final)


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py; the JAX package's formulas).
# Every shard runs the per-shard formula at the SHARD shapes, so a
# dispatch's device work is n_dev x the single-index cost plus the merge
# (the gather of every shard's (dist, gid) top-k_local and the replicated
# top-k_final).
# ---------------------------------------------------------------------------

def _sharded_merge_cost(Q, k_local, k_final, n_dev):
    gathered = Q * n_dev * k_local
    flops = n_dev * (costmodel.topk_flops(Q, gathered)
                     + 2.0 * Q * k_final)
    nbytes = n_dev * (2.0 * gathered * 8 + Q * k_final * 8)
    return flops, nbytes


def _sharded_flat_cost(Q, N_local, D, k_local, k_final, n_dev,
                       itemsize=4, **_):
    from sptag_tpu_torch.algo.flat import _flat_scan_cost

    f, b = _flat_scan_cost(Q, N_local, D, k_local, itemsize)
    mf, mb = _sharded_merge_cost(Q, k_local, k_final, n_dev)
    return n_dev * f + mf, n_dev * b + mb


def _sharded_beam_cost(Q, P, X, D, L, W, N_local, k_local, k_final,
                       n_dev, **_):
    from sptag_tpu_torch.algo.engine import _walk_full_cost

    f, b = _walk_full_cost(Q, P, X, D, L, W, N_local)
    mf, mb = _sharded_merge_cost(Q, k_local, k_final, n_dev)
    return n_dev * f + mf, n_dev * b + mb


def _sharded_dense_cost(Q, C, Pb, D, nprobe, k_local, k_final, n_dev,
                        itemsize=4, **_):
    from sptag_tpu_torch.algo.dense import _dense_scan_cost

    f, b = _dense_scan_cost(Q, C, Pb, D, nprobe, k_local, itemsize)
    mf, mb = _sharded_merge_cost(Q, k_local, k_final, n_dev)
    return n_dev * f + mf, n_dev * b + mb


@locksan.race_track
class ServingAdapter:
    """A sharded mesh index behind the VectorIndex serving surface
    (value_type / feature_dim / search / search_batch / submit_batch), so
    a SearchServer serves it over the reference wire protocol.  Metadata
    is the frontend's store keyed by GLOBAL id."""

    def __init__(self, sharded, feature_dim: int, value_type=None,
                 mode: str = "beam", metadata=None):
        from sptag_tpu_torch.core.types import VectorValueType, value_type_of

        self._impl = sharded
        self.feature_dim = feature_dim
        self.value_type = (VectorValueType(value_type)
                           if value_type is not None
                           else value_type_of(np.dtype(sharded.dtype)))
        self.metadata = (metadata if metadata is not None
                         else getattr(sharded, "metadata", None))
        if mode not in ("beam", "dense"):
            raise ValueError(f"unknown serving mode: {mode!r}")
        # $searchmode:auto crossover (the single-index AutoModeThreshold
        # default)
        self.auto_mode_threshold = 1024
        if mode == "dense":
            if not hasattr(sharded, "search_dense"):
                raise ValueError("index type has no dense mode")
            if not getattr(sharded, "dense_shards", None):
                raise RuntimeError(
                    "dense layout not packed — build with dense=True")
        self.mode = mode
        # epoch-published placement: readers pin `impl = self._impl` once
        # a call, so a concurrent swap_impl never hands them half of one
        self._swap_lock = locksan.make_lock("ServingAdapter._swap_lock")
        self._epoch = 0
        self._swap_count = 0
        self._mesh_serve = False
        self._mesh_slots = 1024
        self._mesh_segment_iters = 0

    @property
    def num_samples(self) -> int:
        return self._impl.n

    def enable_mesh_serve(self, slots: int = 1024,
                          segment_iters: int = 0) -> bool:
        """Arm the mesh-wide continuous-batching spine ([Service]
        MeshServe=1): the index builds a `MeshGraphEngine` and one slot
        scheduler whose slot rows span every shard, and `submit_batch`
        resolves per-query futures in retire order.  False (stays
        synchronous) for indexes without that surface (FLAT, dense)."""
        impl = self._impl
        enable = getattr(impl, "enable_continuous_batching", None)
        if enable is None or self.mode == "dense":
            return False
        enable(slots=slots, segment_iters=segment_iters)
        self._mesh_serve = True
        self._mesh_slots = slots
        self._mesh_segment_iters = segment_iters
        return True

    def swap_impl(self, new_impl) -> int:
        """Publish a NEW sharded index as this adapter's placement:
        in-flight queries finish on the old one (its retired scheduler
        drains), new queries see the new one.  Returns the new epoch."""
        with self._swap_lock:
            old = self._impl
            self._impl = new_impl
            self._epoch += 1
            self._swap_count += 1
            epoch = self._epoch
            retire = getattr(old, "retire_scheduler", None)
            if retire is not None:
                retire()
            if self._mesh_serve:
                enable = getattr(new_impl, "enable_continuous_batching",
                                 None)
                if enable is not None:
                    enable(slots=self._mesh_slots,
                           segment_iters=self._mesh_segment_iters)
        metrics.inc("mesh.swaps")
        return epoch

    def mutation_state(self) -> dict:
        """Swap / placement state for /healthz and /debug/mutation."""
        impl = self._impl
        return {
            "epoch": self._epoch,
            "swap_count": self._swap_count,
            "mesh": {
                "shards": int(impl.mesh.size),
                "rows": int(impl.n),
                "mesh_serve": self._mesh_serve,
                "scheduler": getattr(impl, "_scheduler", None) is not None,
            },
        }

    def submit_batch(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     search_mode: Optional[str] = None, rids=None):
        """Per-query futures: with MeshServe armed and a beam request they
        resolve as queries retire from the mesh scheduler; otherwise the
        batch runs synchronously and the futures come back resolved."""
        from sptag_tpu_torch.core.index import resolved_futures

        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        impl = self._impl                      # epoch pin
        mode = self._resolve_mode(search_mode, max_check, impl=impl)
        sub = getattr(impl, "submit_batch", None)
        if self._mesh_serve and mode == "beam" and sub is not None:
            return sub(queries, k, max_check=max_check, rids=rids)
        return resolved_futures(
            lambda: self.search_batch(queries, k, max_check=max_check,
                                      search_mode=search_mode),
            queries.shape[0])

    def search_batch(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     search_mode: Optional[str] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """`max_check` / `search_mode` override the build budget and the
        configured mode per request ($maxcheck / $searchmode); ``auto``
        resolves by budget like a single index, falling back to the
        configured mode where the other is not packed."""
        impl = self._impl                      # epoch pin
        mode = self._resolve_mode(search_mode, max_check, impl=impl)
        if mode == "dense":
            return impl.search_dense(np.asarray(queries), k=k,
                                     max_check=max_check)
        return impl.search(np.asarray(queries), k=k, max_check=max_check)

    def _resolve_mode(self, search_mode: Optional[str],
                      max_check: Optional[int], impl=None) -> str:
        impl = impl if impl is not None else self._impl
        mode = search_mode or self.mode
        if mode == "auto":
            mc = (max_check if max_check is not None
                  else getattr(impl, "max_check", 2048))
            want = "dense" if mc >= self.auto_mode_threshold else "beam"
            if want == "dense" and not getattr(impl, "dense_shards", None):
                want = self.mode
            params = getattr(impl, "params", None)
            has_graph = (int(getattr(params, "build_graph", 1))
                         if params is not None else 1)
            if want == "beam" and not has_graph:
                want = self.mode
            mode = want
        if mode not in ("beam", "dense"):
            raise ValueError(f"unknown serving mode: {mode!r}")
        return mode

    def search(self, query, k: int = 10, with_metadata: bool = False,
               max_check: Optional[int] = None,
               search_mode: Optional[str] = None):
        from sptag_tpu_torch.core.index import SearchResult
        from sptag_tpu_torch.core.vectorset import metas_for

        q = np.asarray(query)
        if q.ndim == 1:
            q = q[None, :]
        d, ids = self.search_batch(q, k=k, max_check=max_check,
                                   search_mode=search_mode)
        metas = metas_for(self.metadata, ids[0]) if with_metadata else None
        return SearchResult(ids=ids[0], dists=d[0], metas=metas)


def pack_shard_block(sub, n_local: int, dim: int, m_width: int, max_p: int,
                     words: int = 0) -> dict:
    """Pad one built sub-index into the mesh's per-shard geometry (shared
    by the one-process build and the multi-process one, so the padding
    cannot diverge): rows past the shard's count are zero vectors marked
    deleted, graph rows -1-padded to `m_width`, pivot ids -1-padded to
    `max_p` (a padded pivot scores row 0, as in the JAX mesh).  `words`,
    the JAX package's pivot-bitset width, is unused: the walk marks pivots
    in its visited table."""
    del words
    nb = sub._n
    # cosine rows are normalized at ingest: take the INDEX's copy
    block = np.zeros((n_local, dim), sub._host.dtype)
    block[:nb] = sub._host[:nb]
    g = np.full((n_local, m_width), -1, np.int32)
    gw = min(m_width, sub._graph.shape[1])
    g[:nb, :gw] = sub._graph[:nb, :gw]
    dele = np.ones(n_local, bool)              # padding rows = deleted
    dele[:nb] = sub._deleted[:nb]
    pids = np.full(max_p, -1, np.int32)
    got = np.asarray(sub._pivot_ids(), np.int32)[:max_p]
    pids[:len(got)] = got
    return dict(data=block, graph=g, deleted=dele, pivot_ids=pids)


def _shard_engine(packed: dict, metric, base: int, params, device,
                  quantized=None):
    """One shard's walk engine over its packed block: the single-index
    GraphSearchEngine at the mesh's padded geometry.  Mesh shards score in
    float32 (no bf16 shadow, no packed neighbours, as the JAX mesh walks);
    the cascade's int8 shadow rides when CascadeSearch is on."""
    from sptag_tpu_torch.algo.engine import GraphSearchEngine

    cascade = bool(int(getattr(params, "cascade_search", 0) or 0)) \
        and np.issubdtype(packed["data"].dtype, np.floating)
    return GraphSearchEngine(
        packed["data"], packed["graph"], packed["pivot_ids"],
        packed["deleted"], metric, base,
        binned_topk=str(getattr(params, "binned_topk", "off")),
        recall_target=float(getattr(params, "approx_recall_target", 0.99)),
        cascade_search=cascade, corpus_tier="device", device=device,
        # the mesh engine samples the mesh's segments as a whole
        # (parallel/mesh_engine.py); a shard's own walk does not
        device_sample_rate=0.0,
        roofline_probe=bool(int(getattr(params, "roofline_probe", 0))),
        quantized=quantized if cascade else None)


class ShardedBKTIndex:
    """The graph index, corpus-sharded over a mesh.

    Each shard is an INDEPENDENT index over its contiguous block of the
    corpus (forest + graph with shard-local ids), as each reference server
    owns an index over its partition.  A search walks every shard through
    its own engine and merges (`_gather_merge`)."""

    #: the placement walks the cascade's int8 shadow under CascadeSearch
    #: (the multi-process build places float32 only, as the JAX
    #: package's does)
    _cascade_ok = True

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.metric = DistCalcMethod.L2
        self.base = 1
        self.n = 0
        self.n_local = 0
        self.dim = 0
        self.dtype = np.dtype(np.float32)
        self.max_check = 2048
        self.nbp_limit = 3
        self.beam_width = 16
        self.metadata = None
        self.params = None
        # per-shard budget policy: "full" runs every shard at the whole
        # MaxCheck (the reference aggregator's fan-out semantics);
        # "proportional" gives each ceil(MaxCheck / n_dev) (floored);
        # "guarded" calibrates the smallest proportional multiplier whose
        # results overlap the full budget's by the guard threshold
        self.budget_policy = "full"
        self.budget_guard_overlap = 0.99
        self._guarded_cache: dict = {}
        # one walk engine a shard; one dense layout a shard when packed
        self.engines: list = []
        self.dense_shards: list = []
        # the mesh's shard count and this placement's first shard: a
        # multi-process mesh (parallel/multihost.py) places a contiguous
        # range of the global shards in each process
        self.n_shards = self.mesh.size
        self._shard_base = 0
        self.score_scale = 0.0
        self._scheduler = None
        self._mesh_engine = None

    # ---- mesh-wide continuous batching ------------------------------------

    def enable_continuous_batching(self, slots: int = 1024,
                                   segment_iters: int = 0):
        """Build the mesh serving spine: a `MeshGraphEngine` over this
        placement's shard engines and ONE `BeamSlotScheduler` whose slot
        rows span every shard.  Idempotent; returns the scheduler."""
        if self._scheduler is not None:
            return self._scheduler
        from sptag_tpu_torch.algo.scheduler import BeamSlotScheduler
        from sptag_tpu_torch.parallel.mesh_engine import MeshGraphEngine

        engine = MeshGraphEngine(self)
        self._mesh_engine = engine
        self._scheduler = BeamSlotScheduler(
            engine, slots=slots, segment_iters=segment_iters,
            name="mesh-sched")
        return self._scheduler

    def retire_scheduler(self) -> None:
        """Drop this placement's scheduler without dropping in-flight work
        (the swap path): residents finish on the old snapshot."""
        sched, self._scheduler = self._scheduler, None
        self._mesh_engine = None
        if sched is not None:
            sched.retire()

    def submit_batch(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     search_mode: Optional[str] = None, rids=None):
        """Per-query futures: with the mesh scheduler armed and a beam
        request each resolves in retire order (the ids of `search()` at
        the same budget); dense requests, non-"full" budget policies and
        scheduler-less indexes run one synchronous batch."""
        from concurrent.futures import Future

        from sptag_tpu_torch.core.index import resolved_futures

        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        sched = self._scheduler
        mode = search_mode or "beam"
        if (sched is not None and mode == "beam"
                and self.budget_policy == "full"
                and int(getattr(self.params, "build_graph", 1))):
            from sptag_tpu_torch.algo.scheduler import (SchedulerStopped,
                                                        pad_result_row)

            if self.metric == DistCalcMethod.Cosine:
                queries = dist_ops.normalize(queries, self.base)
            mc = max_check if max_check is not None else self.max_check
            out = []
            try:
                for i in range(queries.shape[0]):
                    inner = sched.submit(queries[i], k, mc,
                                         beam_width=self.beam_width,
                                         nbp_limit=self.nbp_limit,
                                         rid=rids[i] if rids else "")
                    # pad k_eff (the merge width, possibly < k) to k
                    outer: Future = Future()

                    def _pad(f, outer=outer):
                        e = f.exception()
                        if e is not None:
                            outer.set_exception(e)
                            return
                        d, ids = f.result()
                        outer.set_result(pad_result_row(d, ids, k))
                    inner.add_done_callback(_pad)
                    out.append(outer)
            except SchedulerStopped:
                # a swap retired this scheduler mid-batch: the rest serves
                # synchronously on the live placement (already normalized)
                rest = queries[len(out):]
                out.extend(resolved_futures(
                    lambda: self.search(rest, k, max_check=max_check,
                                        normalized=True),
                    rest.shape[0]))
            return out
        return resolved_futures(
            lambda: (self.search_dense(queries, k, max_check=max_check)
                     if mode == "dense"
                     else self.search(queries, k, max_check=max_check)),
            queries.shape[0])

    def set_deleted(self, deleted: np.ndarray) -> None:
        """Publish a new GLOBAL tombstone mask (rows past `n` stay
        deleted); every search path's next dispatch reads it."""
        mask = np.ones(self.n_shards * self.n_local, bool)
        mask[:self.n] = np.asarray(deleted, bool)[:self.n]

        def rows(s):
            g = self._shard_base + s
            return mask[g * self.n_local:(g + 1) * self.n_local]
        for s, eng in enumerate(self.engines):
            eng.set_deleted(rows(s))
        for s, ds in enumerate(self.dense_shards):
            ds["deleted"] = torch.from_numpy(
                np.ascontiguousarray(rows(s))).to(ds["deleted"].device)

    # ---- persistence --------------------------------------------------------

    @classmethod
    def load(cls, folder: str, mesh: Optional[Mesh] = None,
             dense: bool = False) -> "ShardedBKTIndex":
        """Load a mesh folder saved by `build(..., save_to=folder)` (or by
        the JAX package): one reference-format sub-index folder a shard
        (``shard_000``, ...) and ``sharded.json``.  The default mesh takes
        the first n_shards CUDA cards and raises when the host has fewer;
        an explicit mesh must match the shard count and may repeat a
        device (``[cuda:0, cuda:0]``)."""
        from sptag_tpu_torch.core.index import load_index

        with open(os.path.join(folder, "sharded.json")) as f:
            meta = json.load(f)
        if mesh is None:
            devs = make_mesh().devices          # raises without CUDA
            if len(devs) < meta["n_shards"]:
                raise ValueError(
                    f"saved index has {meta['n_shards']} shards but the "
                    f"host exposes only {len(devs)} devices (pass an "
                    "explicit mesh, which may repeat a device)")
            mesh = Mesh(devs[:meta["n_shards"]])
        if mesh.size != meta["n_shards"]:
            raise ValueError(
                f"mesh has {mesh.size} devices but the saved index has "
                f"{meta['n_shards']} shards")
        # each shard loads onto its card, shard after shard
        subs = mesh.map(lambda s: load_index(
            os.path.join(folder, f"shard_{s:03d}"), device=mesh.devices[s]))
        self = cls._assemble(subs, meta["n"], meta["dim"],
                             DistCalcMethod(meta["metric"]), mesh,
                             meta.get("empty_shards", []), dense)
        mpath = os.path.join(folder, "metadata.bin")
        ipath = os.path.join(folder, "metadataIndex.bin")
        if os.path.exists(mpath) and os.path.exists(ipath):
            from sptag_tpu_torch.core.vectorset import FileMetadataSet
            self.metadata = FileMetadataSet(mpath, ipath)
        return self

    def save(self, folder: str) -> None:
        raise NotImplementedError(
            "save happens at build time: ShardedBKTIndex.build(..., "
            "save_to=folder) — the placed shards do not retain the "
            "per-shard trees a reference-format save needs")

    @classmethod
    def build(cls, data: np.ndarray,
              metric: DistCalcMethod = DistCalcMethod.L2,
              mesh: Optional[Mesh] = None, value_type=None,
              params: Optional[dict] = None, dense: bool = False,
              save_to: Optional[str] = None, algo: str = "BKT",
              metadata=None) -> "ShardedBKTIndex":
        """Partition `data` into contiguous equal blocks, build one
        sub-index a shard on its device, and place the shards.  `algo`:
        "BKT" or "KDT".  `dense=True` also packs each shard's dense layout
        (`search_dense`).  `save_to` writes ``shard_NNN`` folders and the
        ``sharded.json`` manifest (metadata, global-id keyed, at the top
        level), loadable by `load` in either package."""
        from sptag_tpu_torch.core.index import create_instance
        from sptag_tpu_torch.core.types import value_type_of

        if str(algo).upper() not in ("BKT", "KDT"):
            raise ValueError(
                f"sharded mesh indexes support BKT or KDT shards, not "
                f"{algo!r}")
        if mesh is None:
            # MeshShardAxis: the first N cards instead of all of them
            n_axis = int((params or {}).get("MeshShardAxis", 0) or 0)
            mesh = make_mesh()
            if n_axis > 0:
                mesh = Mesh(mesh.devices[:n_axis])
        n_dev = mesh.size
        n = data.shape[0]
        if n < n_dev:
            raise ValueError(f"corpus ({n}) smaller than mesh ({n_dev})")
        n_local = -(-n // n_dev)
        metric = DistCalcMethod(metric)
        if value_type is None:
            value_type = value_type_of(np.asarray(data).dtype)
        empty_shards = [s for s in range(n_dev) if s * n_local >= n]

        def build_shard(s):
            block = np.asarray(data[s * n_local:(s + 1) * n_local])
            if block.shape[0] == 0:
                # a ceil-division tail shard with no rows: one tombstoned
                # placeholder row keeps it in the mesh
                block = np.zeros((1, data.shape[1]), data.dtype)
            sub = create_instance(algo, value_type, device=mesh.devices[s])
            sub.set_parameter("DistCalcMethod",
                              "Cosine" if metric == DistCalcMethod.Cosine
                              else "L2")
            for name, value in (params or {}).items():
                sub.set_parameter(name, str(value))
            sub.build(block, keep_checkpoint=True)
            return sub
        # every shard builds on its card, shard after shard (the build
        # reads back between its stages)
        shard_indexes = mesh.map(build_shard)
        for sub in shard_indexes:
            ck = getattr(sub, "last_checkpoint", None)
            if ck is not None:
                ck.clear()
                sub.last_checkpoint = None
        if save_to is not None:
            _save_mesh(save_to, shard_indexes, n, int(data.shape[1]),
                       metric, empty_shards, metadata)
        self = cls._assemble(shard_indexes, n, int(data.shape[1]), metric,
                             mesh, empty_shards, dense)
        self.metadata = metadata
        self.build_resumed = any(getattr(sub, "build_resumed", False)
                                 for sub in shard_indexes)
        return self

    @classmethod
    def _assemble(cls, shard_indexes, n: int, dim: int,
                  metric: DistCalcMethod, mesh: Mesh, empty_shards,
                  dense: bool) -> "ShardedBKTIndex":
        """Pack built sub-indexes into the mesh geometry and place one
        engine a shard (shared by build and load)."""
        self = cls(mesh)
        self.metric = DistCalcMethod(metric)
        n_dev = mesh.size
        n_local = -(-n // n_dev)
        self.n, self.n_local, self.dim = n, n_local, dim
        self.base = shard_indexes[0].base
        self.params = shard_indexes[0].params
        m_width = max(sub._graph.shape[1] for sub in shard_indexes)
        max_p = max(len(sub._pivot_ids()) for sub in shard_indexes)
        packed = []
        for s, sub in enumerate(shard_indexes):
            p = pack_shard_block(sub, n_local, dim, m_width, max_p)
            if s in empty_shards:
                p["deleted"][:] = True
            packed.append(p)
        self.max_check = int(getattr(self.params, "max_check", 2048))
        self.nbp_limit = int(getattr(
            self.params, "no_better_propagation_limit", 3))
        self.beam_width = int(getattr(self.params, "beam_width", 16))
        self._place(packed)
        if dense:
            self._place_dense(shard_indexes)
        if int(getattr(self.params, "mesh_serve", 0) or 0):
            # index-level MeshServe=1: arm the mesh scheduler at placement
            self.enable_continuous_batching()
        return self

    def _place(self, packed: List[dict]) -> None:
        """One engine a shard on its device.  With CascadeSearch on a
        float corpus every shard walks the int8 quantization of the WHOLE
        mesh corpus (one scale, the JAX mesh's), re-ranked in float32."""
        self.dtype = packed[0]["data"].dtype
        quant = [None] * len(packed)
        self.score_scale = 0.0
        if self._cascade_ok \
                and int(getattr(self.params, "cascade_search", 0) or 0) \
                and np.issubdtype(self.dtype, np.floating):
            from sptag_tpu_torch.ops import cascade as cascade_ops

            tier = cascade_ops.normalize_tier(
                getattr(self.params, "corpus_tier", "device"))
            if tier != "device":
                raise ValueError(
                    "CorpusTier=host is a single-index engine feature; "
                    "mesh shards keep the fp corpus resident (run the "
                    "mesh cascade with CorpusTier=device)")
            int8_np, scale = cascade_ops.quantize_int8(np.concatenate(
                [np.asarray(p["data"], np.float32) for p in packed]))
            self.score_scale = cascade_ops.walk_score_scale(True, np.int8,
                                                            scale)
            quant = [(int8_np[s * self.n_local:(s + 1) * self.n_local],
                      scale) for s in range(len(packed))]
        self.engines = self.mesh.map(lambda s: _shard_engine(
            packed[s], self.metric, self.base, self.params,
            self.mesh.devices[s], quantized=quant[s]))
        # the walk engines register their own devmem components, card by
        # card; the placement's aggregate is the JAX package's
        # shard_blocks entry
        devmem.track("shard_blocks", self,
                     sum(self._engine_card_bytes().values()))

    def _engine_card_bytes(self) -> Dict[str, int]:
        cards: Dict[str, int] = {}
        for eng in self.engines:
            card = str(eng.device)
            cards[card] = cards.get(card, 0) + sum(
                eng.device_bytes().values())
        return cards

    def device_bytes(self) -> Dict[str, int]:
        """Resident bytes of this placement by card (``str(device)``):
        each card's share of the walk engines and the dense layouts."""
        cards = self._engine_card_bytes()
        for ds in self.dense_shards:
            card = str(ds["dense_perm"].device)
            cards[card] = cards.get(card, 0) + sum(
                t.nbytes for t in ds.values())
        return dict(sorted(cards.items()))

    def _place_dense(self, shard_indexes) -> None:
        """Pad every shard's dense layout to one (C, P) geometry (host-
        side, `DenseTreeSearcher.build_layout` + `pad_layout`) and place
        each on its shard's device."""
        from sptag_tpu_torch.algo.dense import DenseTreeSearcher

        host = self._dense_layouts(shard_indexes)
        C = max(h["perm"].shape[0] for h in host)
        Pb = max(h["perm"].shape[1] for h in host)
        self._place_dense_padded(
            [DenseTreeSearcher.pad_layout(h, C, Pb, self.dim)
             for h in host], C, Pb)

    def _dense_layouts(self, shard_indexes) -> List[dict]:
        """Each shard's host-side dense layout, unpadded."""
        from sptag_tpu_torch.algo.dense import DenseTreeSearcher

        def layout(s):
            sub = shard_indexes[s]
            _, clusters = sub._dense_clusters()
            return DenseTreeSearcher.build_layout(
                sub._host[:sub._n], clusters, self.metric, replicas=1,
                device="cpu")
        return self.mesh.map(layout)

    def _place_dense_padded(self, padded: List[dict], C: int, Pb: int):
        def place(s):
            lay, dev = padded[s], self.mesh.devices[s]

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            shard = {name: put(lay[name]) for name in (
                "dense_perm", "dense_ids", "dense_sq", "dense_cent",
                "dense_cent_sq", "dense_cent_valid")}
            shard["deleted"] = self.engines[s].deleted.clone() \
                if self.engines else put(np.zeros(self.n_local, bool))
            return shard
        self.dense_shards = self.mesh.map(place)
        self.dense_cluster_size = Pb
        self.dense_num_clusters = C
        # a second mesh-resident corpus copy: its own ledger component
        cards: Dict[str, int] = {}
        for shard in self.dense_shards:
            card = str(shard["dense_perm"].device)
            cards[card] = cards.get(card, 0) + sum(
                t.nbytes for t in shard.values())
        devmem.track("dense_blocks", self, sum(cards.values()), cards=cards)

    # ---- dense ---------------------------------------------------------------

    def search_dense(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     normalized: bool = False,
                     budget_policy: Optional[str] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense mode over the mesh: every shard probes the top blocks of
        its own partition (``probe_block_dots`` on the card) and the
        shards merge.  Needs `build(..., dense=True)`.  `budget_policy`
        splits MaxCheck (each shard's nprobe) like `search`."""
        if not self.dense_shards:
            raise RuntimeError(
                "dense layout not packed — build with dense=True")
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == DistCalcMethod.Cosine and not normalized:
            queries = dist_ops.normalize(queries, self.base)
        max_check = max_check if max_check is not None else self.max_check
        policy = budget_policy or self.budget_policy
        if policy not in ("full", "proportional", "guarded"):
            raise ValueError(f"unknown budget policy {policy!r}")
        k_local_cap = min(k, self.n_local)
        mc_shard = self._resolve_budget(
            queries, k, max_check, k_local_cap, policy,
            lambda qs, mc: self._search_dense_raw(qs, k, mc),
            mode="dense")
        if policy != "full":
            # never below 2 probes a shard: one probe has no second-best
            # block to rescue boundary rows
            mc_shard = min(max_check,
                           max(mc_shard, 2 * self.dense_cluster_size))
        return self._search_dense_raw(queries, k, mc_shard)

    def _search_dense_raw(self, queries: np.ndarray, k: int,
                          max_check: int) -> Tuple[np.ndarray, np.ndarray]:
        from sptag_tpu_torch.algo.dense import _dense_search_kernel

        nprobe = int(np.clip(-(-max_check // self.dense_cluster_size), 1,
                             self.dense_num_clusters))
        n_dev = self.n_shards
        k_local = min(self._merge_k_local(k),
                      nprobe * self.dense_cluster_size)
        k_final = min(k, self.n, k_local * n_dev)
        bins = topk_bins.resolve_bins(
            self._binned_mode(), k_local, nprobe * self.dense_cluster_size,
            self._recall_target())
        qn = np.ascontiguousarray(queries)
        out_d, out_i = [], []
        for lo in range(0, qn.shape[0], _DENSE_CHUNK):
            def scan(s, lo=lo):
                ds = self.dense_shards[s]
                q = torch.from_numpy(qn[lo:lo + _DENSE_CHUNK]).to(
                    ds["dense_perm"].device)
                # dedup off: shards are packed replica-free
                d, ids = _dense_search_kernel(
                    ds["dense_perm"], ds["dense_ids"], ds["dense_sq"],
                    ds["dense_cent"], ds["dense_cent_sq"], ds["deleted"], q,
                    k_local, nprobe, int(self.metric), self.base, False,
                    bins, cent_valid=ds["dense_cent_valid"])
                return d, _global_ids(ids, self._shard_base + s,
                                      self.n_local)
            # every shard scans on its card before anything is read back
            parts = self.mesh.map(scan)
            d, ids = self._merge(parts, k_final)
            d, ids = recompile_guard.device_get((d, ids))
            out_d.append(d)
            out_i.append(ids)
        return _pad_to_k(np.concatenate(out_d), np.concatenate(out_i), k,
                         k_final)

    # ---- per-shard budget policy ------------------------------------------

    def set_budget_policy(self, policy: str,
                          guard_overlap: Optional[float] = None) -> None:
        """"full" | "proportional" | "guarded"; a change clears the guarded
        calibration cache."""
        if policy not in ("full", "proportional", "guarded"):
            raise ValueError(f"unknown budget policy {policy!r}")
        self.budget_policy = policy
        if guard_overlap is not None:
            self.budget_guard_overlap = float(guard_overlap)
        self._guarded_cache.clear()

    def _proportional_budget(self, max_check: int, k_local: int,
                             mult: int = 1) -> int:
        """ceil(MaxCheck / n_dev) * mult, floored at max(4 k_local, 64),
        capped at the full budget."""
        mc = -(-max_check // self.n_shards) * mult
        return int(min(max_check, max(mc, 4 * k_local, 64)))

    def _resolve_budget(self, queries: np.ndarray, k: int, max_check: int,
                        k_local: int, policy: str, search_at,
                        mode: str = "beam") -> int:
        """Per-shard budget under the policy; "guarded" calibrates once
        per (mode, max_check, k) on a sample of the live batch."""
        if policy == "full" or self.n_shards == 1:
            return max_check
        if policy == "proportional":
            return self._proportional_budget(max_check, k_local)
        key = (mode, int(max_check), int(k))
        hit = self._guarded_cache.get(key)
        if hit is not None:
            return hit
        sample = queries[:min(32, len(queries))]
        _, ids_full = search_at(sample, max_check)
        mult = 1
        while True:
            mc = self._proportional_budget(max_check, k_local, mult)
            if mc >= max_check:
                self._guarded_cache[key] = max_check
                return max_check
            _, ids_m = search_at(sample, mc)
            overlaps = []
            for i in range(len(sample)):
                full = set(int(v) for v in ids_full[i] if v >= 0)
                got = set(int(v) for v in ids_m[i] if v >= 0)
                overlaps.append(len(got & full) / max(1, len(full)))
            if float(np.mean(overlaps)) >= self.budget_guard_overlap:
                self._guarded_cache[key] = mc
                return mc
            mult *= 2

    # ---- beam ----------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int = 10,
               max_check: Optional[int] = None,
               beam_width: Optional[int] = None,
               pool_size: Optional[int] = None,
               normalized: bool = False,
               budget_policy: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched mesh beam search; the single engine's knobs applied a
        shard.  `max_check` / `beam_width` default to the build params;
        `budget_policy` overrides the index policy for this call."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if not int(getattr(self.params, "build_graph", 1)):
            raise RuntimeError(
                "mesh beam search needs the RNG graph, but the shards were "
                "built with BuildGraph=0 (dense-only); use search_dense or "
                "rebuild with BuildGraph=1")
        if self.metric == DistCalcMethod.Cosine and not normalized:
            queries = dist_ops.normalize(queries, self.base)
        max_check = max_check if max_check is not None else self.max_check
        beam_width = (beam_width if beam_width is not None
                      else self.beam_width)
        k_local = min(k, self.n_local)
        policy = budget_policy or self.budget_policy
        if policy not in ("full", "proportional", "guarded"):
            raise ValueError(f"unknown budget policy {policy!r}")
        mc_shard = self._resolve_budget(
            queries, k, max_check, k_local, policy,
            lambda qs, mc: self._search_raw(qs, k, mc, beam_width,
                                            pool_size))
        return self._search_raw(queries, k, mc_shard, beam_width,
                                pool_size)

    def _binned_mode(self) -> str:
        return topk_bins.normalize_mode(
            getattr(self.params, "binned_topk", "off"))

    def _recall_target(self) -> float:
        return topk_bins.validate_recall_target(
            getattr(self.params, "approx_recall_target", 0.99))

    def _merge_k_local(self, k: int) -> int:
        """Each shard's share of the merge: min(k, n_local), capped by
        `MeshKLocal` (a shard holding more of the true top-k than the cap
        drops the excess; 0 = off, the exact merge)."""
        cap = int(getattr(self.params, "mesh_k_local", 0) or 0)
        k_local = min(k, self.n_local)
        return min(k_local, cap) if cap > 0 else k_local

    def _search_raw(self, queries: np.ndarray, k: int, max_check: int,
                    beam_width: int, pool_size: Optional[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Every shard walks with its engine at the shard plan (the
        engine's walk_plan at n_local rows is the JAX mesh's plan: the
        same pool, width, budget and limit), each on its card, its results
        left there; then the shards merge."""
        k_local = self._merge_k_local(k)
        k_final = min(k, self.n, k_local * self.n_shards)

        def walk(s):
            d, ids = self.engines[s].search_tensors(
                queries, k_local, max_check, beam_width, pool_size,
                self.nbp_limit)
            return d, _global_ids(ids, self._shard_base + s, self.n_local)
        parts = self.mesh.map(walk)
        d, ids = self._merge(parts, k_final)
        return _pad_to_k(*recompile_guard.device_get((d, ids)), k, k_final)

    def _merge(self, parts, k_final: int):
        """The global merge of this placement's shard candidates (a
        multi-process mesh first gathers every process's, multihost.py)."""
        return _gather_merge(parts, k_final, self.mesh.devices[0])


def _save_mesh(save_to: str, shard_indexes, n: int, dim: int,
               metric: DistCalcMethod, empty_shards, metadata) -> None:
    """Write every shard's folder, then the metadata, then the manifest
    (the commit point: everything it vouches for is durable first)."""
    save_shards(save_to, shard_indexes)
    write_manifest(save_to, len(shard_indexes), n, dim, metric,
                   empty_shards, metadata)


def save_shards(save_to: str, shard_indexes, first: int = 0) -> None:
    """Each sub-index as ``shard_NNN`` (from shard `first` on) under
    `save_to`."""
    os.makedirs(save_to, exist_ok=True)
    for s, sub in enumerate(shard_indexes):
        sub.save_index(os.path.join(save_to, f"shard_{first + s:03d}"))


def write_manifest(save_to: str, n_shards: int, n: int, dim: int,
                   metric: DistCalcMethod, empty_shards, metadata=None
                   ) -> None:
    """The metadata, then ``sharded.json``: the commit point of a mesh
    folder, written once every shard folder is durable."""
    manifest = os.path.join(save_to, "sharded.json")
    tmp = manifest + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"n_shards": n_shards, "n": n, "dim": dim,
                   "metric": int(metric), "empty_shards": empty_shards}, f)
    mpath = os.path.join(save_to, "metadata.bin")
    ipath = os.path.join(save_to, "metadataIndex.bin")
    if metadata is not None:
        metadata.save(mpath + f".tmp.{os.getpid()}",
                      ipath + f".tmp.{os.getpid()}")
        os.replace(mpath + f".tmp.{os.getpid()}", mpath)
        os.replace(ipath + f".tmp.{os.getpid()}", ipath)
    else:
        for p in (mpath, ipath):
            try:
                os.remove(p)
            except OSError:
                pass
    os.replace(tmp, manifest)


# The JAX package compiles one program a mesh path; the port runs the
# same work as per-shard calls and one merge, bound here to the method
# doing it.
costmodel.register("sharded.flat_scan", ShardedFlatIndex.search,
                   _sharded_flat_cost)
costmodel.register("sharded.beam_walk", ShardedBKTIndex._search_raw,
                   _sharded_beam_cost)
costmodel.register("sharded.dense_scan", ShardedBKTIndex._search_dense_raw,
                   _sharded_dense_cost)
