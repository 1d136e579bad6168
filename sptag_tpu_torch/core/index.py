"""VectorIndex — the public API of the port (``sptag_tpu/core/index.py``).

build / search / search_batch / save_index / load_index / create_instance
and the mutation surface (add / delete / delete_by_metadata / refine_index /
merge_index) with the JAX package's semantics and folder format.  Every
index lives on a torch device: ``None`` means the CUDA card (device.py),
and the tests pass ``device="cpu"``.

Mutation follows the JAX package's single-writer design: writers hold the
index lock, readers pin immutable device snapshots by one local reference.
With ``WalEnabled=1`` every acked add/delete is logged (io/wal.py) before
it applies, and ``load_index`` replays the log.  With
``DeltaShardCapacity`` set, added rows land in an exactly scanned side
index (core/delta.py) merged into every search until a refine absorbs
them.  The host half of the JAX package's observability rides along:
the ``mutation.*`` metrics, the lock sanitizer (the writer lock is a
``SanLock`` and the class is ``race_track``ed when armed), the storage
crash points of ``save_index``, the live-applied quality-monitor and
timeline knobs, and `publish_quality_health`.  The device-memory ledger
(``utils/devmem.py``) holds the card arrays of an index's snapshots (the
walk engine, the dense layout, FLAT's corpus, the cascade's tiers, the
delta shard, the scheduler's slot pool) under the JAX package's
component names.

Every index also serializes to memory buffers (`save_index_blobs`,
`load_index_blobs`), hands out per-query futures (`submit_batch`) and
estimates its host and card memory (`estimated_*`).
"""

from __future__ import annotations

import abc
import errno
import io
import logging
import os
import shutil
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch

from sptag_tpu_torch.core.params import ParamSet
from sptag_tpu_torch.core.types import (
    DistCalcMethod,
    ErrorCode,
    IndexAlgoType,
    VectorValueType,
    base_of,
    convert_to_string,
    dtype_of,
    enum_from_string,
)
from sptag_tpu_torch.core.vectorset import (FileMetadataSet, MetadataSet,
                                            VectorSet, metas_for)
from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.io import atomic, wal
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.utils import devmem, faultinject, locksan, metrics, trace
from sptag_tpu_torch.utils.ini import IniReader

log = logging.getLogger(__name__)

# float32-exact padding distance of every result
MAX_DIST = float(np.float32(3.4e38))

# distance at or below which a searched vector counts as the same vector
# for delete-by-content (SPTAG BKTIndex.cpp:439-453 uses 1e-6)
DELETE_EPS = 1e-6
# pre-filter of delete's exact recheck: wide enough to admit a true
# duplicate's expanded-form float32 residue at realistic norms
_NEAR_EPS = 1e-2


@dataclass
class SearchResult:
    """One query's results."""

    ids: np.ndarray                  # (K,) int32, -1 padded
    dists: np.ndarray                # (K,) float32, 3.4e38 padded
    metas: Optional[List[bytes]] = None

    def __len__(self) -> int:
        return len(self.ids)


def resolved_futures(search_batch, nrows: int) -> List[Future]:
    """Run `search_batch()` once for a whole block and hand back one
    resolved future per row; a failure resolves every row's future with
    the exception, the error contract of the scheduler's futures."""
    futs: List[Future] = []
    try:
        dists, ids = search_batch()
    except Exception as e:                               # noqa: BLE001
        for _ in range(nrows):
            f: Future = Future()
            f.set_exception(e)
            futs.append(f)
        return futs
    for row in range(ids.shape[0]):
        f = Future()
        f.set_result((dists[row], ids[row]))
        futs.append(f)
    return futs


_REGISTRY: Dict[IndexAlgoType, Type["VectorIndex"]] = {}


def register_algo(cls: Type["VectorIndex"]) -> Type["VectorIndex"]:
    _REGISTRY[cls.algo] = cls
    return cls


def create_instance(algo: Union[IndexAlgoType, str],
                    value_type: Union[VectorValueType, str],
                    device: DeviceLike = None) -> "VectorIndex":
    """An empty index on `device` (None: the CUDA card, or RuntimeError)."""
    if isinstance(algo, str):
        algo = enum_from_string(IndexAlgoType, algo)
    if isinstance(value_type, str):
        value_type = enum_from_string(VectorValueType, value_type)
    algo = IndexAlgoType(algo)
    cls = _REGISTRY.get(algo)
    if cls is None:
        raise ValueError(f"no index algorithm registered for {algo}")
    return cls(value_type, resolve_device(device))


@locksan.race_track
class VectorIndex(abc.ABC):
    algo: IndexAlgoType = IndexAlgoType.Undefined

    def __init__(self, value_type: VectorValueType, device: torch.device):
        self.value_type = VectorValueType(value_type)
        self.device = device
        self.params: ParamSet = self._make_params()
        self.metadata: Optional[MetadataSet] = None
        self._meta_to_vec: Optional[Dict[bytes, int]] = None
        # the single-writer mutation lock (sanitized under SPTAG_LOCKSAN)
        self._lock = locksan.make_rlock("VectorIndex._lock")
        self._meta_file = "metadata.bin"
        self._meta_index_file = "metadataIndex.bin"
        # the WAL writer, armed by load_index and by a save with
        # WalEnabled=1; _wal_replaying keeps replayed records unlogged
        self._wal: Optional[wal.WalWriter] = None
        self._wal_folder: Optional[str] = None
        self._wal_replaying = False
        self._acked_writes = 0
        # the delta shard (core/delta.py); None until an add routes to it
        self._delta = None
        # snapshot handoff: readers pin a snapshot by local reference,
        # every publish bumps the epoch
        self._snapshot_epoch = 0
        self._swap_count = 0
        self._refine_in_flight = False
        # (start_ms, end_ms) monotonic windows of recent swaps; a tuple
        # replaced whole, never mutated, so readers iterate it unlocked
        self._swap_windows: tuple = ()

    # ---- subclass surface -------------------------------------------------

    @abc.abstractmethod
    def _make_params(self) -> ParamSet: ...

    @abc.abstractmethod
    def _build(self, data: np.ndarray, checkpoint=None) -> None:
        """Build the index over `data` (already normalized for cosine).

        `checkpoint` (utils/build_ckpt.BuildCheckpoint or None): stage
        store of a resumable build; multi-stage builds load completed
        stages from it and save each stage as it finishes, exact
        (single-stage) indexes ignore it."""

    @abc.abstractmethod
    def _search_batch(self, queries: np.ndarray, k: int,
                      max_check: Optional[int] = None,
                      search_mode: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Prepared (Q, D) queries -> ((Q, K) dists, (Q, K) int32 ids),
        ascending, -1 / 3.4e38 padded, deleted rows excluded."""

    @abc.abstractmethod
    def _add(self, data: np.ndarray) -> int:
        """Append prepared rows, linked into the search structures;
        returns the first new id."""

    @abc.abstractmethod
    def _delete_id(self, vid: int) -> bool:
        """Tombstone one id; False if it was deleted already."""

    @property
    @abc.abstractmethod
    def num_samples(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_deleted(self) -> int: ...

    @property
    @abc.abstractmethod
    def feature_dim(self) -> int: ...

    @abc.abstractmethod
    def contains_sample(self, vid: int) -> bool: ...

    @abc.abstractmethod
    def get_sample(self, vid: int) -> np.ndarray:
        """The stored (prepared) row `vid`, on the host."""

    def _refine_impl(self) -> None:
        """Compact the deleted rows away; the families override."""
        raise NotImplementedError

    # ---- parameters -------------------------------------------------------

    @property
    def dist_calc_method(self) -> DistCalcMethod:
        return DistCalcMethod(getattr(self.params, "dist_calc_method",
                                      DistCalcMethod.L2))

    @property
    def base(self) -> int:
        return base_of(self.value_type)

    # quality-monitor knobs (utils/qualmon.py): process-wide, applied at
    # set_parameter time for every index family; each maps to its own
    # configure field so setting one never clobbers the others
    _QUALITY_PARAMS = frozenset({"qualitysamplerate", "qualityrecallfloor",
                                 "qualityshadowbudget", "qualitywindow"})

    def set_parameter(self, name: str, value: str) -> bool:
        ok = self.params.set_param(name, value)
        low = name.lower()
        if ok and low == "devicebytesledger":
            # process-wide device-memory ledger flag (utils/devmem.py),
            # applied at once for every index family
            enabled = bool(int(getattr(self.params,
                                       "device_bytes_ledger", 1)))
            devmem.configure(enabled=enabled)
            if enabled:
                # re-enabled on a warm index: disabling dropped every
                # entry, so re-register the live ones (slot pools re-track
                # at their next resize)
                self._retrack_devmem()
        if ok and low in ("timelineintervalms", "timelineevents"):
            # serving timeline (utils/timeline.py): process-wide;
            # interval > 0 arms and starts the sampler, 0 stops it; the
            # events knob resizes the per-series rings
            from sptag_tpu_torch.utils import timeline

            if low == "timelineintervalms":
                interval = float(getattr(self.params,
                                         "timeline_interval_ms", 0.0))
                if interval > 0:
                    timeline.configure(enabled=True, interval_ms=interval)
                    timeline.start()
                else:
                    timeline.configure(enabled=False)
                    timeline.stop()
            else:
                timeline.configure(
                    capacity=int(getattr(self.params, "timeline_events",
                                         0)) or None)
        if ok and low in self._QUALITY_PARAMS:
            from sptag_tpu_torch.utils import qualmon

            p = self.params
            qualmon.configure(
                sample_rate=(float(getattr(p, "quality_sample_rate", 0.0))
                             if low == "qualitysamplerate" else None),
                recall_floor=(float(getattr(p, "quality_recall_floor", 0.0))
                              if low == "qualityrecallfloor" else None),
                shadow_budget_gflops=(
                    float(getattr(p, "quality_shadow_budget", 0.0))
                    if low == "qualityshadowbudget" else None),
                window=(int(getattr(p, "quality_window", 0))
                        if low == "qualitywindow" else None))
        return ok

    def _retrack_devmem(self) -> None:
        """Re-register this index's live device allocations with the
        memory ledger (subclass hook, called when DeviceBytesLedger is
        re-enabled).  Default: nothing tracked."""

    def get_parameter(self, name: str) -> Optional[str]:
        return self.params.get_param(name)

    def _prepare_vectors(self, vectors) -> np.ndarray:
        if isinstance(vectors, VectorSet):
            if vectors.value_type != self.value_type:
                raise ValueError("VectorSet value type mismatch")
            data = vectors.data
        else:
            data = np.asarray(vectors)
            if data.ndim == 1:
                data = data[None, :]
            data = data.astype(dtype_of(self.value_type), copy=False)
        if self.dist_calc_method == DistCalcMethod.Cosine:
            data = dist_ops.normalize(data, self.base)
        return np.ascontiguousarray(data)

    def _prepare_query(self, queries: np.ndarray) -> np.ndarray:
        queries = queries.astype(dtype_of(self.value_type), copy=False)
        if self.dist_calc_method == DistCalcMethod.Cosine:
            queries = dist_ops.normalize(queries, self.base)
        return np.ascontiguousarray(queries)

    # ---- build / search ---------------------------------------------------

    def build(self, vectors, metadata: Optional[MetadataSet] = None,
              with_meta_index: bool = False,
              checkpoint_dir: Optional[str] = None,
              keep_checkpoint: bool = False) -> ErrorCode:
        """Build over `vectors`.

        `checkpoint_dir` (or env ``SPTAG_TPU_BUILD_CKPT``) makes the build
        RESUMABLE: each completed stage (tree, TPT candidate merge,
        non-final refine pass) is checkpointed there, and a re-run over
        the same data + params resumes at the first incomplete stage.  The
        checkpoint is fingerprint-bound (utils/build_ckpt.py, the JAX
        package's fingerprint) and removed on success unless
        `keep_checkpoint`, which leaves the clear to the caller through
        `last_checkpoint`.  `build_resumed` says whether any stage came
        from disk."""
        data = self._prepare_vectors(vectors)
        if data.size == 0:
            return ErrorCode.EmptyData
        if checkpoint_dir is None:
            checkpoint_dir = os.environ.get("SPTAG_TPU_BUILD_CKPT") or None
        ck = None
        if checkpoint_dir:
            from sptag_tpu_torch.utils.build_ckpt import (BuildCheckpoint,
                                                          build_fingerprint)
            config = (f"{type(self).__name__}:{int(self.value_type)}:"
                      f"{sorted(self.params.__dict__.items())!r}")
            ck = BuildCheckpoint(checkpoint_dir,
                                 build_fingerprint(data, config))
        with self._lock:
            self._build(data, checkpoint=ck)
            self._reset_delta()
            self.metadata = metadata
            if with_meta_index and metadata is not None:
                self.build_meta_mapping()
            # flag + clear inside the lock: two concurrent builds must not
            # interleave one's clear() with the other's stage writes
            self.build_resumed = ck is not None and ck.resumed
            self.last_checkpoint = ck
            if ck is not None and not keep_checkpoint:
                ck.clear()
                self.last_checkpoint = None
        # index health at every structural mutation: one flag test when
        # the monitor is off; the O(n) sweep runs on its worker
        self.publish_quality_health(background=True)
        return ErrorCode.Success

    def build_meta_mapping(self) -> None:
        assert self.metadata is not None
        self._meta_to_vec = {
            self.metadata.get_metadata(i): i
            for i in range(self.metadata.count) if self.contains_sample(i)}

    def search(self, query, k: int = 10, with_metadata: bool = False,
               max_check: Optional[int] = None,
               search_mode: Optional[str] = None) -> SearchResult:
        dists, ids = self.search_batch(np.asarray(query)[None, :], k,
                                       max_check=max_check,
                                       search_mode=search_mode)
        metas = metas_for(self.metadata, ids[0]) if with_metadata else None
        return SearchResult(ids[0], dists[0], metas)

    def search_batch(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     search_mode: Optional[str] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) host queries -> ((Q, k) float32 dists, (Q, k) int32 ids)
        as numpy.  `max_check` / `search_mode` override MaxCheck /
        SearchMode for this call only.

        The front end's phases are spans (utils/trace.py): ``search.call``
        all of it, ``search.prepare`` the cast, cosine normalisation and
        contiguity; the graph indexes mark ``search.dispatch``,
        ``search.wait`` and ``search.readback`` inside their search
        (algo/bkt.py), and the delta merge is a ``search.readback`` of its
        own."""
        with trace.span("search.call"):
            with trace.span("search.prepare"):
                queries = np.asarray(queries)
                if queries.ndim == 1:
                    queries = queries[None, :]
                if queries.shape[1] != self.feature_dim:
                    raise ValueError(
                        f"query dim {queries.shape[1]} != index dim "
                        f"{self.feature_dim}")
                queries = self._prepare_query(queries)
            # the main tier covers its frozen snapshot, fresh rows the
            # delta shard: the two top-k lists merge here
            return self._merge_delta(
                queries, k, lambda: self._search_batch(queries, k, max_check,
                                                       search_mode))

    def submit_batch(self, queries: np.ndarray, k: int = 10,
                     max_check: Optional[int] = None,
                     search_mode: Optional[str] = None,
                     rids: Optional[List[str]] = None) -> List[Future]:
        """Per-query futures over a (Q, D) block, each resolving to
        `(dists (k,), ids (k,))` with search_batch's padding: the
        streaming surface of the serving layer.  Here the whole batch runs
        at once and the futures come back resolved; the graph indexes with
        ContinuousBatching=1 resolve them as queries retire from the slot
        scheduler.  `rids` (one request id per query) only tags
        scheduler-backed queries."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        return resolved_futures(
            lambda: self.search_batch(queries, k, max_check=max_check,
                                      search_mode=search_mode),
            queries.shape[0])

    def _exact_scan(self, queries: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact masked scan over this index's corpus (queries already
        prepared): the hook behind `exact_search_batch`."""
        raise NotImplementedError(
            f"{type(self).__name__} has no exact-scan oracle")

    def exact_search_batch(self, queries: np.ndarray, k: int = 10
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the live corpus with search_batch's contract
        ((Q, k) dists / ids, MAX_DIST / -1 padded, deleted rows excluded),
        whatever the search mode or approximation knobs."""
        if self.num_samples == 0:
            raise RuntimeError("index is empty")
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.feature_dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim "
                f"{self.feature_dim}")
        queries = self._prepare_query(queries)
        k_eff = min(k, self.num_samples)
        # both tiers are exact: an oracle blind to just-acked rows would
        # score the serving path against a stale truth
        dists, ids = self._merge_delta(
            queries, k_eff, lambda: self._exact_scan(queries, k_eff))
        return pad_results(dists, ids, k)

    # ---- quality health (utils/qualmon.py) --------------------------------

    def publish_quality_health(self, shard: Optional[str] = None,
                               background: bool = False) -> None:
        """Publish this index's health to the quality monitor: sample
        count and deleted fraction (the graph indexes add degree,
        reciprocity and reachability through `_health_payload`).  `shard`
        names the series (a server passes its index name and the label
        sticks for later republishes).  A no-op with the monitor off;
        never raises.  `background=True` (the mutation paths) runs the
        O(n) sweep on the monitor's worker, debounced: one pending job
        at a time, reading the index state when it runs."""
        from sptag_tpu_torch.utils import qualmon

        if shard is not None:
            self._quality_shard = str(shard)
        if not qualmon.enabled():
            return
        label = getattr(self, "_quality_shard",
                        type(self).__name__.lower())
        if background:
            if getattr(self, "_health_job_pending", False):
                return
            self._health_job_pending = True

            def job():
                # the label is read when the job runs, like the state
                try:
                    self._publish_health_now(
                        getattr(self, "_quality_shard",
                                type(self).__name__.lower()))
                finally:
                    self._health_job_pending = False
            if not qualmon.submit(job):
                self._health_job_pending = False
            return
        self._publish_health_now(label)

    def _publish_health_now(self, label: str) -> None:
        from sptag_tpu_torch.utils import qualmon

        try:
            n = self.num_samples
            payload = {"samples": int(n), "deleted": int(self.num_deleted)}
            qualmon.gauge("index.samples", n, shard=label)
            qualmon.gauge("index.deleted_fraction",
                          (self.num_deleted / n) if n else 0.0,
                          shard=label)
            extra = self._health_payload()
            if extra:
                payload.update(extra)
            qualmon.note_health(label, **payload)
        except Exception:                                # noqa: BLE001
            qualmon.inc("health_errors")
            log.exception("quality health publish failed")

    def _health_payload(self) -> Optional[dict]:
        """Family-specific health extras (the graph indexes override)."""
        return None

    # ---- mutation ---------------------------------------------------------

    def add(self, vectors, metadata: Optional[MetadataSet] = None,
            with_meta_index: bool = False) -> ErrorCode:
        """Append rows (SPTAG AddIndex, with BKT's dedupe by metadata).
        With the WAL armed the record is appended, and fsync'd with
        ``WalFsync=1``, before the rows apply; with ``DeltaShardCapacity``
        the rows land in the delta shard, searchable at once."""
        data = self._prepare_vectors(vectors)
        if data.size == 0:
            return ErrorCode.EmptyData
        metas = ([metadata.get_metadata(i) for i in range(data.shape[0])]
                 if metadata is not None else None)
        with self._lock:
            # log before apply: a failed append leaves the index as it
            # was; an apply that raises after a durable append leaves the
            # write's outcome to the replay (the usual WAL contract).
            # Every add path appends, so `begin` is the tail
            begin = self.num_samples
            self._wal_log(wal.pack_add(begin, data, metas))
            applied = self._apply_add(data, metas, with_meta_index)
            assert applied == begin, (applied, begin)
        self.publish_quality_health(background=True)
        self._maybe_auto_refine()
        return ErrorCode.Success

    def _apply_add(self, data: np.ndarray, metas: Optional[List[bytes]],
                   with_meta_index: bool) -> int:
        """The add's effect, shared by the live path and the WAL replay
        (lock held, `data` prepared); returns the first row's id."""
        if self.num_samples == 0:
            # the first add is a build (data already prepared)
            self._build(data)
            self._reset_delta()
            self.metadata = (MetadataSet(metas) if metas is not None
                             else None)
            if with_meta_index and self.metadata is not None:
                self.build_meta_mapping()
            return 0
        begin = self._route_add(data)
        if metas is not None:
            if self.metadata is None:
                self.metadata = MetadataSet([b""] * begin)
            for i in range(data.shape[0]):
                meta = metas[i]
                self.metadata.add(meta)
                if self._meta_to_vec is not None and meta:
                    old = self._meta_to_vec.get(meta)
                    if old is not None:
                        self._delete_id(old)
                    self._meta_to_vec[meta] = begin + i
        elif self.metadata is not None:
            for _ in range(data.shape[0]):
                self.metadata.add(b"")
        if with_meta_index and self.metadata is not None \
                and self._meta_to_vec is None:
            self.build_meta_mapping()
        return begin

    def _route_add(self, data: np.ndarray) -> int:
        """Where appended rows go (lock held): the delta shard when it is
        enabled and the batch fits, the family's linked `_add` otherwise.
        The delta is always the tail of the id space, so a fallback to
        `_add` absorbs it first."""
        cap = int(getattr(self.params, "delta_shard_capacity", 0) or 0)
        if cap > 0:
            if data.shape[0] > cap:
                # a bulk load the shard can never hold: fold the pending
                # delta, then take the linked path
                self._absorb_delta_locked()
            else:
                if self._delta is not None and \
                        self._delta.count + data.shape[0] > \
                        self._delta.capacity:
                    self._absorb_delta_locked()
                begin = self._delta_append(data, cap)
                if begin is not None:
                    return begin
        elif self._delta is not None:
            # the knob was turned off with rows still resident
            self._absorb_delta_locked()
        return self._add(data)

    def _delta_append(self, data: np.ndarray, cap: int) -> Optional[int]:
        """Append `data` to the delta shard (created at the current tail
        when absent); None when the family has no unlinked append."""
        from sptag_tpu_torch.core.delta import DeltaShard

        begin = self._append_rows_unlinked(data)
        if begin is None:
            return None
        if self._delta is None:
            self._delta = DeltaShard(begin, data.shape[1], data.dtype, cap,
                                     int(self.dist_calc_method), self.base,
                                     self.device)
        self._delta.append(data, begin)
        metrics.set_gauge("mutation.delta_rows", self._delta.count)
        return begin

    # ---- delta-shard hooks ------------------------------------------------

    def _append_rows_unlinked(self, data: np.ndarray) -> Optional[int]:
        """Append rows to the family's storage without linking them or
        invalidating its snapshots (the delta shard serves them); the
        first new id, or None when the family has no such path."""
        return None

    def _tombstone_mask(self) -> Optional[np.ndarray]:
        """The (num_samples,) tombstone mask the delta scan reads."""
        return None

    def _absorb_delta_impl(self, begin: int, count: int) -> None:
        """Fold rows [begin, begin + count), served by the delta shard,
        into the main structures (lock held)."""
        raise NotImplementedError

    def _absorb_delta_locked(self) -> None:
        """Absorb and drop the delta shard (lock held); a no-op without
        one.  Every path that appends through `_add`, remaps ids or saves
        calls it first."""
        d = self._delta
        if d is None:
            return
        self._delta = None
        if d.count:
            self._absorb_delta_impl(d.base_id, d.count)
        devmem.untrack(d)

    def _reset_delta(self) -> None:
        """Discard the delta (build or load replaced the corpus)."""
        if self._delta is not None:
            devmem.untrack(self._delta)
        self._delta = None

    def _main_rows(self) -> int:
        """Rows the main search structures cover: everything below the
        delta shard's base; snapshot builds size themselves by it."""
        d = self._delta
        return d.base_id if (d is not None and d.count) else \
            self.num_samples

    def _merge_delta(self, queries: np.ndarray, k: int,
                     main_search: Callable[[], Tuple[np.ndarray, np.ndarray]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Union the main tier's top-k (`main_search()`) with the delta
        scan's (queries prepared).  One local reference pins the shard
        BEFORE the main tier is searched: a swap that absorbs the shard
        in between leaves its rows in the pinned shard, or in both tiers
        (merge_topk dedupes a row seen twice), never in neither."""
        d = self._delta
        main = main_search()
        if d is None or not d.count:
            return main
        from sptag_tpu_torch.core.delta import merge_topk

        with trace.span("search.readback"):
            dd, di = d.search(queries, min(k, d.count),
                              self._tombstone_mask())
            return merge_topk(main[0], main[1], dd, di, k)

    def _maybe_auto_refine(self) -> None:
        """Schedule an absorb once the delta reaches AutoRefineThreshold."""
        thr = int(getattr(self.params, "auto_refine_threshold", 0) or 0)
        d = self._delta
        if thr <= 0 or d is None or d.count < thr:
            return
        self._schedule_auto_refine()

    def _schedule_auto_refine(self) -> None:
        """The base absorbs inline; the graph indexes run it in the
        background and swap."""
        with self._lock:
            self._absorb_delta_locked()

    def mutation_state(self) -> Dict[str, object]:
        """Swap and durability state: epoch, WAL, delta occupancy, swaps
        and their recent windows."""
        d = self._delta
        return {
            "epoch": self._snapshot_epoch,
            "wal": self._wal is not None,
            "wal_folder": self._wal_folder or "",
            "acked_writes": self._acked_writes,
            "delta_rows": int(d.count) if d is not None else 0,
            "delta_capacity": int(getattr(self.params,
                                          "delta_shard_capacity", 0) or 0),
            "swap_count": self._swap_count,
            "refine_in_flight": self._refine_in_flight,
            "swap_windows_ms": [list(w) for w in self._swap_windows],
        }

    # ---- write-ahead log --------------------------------------------------

    def _wal_log(self, payload: bytes) -> None:
        """Append one record (lock held).  If this raises, the mutation
        was not acked."""
        if self._wal is None or self._wal_replaying:
            return
        self._wal.append(payload)
        self._acked_writes += 1
        metrics.inc("mutation.wal_appends")

    def _arm_wal(self, folder: str) -> None:
        """(Re)open the WAL writer at `folder`: after a load, and after
        every save (the publish moved the log)."""
        if self._wal is not None:
            self._wal.close()
        self._wal = wal.WalWriter(
            os.path.join(folder, wal.WAL_NAME),
            sync=bool(int(getattr(self.params, "wal_fsync", 1) or 0)))
        self._wal_folder = folder

    def _replay_wal(self, folder: str) -> None:
        """Re-apply the folder's log over the loaded snapshot.  Torn tails
        truncate; records the snapshot already holds are skipped by their
        `begin`; deletes are idempotent; replay stops at the first record
        that fails to apply and serves the prefix."""
        path = os.path.join(folder, wal.WAL_NAME)
        records, torn = wal.replay(path)
        if torn:
            metrics.inc("mutation.wal_torn_tails")
        if not records:
            return
        applied = 0
        with self._lock:
            self._wal_replaying = True
            try:
                for rec in records:
                    try:
                        if isinstance(rec, wal.WalAdd):
                            n = self.num_samples
                            if rec.begin + rec.rows.shape[0] <= n:
                                continue      # folded into the snapshot
                            skip = max(0, n - rec.begin)
                            rows = rec.rows[skip:]
                            metas = (rec.metas[skip:]
                                     if rec.metas is not None else None)
                            self._apply_add(np.ascontiguousarray(rows),
                                            metas, False)
                        else:
                            for vid in rec.vids:
                                if 0 <= vid < self.num_samples:
                                    self._delete_id(int(vid))
                        applied += 1
                    except Exception:                    # noqa: BLE001
                        metrics.inc("mutation.wal_replay_errors")
                        # later records may depend on the failed one:
                        # serve the durable prefix, loudly
                        log.exception(
                            "WAL replay: record %d failed to apply; "
                            "serving the snapshot + %d replayed "
                            "record(s)", applied, applied)
                        break
            finally:
                self._wal_replaying = False
        if applied:
            metrics.inc("mutation.wal_replayed", applied)
            log.info("WAL replay: %d record(s) re-applied from %s",
                     applied, path)

    def delete(self, vectors) -> ErrorCode:
        """Delete by content (SPTAG BKT::DeleteIndex): search each vector
        at k = CEF, recheck every hit within `_NEAR_EPS` on the host in
        float64, tombstone those within `DELETE_EPS`; log, then apply."""
        if self.num_samples == 0:
            return ErrorCode.VectorNotFound
        data = self._prepare_vectors(vectors)
        if data.shape[1] != self.feature_dim:
            return ErrorCode.DimensionSizeMismatch
        found_any = False
        # data is prepared: call the family's search directly (search_batch
        # would normalize twice); the delta merge rides along
        k = int(getattr(self.params, "cef", 32))
        k_eff = min(k, self.num_samples)
        dists, ids = self._merge_delta(
            data, k_eff, lambda: self._search_batch(data, k_eff))
        tombstoned: List[int] = []
        seen = set()
        with self._lock:
            for q, row_d, row_i in zip(data, dists, ids):
                for d, v in zip(row_d, row_i):
                    if v >= 0 and d <= max(DELETE_EPS, _NEAR_EPS) and \
                            self._exact_distance(q, int(v)) <= DELETE_EPS:
                        found_any = True
                        if int(v) not in seen and \
                                self.contains_sample(int(v)):
                            seen.add(int(v))
                            tombstoned.append(int(v))
            if tombstoned:
                self._wal_log(wal.pack_delete(tombstoned))
                for v in tombstoned:
                    self._delete_id(v)
        if found_any:
            self.publish_quality_health(background=True)
        return ErrorCode.Success if found_any else ErrorCode.VectorNotFound

    def _exact_distance(self, q: np.ndarray, vid: int) -> float:
        """The host float64 recheck of one candidate, by direct
        subtraction / dot on the stored row: the expanded form
        ||q||^2 + ||x||^2 - 2qx leaves an O(||x||^2 eps_f32) residue on
        identical rows that would fail SPTAG's 1e-6 test."""
        x = self.get_sample(vid).astype(np.float64)
        qf = q.astype(np.float64)
        if self.dist_calc_method == DistCalcMethod.L2:
            diff = qf - x
            return float((diff * diff).sum())
        return float(self.base) ** 2 - float(qf @ x)

    def delete_by_metadata(self, meta: bytes) -> ErrorCode:
        """SPTAG DeleteIndex(ByteArray): needs the metadata index."""
        if self._meta_to_vec is None:
            return ErrorCode.VectorNotFound
        vid = self._meta_to_vec.get(bytes(meta))
        if vid is None:
            return ErrorCode.VectorNotFound
        with self._lock:
            if self.contains_sample(vid):
                self._wal_log(wal.pack_delete([vid]))     # log first
                self._delete_id(vid)
        return ErrorCode.Success

    # ---- refine / merge ---------------------------------------------------

    def refine_index(self) -> ErrorCode:
        """Compact the deleted rows away (SPTAG RefineIndex)."""
        with self._lock:
            # compaction remaps ids: fold the delta's tail in first
            self._absorb_delta_locked()
            self._refine_impl()
        self.publish_quality_health(background=True)
        return ErrorCode.Success

    def merge_index(self, other: "VectorIndex") -> ErrorCode:
        """SPTAG MergeIndex: re-add `other`'s live rows (already prepared
        by `other`) and their metadata."""
        if other.value_type != self.value_type:
            return ErrorCode.Fail
        if other.dist_calc_method != self.dist_calc_method:
            return ErrorCode.Fail
        if self.num_samples > 0 and other.feature_dim != self.feature_dim:
            return ErrorCode.Fail
        keep = [i for i in range(other.num_samples)
                if other.contains_sample(i)]
        if not keep:
            return ErrorCode.Success
        rows = np.stack([other.get_sample(i) for i in keep])
        metas = None
        if other.metadata is not None:
            metas = MetadataSet(other.metadata.get_metadata(i) for i in keep)
        with self._lock:
            if self.num_samples == 0:
                self._build(rows)
                self._reset_delta()
                self.metadata = metas
            else:
                self._absorb_delta_locked()   # _add appends at the tail
                self._wal_log(wal.pack_add(
                    self.num_samples, rows,
                    [metas.get_metadata(i) for i in range(len(keep))]
                    if metas is not None else None))
                begin = self._add(rows)
                if metas is not None:
                    if self.metadata is None:
                        self.metadata = MetadataSet([b""] * begin)
                    self.metadata.add_batch(metas)
                elif self.metadata is not None:
                    for _ in keep:
                        self.metadata.add(b"")
        if self._meta_to_vec is not None:
            self.build_meta_mapping()
        return ErrorCode.Success

    # ---- persistence ------------------------------------------------------

    @property
    def need_refine(self) -> bool:
        n = self.num_samples
        limit = getattr(self.params, "delete_percentage_for_refine", 0.4)
        return n > 0 and self.num_deleted >= limit * n

    def save_index_config(self) -> str:
        """indexloader.ini text, identical to the JAX package's."""
        out = []
        if self.metadata is not None:
            out.append("[MetaData]")
            out.append(f"MetaDataFilePath={self._meta_file}")
            out.append(f"MetaDataIndexPath={self._meta_index_file}")
            if self._meta_to_vec is not None:
                out.append("MetaDataToVectorIndex=true")
            out.append("")
        out.append("[Index]")
        out.append(f"IndexAlgoType={convert_to_string(self.algo)}")
        out.append(f"ValueType={convert_to_string(self.value_type)}")
        out.append("")
        out.append(self.params.save_config())
        return "\n".join(out)

    def save_index(self, folder: str) -> ErrorCode:
        """Stage every file (manifest last) in a sibling directory, then
        swap it in: a crash mid-save never leaves a folder that passes the
        ``indexloader.ini`` completeness check with truncated data."""
        if self.num_samples - self.num_deleted == 0:
            return ErrorCode.EmptyIndex
        with self._lock:
            existing = os.path.exists(os.path.join(folder, "indexloader.ini"))
            token = f"{os.getpid()}-{threading.get_ident()}"
            target = folder.rstrip("/\\") + f".saving-{token}"
            os.makedirs(target, exist_ok=True)
            # a saved snapshot is fully linked: the delta tail folds in
            # first, and a mostly-deleted index is compacted (SPTAG's
            # SaveIndex does the same)
            self._absorb_delta_locked()
            if self.need_refine:
                self._refine_impl()
            wal_on = bool(int(getattr(self.params, "wal_enabled", 0) or 0))
            with atomic.checked_open(
                    os.path.join(target, "indexloader.ini"), "w") as f:
                f.write(self.save_index_config())
            if self.metadata is not None:
                self.metadata.save(
                    os.path.join(target, self._meta_file),
                    os.path.join(target, self._meta_index_file))
            self._save_index_data(target)
            if wal_on:
                # the published snapshot ships an empty log: every acked
                # record is folded into the blobs beside it, and the
                # directory swap retires the old log with the old blobs
                wal.create_empty(os.path.join(target, wal.WAL_NAME))
            atomic.write_manifest(target,
                                  exclude=(wal.WAL_NAME, "indexloader.ini"))
            faultinject.crash_point("save.pre_rename")
            if existing:
                backup = folder.rstrip("/\\") + f".old-{token}"
                try:
                    os.rename(folder, backup)
                except OSError as e:
                    if e.errno not in (errno.EXDEV, errno.EBUSY):
                        raise
                    # a mountpoint: move files in, the old sentinel first
                    os.unlink(os.path.join(folder, "indexloader.ini"))
                    _move_files_in(target, folder)
                    faultinject.crash_point("save.post_rename")
                    if wal_on:
                        self._arm_wal(folder)
                    return ErrorCode.Success
                os.rename(target, folder)
                shutil.rmtree(backup, ignore_errors=True)
            elif not os.path.exists(folder):
                os.rename(target, folder)
            else:
                # a pre-created folder that may hold other files
                _move_files_in(target, folder)
            faultinject.crash_point("save.post_rename")
            if wal_on:
                # future acks append to the (empty) published log
                self._arm_wal(folder)
        return ErrorCode.Success

    def _blob_writers(self):
        """Ordered (name, write(stream)) pairs of the index's binary
        files, shared by the folder save and the blob save."""
        raise NotImplementedError

    def _blob_loaders(self):
        """Ordered (name, load(stream), optional) triples mirroring
        `_blob_writers`."""
        raise NotImplementedError

    def _save_index_data(self, folder: str) -> None:
        for name, writer in self._blob_writers():
            with atomic.checked_open(os.path.join(folder, name), "wb") as f:
                writer(f)

    def _load_index_data(self, folder: str) -> None:
        for name, loader, optional in self._blob_loaders():
            path = os.path.join(folder, name)
            if not os.path.exists(path):
                if optional:
                    continue
                raise FileNotFoundError(path)
            with open(path, "rb") as f:
                loader(f)

    def save_index_blobs(self) -> Tuple[str, List[bytes]]:
        """The whole index as memory buffers (SPTAG's SaveIndex to
        blobs): (config text, blobs) with the blobs ordered as the folder
        files [vectors, <structures...>, deletes][, metadata,
        metadataIndex], each byte-identical to its file."""
        with self._lock:
            self._absorb_delta_locked()
            if self.need_refine:
                self._refine_impl()
            config = self.save_index_config()
            blobs: List[bytes] = []
            for _name, writer in self._blob_writers():
                buf = io.BytesIO()
                writer(buf)
                blobs.append(buf.getvalue())
            if self.metadata is not None:
                mb, ib = io.BytesIO(), io.BytesIO()
                self.metadata.save(mb, ib)
                blobs.extend([mb.getvalue(), ib.getvalue()])
        return config, blobs

    def load_index_blobs_data(self, config: str,
                              blobs: Sequence[bytes]) -> None:
        """`save_index_blobs`'s counterpart on an existing instance; the
        module's `load_index_blobs` is the factory entry point."""
        reader = IniReader.loads(config)
        with self._lock:
            self.params.load_config(reader.section_items("Index"))
            pos = 0
            for name, loader, optional in self._blob_loaders():
                if pos >= len(blobs):
                    if optional:
                        continue
                    raise ValueError(f"missing index blob #{pos} ({name})")
                loader(io.BytesIO(blobs[pos]))
                pos += 1
            self._reset_delta()
            if reader.does_section_exist("MetaData") and \
                    pos + 1 < len(blobs):
                self.metadata = MetadataSet.load(
                    io.BytesIO(blobs[pos]), io.BytesIO(blobs[pos + 1]))
                if reader.get_parameter("MetaData", "MetaDataToVectorIndex",
                                        "") == "true":
                    self.build_meta_mapping()

    def load_index_data(self, folder: str, reader: IniReader,
                        lazy_metadata: bool = False) -> None:
        with self._lock:
            self.params.load_config(reader.section_items("Index"))
            self._load_index_data(folder)
            self._reset_delta()
            if reader.does_section_exist("MetaData"):
                self._meta_file = reader.get_parameter(
                    "MetaData", "MetaDataFilePath", self._meta_file)
                self._meta_index_file = reader.get_parameter(
                    "MetaData", "MetaDataIndexPath", self._meta_index_file)
                meta_path = os.path.join(folder, self._meta_file)
                index_path = os.path.join(folder, self._meta_index_file)
                # lazy: offsets resident, each payload read on demand
                self.metadata = (FileMetadataSet(meta_path, index_path)
                                 if lazy_metadata else
                                 MetadataSet.load(meta_path, index_path))
                if reader.get_parameter("MetaData", "MetaDataToVectorIndex",
                                        "") == "true":
                    self.build_meta_mapping()


def grow_rows(host: np.ndarray, deleted: np.ndarray, n: int, extra: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The host corpus and tombstones with room for `extra` rows past the
    first `n` (capacity doubles), or the same arrays when they fit."""
    need = n + extra
    cap = host.shape[0]
    if need <= cap:
        return host, deleted
    new_cap = max(need, cap * 2, 1024)
    grown = np.empty((new_cap, host.shape[1]), host.dtype)
    grown[:n] = host[:n]
    dels = np.zeros(new_cap, bool)
    dels[:n] = deleted[:n]
    return grown, dels


def pad_results(d: np.ndarray, ids: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad result columns out to k with MAX_DIST / -1 sentinels."""
    if ids.shape[1] < k:
        q = ids.shape[0]
        d = np.concatenate(
            [d, np.full((q, k - d.shape[1]), MAX_DIST, np.float32)], 1)
        ids = np.concatenate(
            [ids, np.full((q, k - ids.shape[1]), -1, np.int32)], 1)
    return d, ids


def _move_files_in(staged: str, folder: str) -> None:
    """Move a staged save into `folder` file by file, indexloader.ini LAST
    so the sentinel never precedes the data it vouches for."""
    names = [nm for nm in os.listdir(staged) if nm != "indexloader.ini"]
    for nm in names + ["indexloader.ini"]:
        atomic.replace_file(os.path.join(staged, nm), os.path.join(folder, nm))
    shutil.rmtree(staged, ignore_errors=True)


def _recover_interrupted_save(folder: str) -> None:
    """A crash between save_index's two renames leaves `folder` absent with
    the new index at `folder.saving-*` (preferred) or the old at
    `folder.old-*`: move one back."""
    if os.path.exists(os.path.join(folder, "indexloader.ini")):
        return
    base = folder.rstrip("/\\")
    parent = os.path.dirname(base) or "."
    name = os.path.basename(base)
    if not os.path.isdir(parent):
        return
    for prefix in (name + ".saving-", name + ".old-"):
        candidates = sorted(
            e for e in os.listdir(parent)
            if e.startswith(prefix) and os.path.exists(
                os.path.join(parent, e, "indexloader.ini")))
        if candidates:
            os.rename(os.path.join(parent, candidates[-1]), folder)
            return


def load_index(folder: str, device: DeviceLike = None,
               lazy_metadata: bool = False) -> VectorIndex:
    """Load a folder saved by either package (or by SPTAG) onto `device`
    (None: the CUDA card).  The manifest, when present, is verified first;
    a ``WalEnabled`` folder's log is replayed over the snapshot.
    `lazy_metadata` loads the metadata as a FileMetadataSet (offsets
    resident, payloads read per lookup).

    A mesh folder (``sharded.json``, parallel/sharded.py) loads as a
    `ServingAdapter` over its shards: with no `device` one shard a CUDA
    card (the JAX package's default mesh; fewer cards than shards raise),
    with a `device` every shard on it (``cuda:0`` runs a mesh on one
    card)."""
    if os.path.exists(os.path.join(folder, "sharded.json")):
        from sptag_tpu_torch.parallel.sharded import (Mesh, ServingAdapter,
                                                      ShardedBKTIndex)

        mesh = None
        if device is not None:
            import json

            with open(os.path.join(folder, "sharded.json")) as f:
                n_shards = int(json.load(f)["n_shards"])
            mesh = Mesh([resolve_device(device)] * n_shards)
        sharded = ShardedBKTIndex.load(folder, mesh=mesh)
        return ServingAdapter(sharded, feature_dim=int(sharded.dim))
    device = resolve_device(device)
    _recover_interrupted_save(folder)
    atomic.verify_manifest(folder)
    reader = IniReader.load(os.path.join(folder, "indexloader.ini"))
    algo = reader.get_parameter("Index", "IndexAlgoType")
    value_type = reader.get_parameter("Index", "ValueType")
    if algo is None or value_type is None:
        raise ValueError("indexloader.ini missing IndexAlgoType/ValueType")
    index = create_instance(algo, value_type, device)
    index.load_index_data(folder, reader, lazy_metadata=lazy_metadata)
    if int(getattr(index.params, "wal_enabled", 0) or 0):
        # every acked mutation since the save, then future acks append
        index._replay_wal(folder)
        index._arm_wal(folder)
    return index


def load_index_blobs(config: str, blobs: Sequence[bytes],
                     device: DeviceLike = None) -> VectorIndex:
    """An index loaded from the memory buffers of `save_index_blobs`
    onto `device` (None: the CUDA card), with no file system use."""
    device = resolve_device(device)
    reader = IniReader.loads(config)
    algo = reader.get_parameter("Index", "IndexAlgoType")
    value_type = reader.get_parameter("Index", "ValueType")
    if algo is None or value_type is None:
        raise ValueError("config missing IndexAlgoType/ValueType")
    index = create_instance(algo, value_type, device)
    index.load_index_blobs_data(config, blobs)
    return index


# ---- capacity planning (SPTAG VectorIndex.cpp:403-437) ----------------------

def _tree_node_size(algo) -> int:
    """Bytes per tree node: BKT {centerid, childStart, childEnd} int32,
    KDT {left, right, split_dim} int32 + split_value float32."""
    if isinstance(algo, str):
        algo = enum_from_string(IndexAlgoType, algo)
    algo = IndexAlgoType(algo)
    if algo == IndexAlgoType.BKT:
        return 4 * 3
    if algo == IndexAlgoType.KDT:
        return 4 * 2 + 4 + 4
    return 0


def _row_bytes(value_type, dimension: int) -> int:
    if isinstance(value_type, str):
        value_type = enum_from_string(VectorValueType, value_type)
    return (np.dtype(dtype_of(VectorValueType(value_type))).itemsize
            * dimension)


def estimated_memory_usage(vector_count: int, dimension: int,
                           algo, value_type,
                           tree_number: int = 1,
                           neighborhood_size: int = 32) -> int:
    """Host bytes of an index of `vector_count` rows, SPTAG's formula
    (EstimatedMemoryUsage): vectors, metadata offsets, graph rows, a
    tombstone byte and the tree nodes; 0 outside BKT / KDT, as SPTAG."""
    tree_node = _tree_node_size(algo)
    if tree_node == 0:
        return 0
    unit = _row_bytes(value_type, dimension)
    total = unit * vector_count                    # vectors
    total += 8 * vector_count                      # metadata offset table
    total += 4 * neighborhood_size * vector_count  # graph rows
    total += vector_count                          # tombstone flags
    total += tree_node * tree_number * vector_count
    return total


def estimated_vector_count(memory_bytes: int, dimension: int,
                           algo, value_type,
                           tree_number: int = 1,
                           neighborhood_size: int = 32) -> int:
    """Rows that fit in `memory_bytes` (estimated_memory_usage inverted)."""
    per_row = estimated_memory_usage(1, dimension, algo, value_type,
                                     tree_number, neighborhood_size)
    return 0 if per_row == 0 else memory_bytes // per_row


def estimated_hbm_usage(vector_count: int, dimension: int, value_type,
                        neighborhood_size: int = 32,
                        dense_mode: bool = True,
                        dense_cluster_size: int = 256,
                        dense_replicas: int = 1) -> int:
    """Card-memory bytes of the port's search snapshots (the name and the
    formula are the JAX package's, whose device memory is the TPU's HBM).

    The walk's engine (algo/engine.py): vectors, float32 squared norms,
    int32 graph rows and a bool tombstone mask.  The dense layout
    (algo/dense.py) adds its cluster-contiguous copy (x1.15 padding,
    times DenseReplicas), int32 member ids and float32 member norms per
    padded slot, float32 block centroids and its own mask.

    Not counted: the pivots, the walk options' copies (the bf16 shadow
    of `BeamScoreDtype=bf16`, N x D bf16; the packed neighbours of
    `BeamPackedNeighbors=1`, N x m x D in the scoring dtype plus N x m
    float32 norms, about m times the vectors), and per-query working
    memory (the walk's visited table, a scheduler's slots).  A built
    engine's `GraphSearchEngine.device_bytes()` gives its own tensors by
    part."""
    unit = _row_bytes(value_type, dimension)
    pad = 1.15 * max(1, dense_replicas)
    total = unit * vector_count                    # engine vector snapshot
    total += 4 * vector_count                      # sqnorms
    total += 4 * neighborhood_size * vector_count  # graph
    total += vector_count                          # bool tombstones
    if dense_mode:
        slots = int(vector_count * pad)
        n_blocks = max(1, slots // max(dense_cluster_size, 1))
        total += unit * slots                      # packed blocks
        total += 4 * slots                         # member ids (int32)
        total += 4 * slots                         # member sqnorms
        total += 4 * dimension * n_blocks          # block-mean centroids
        total += vector_count                      # tombstone mask copy
    return total
