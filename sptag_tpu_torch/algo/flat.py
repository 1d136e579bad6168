"""FLAT — the exact brute-force index (port of ``sptag_tpu/algo/flat.py``).

One (Q, D) x (N, D) distance matrix and a masked top-k per query chunk.
The corpus lives on the device as an (Npad, D) snapshot, rows padded to a
multiple of ``_ROW_PAD`` as in the JAX package (the padding decides the
binned select's bin layout, so it is a parity rule); tombstones and padding
score MAX_DIST.  It is also the exact oracle of the graph indexes
(`exact_device_scan`, behind ``exact_search_batch``).

``ApproxTopK`` computes the exact top-k: ``lax.approx_max_k`` lowers to an
exact sort on every backend but a TPU, so that is what the JAX package
returns here too.  ``BinnedTopK`` wins when both are set.
Adds append to the host corpus and drop the device snapshot (the next
search re-uploads it); with ``DeltaShardCapacity`` they land in the delta
shard instead and the snapshot keeps covering ``[0, _main_rows())``.
Deletes tombstone; ``refine_index`` compacts.

``SketchPrefilter`` ranks every row by the Hamming distance between 1-bit
sign sketches (ops/sketch_dots.py's kernel), keeps a shortlist of R rows
and re-ranks them exactly with the walk's fixed-order kernel
(ops/walk_dots.py).  R is ``SketchRerank``, or, at 0, calibrated once per
snapshot: 64 live rows drawn by ``default_rng(0xC0FFEE)`` are searched as
self-queries and the 95th percentile of the sketch rank their true top-10
needs, rounded up to a power of two, sets it (a failed calibration is
cached as -1 and the N/32 heuristic applies).  A calibration is saved with
the folder as ``sketch_cal.bin`` (magic ``SPTSCAL1``, ``struct "<8sqqi"``:
rows, deletes, R), byte for byte the JAX package's file, and a load reuses
it while the corpus is untouched.  ``CascadeSearch`` (float corpora) serves
through the tiered cascade of ops/cascade.py and is routed before the
snapshot is read, so with ``CorpusTier=host`` / ``host_all`` the float32
corpus never reaches the card; the exact oracle of such an index streams
the host corpus through the card in blocks.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.core.index import (MAX_DIST, VectorIndex, grow_rows,
                                        pad_results, register_algo)
from sptag_tpu_torch.core.params import FlatParams
from sptag_tpu_torch.core.types import (DistCalcMethod, IndexAlgoType,
                                        VectorValueType, dtype_of)
from sptag_tpu_torch.io import atomic
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.ops import cascade
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import topk_bins
from sptag_tpu_torch.ops import walk_dots as walk_ops
from sptag_tpu_torch.utils import costmodel, devmem, round_up

_ROW_PAD = 128      # corpus rows are padded to a multiple of this
# score-matrix elements per query chunk (Q_chunk * Npad)
_SCAN_BUDGET = 1 << 28
def _flat_search_kernel(data, sqnorm, invalid, queries, k: int, metric: int,
                        base: int, binned_bins: int = 0):
    """Distance matrix -> mask -> top-k (binned when `binned_bins` > 0).
    Returns ((Q, k) float32 distances, (Q, k) int32 ids, -1 past the live
    rows)."""
    if metric == int(DistCalcMethod.L2):
        d = dist_ops.pairwise_l2(queries, data, sqnorm)
    else:
        d = dist_ops.pairwise_cosine(queries, data, base)
    d = torch.where(invalid[None, :], MAX_DIST, d)
    if binned_bins:
        dists, idx = topk_bins.binned_topk(d, k, binned_bins)
    else:
        dists, idx = dist_ops.smallest_k(d, k)
    ids = torch.where(dists >= MAX_DIST, -1, idx).to(torch.int32)
    return dists, ids


def _scan(data_d, sqnorm_d, invalid_d, queries: np.ndarray, k: int,
          metric: int, base: int, binned_bins: int = 0
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The scan over host queries in chunks of at most `_SCAN_BUDGET`
    score elements; numpy results, k' = min(k, rows) columns (binned:
    min(k', bins))."""
    n_rows = data_d.shape[0]
    k_eff = min(k, n_rows)
    chunk = max(1, _SCAN_BUDGET // max(n_rows, 1))
    out_d, out_i = [], []
    for lo in range(0, queries.shape[0], chunk):
        q = torch.from_numpy(
            np.ascontiguousarray(queries[lo:lo + chunk])).to(data_d.device)
        d, ids = _flat_search_kernel(data_d, sqnorm_d, invalid_d, q, k_eff,
                                     metric, base, binned_bins)
        out_d.append(d.cpu().numpy())
        out_i.append(ids.cpu().numpy())
    return np.concatenate(out_d), np.concatenate(out_i)


def exact_device_scan(data_d, sqnorm_d, invalid_d, queries: np.ndarray,
                      k: int, metric: int, base: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The exact masked scan: the ground-truth oracle shared by FlatIndex
    and the graph indexes' `exact_search_batch`.  Never binned."""
    return _scan(data_d, sqnorm_d, invalid_d, queries, k, metric, base)


# sketch-rank calibration: sampled self-queries, and the neighbour depth
# the shortlist is calibrated to
_CAL_SAMPLE = 64
_CAL_K = 10
# queries per chunk of the sketch prefilter (the (Q, N) Hamming matrix)
_SKETCH_CHUNK = 1024


def _sketch_ranks(data_d, sqnorm_d, invalid_d, sketches, mean, queries,
                  k: int, metric: int, base: int) -> torch.Tensor:
    """For each sample query, the number of rows whose sketch Hamming
    distance is at most that of its WORST exact top-k neighbour: the
    shortlist its k neighbours need (ties counted conservatively).  (S,)
    int32."""
    if metric == int(DistCalcMethod.L2):
        d = dist_ops.pairwise_l2(queries, data_d, sqnorm_d)
    else:
        d = dist_ops.pairwise_cosine(queries, data_d, base)
    d = torch.where(invalid_d[None, :], MAX_DIST, d)
    _, topk = dist_ops.smallest_k(d, k)
    ham = cascade.hamming_scores(sketches, mean, invalid_d, queries)
    worst = torch.gather(ham, 1, topk).amax(dim=1, keepdim=True)
    return (ham <= worst).sum(dim=1).to(torch.int32)


def _sketch_search(data_d, sqnorm_d, invalid_d, sketches, mean, queries,
                   k: int, R: int, metric: int, base: int):
    """Sketch-shortlist exact search of one query chunk: Hamming scan,
    the R best rows (lowest index first among ties), their exact distances
    by the fixed-order kernel, the final top-k."""
    ham = cascade.hamming_scores(sketches, mean, invalid_d, queries)
    _, short = dist_ops.smallest_k(ham, R)
    d = walk_ops.walk_distance(queries, data_d, metric, base,
                               walk_ops.GATHER, idx=short,
                               x_sqnorm=sqnorm_d)
    d = torch.where(invalid_d[short], MAX_DIST, d)
    dists, pos = dist_ops.smallest_k(d, k)
    ids = torch.gather(short, 1, pos)
    return dists, torch.where(dists >= MAX_DIST, -1, ids).to(torch.int32)


@register_algo
class FlatIndex(VectorIndex):
    algo = IndexAlgoType.FLAT

    def __init__(self, value_type: VectorValueType, device: torch.device):
        super().__init__(value_type, device)
        self._host: Optional[np.ndarray] = None
        self._n = 0
        self._deleted = np.zeros(0, bool)
        self._device_snap = None
        # (snapshot, packed sketches, mean, calibrated R or None / -1),
        # keyed to the snapshot it was derived from
        self._sketch = None
        # the tiered cascade's state, rebuilt after a mutation
        self._cascade: Optional[cascade.CascadeState] = None
        # (rows, deletes, R) read from sketch_cal.bin, consumed while the
        # corpus is untouched since the save
        self._loaded_cal: Optional[Tuple[int, int, int]] = None

    def _invalidate_derived(self) -> None:
        """A mutation: the cascade state covers stale rows and a loaded
        calibration no longer describes the corpus."""
        self._cascade = None
        self._loaded_cal = None

    def _make_params(self) -> FlatParams:
        return FlatParams()

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

    def get_sample(self, vid: int) -> np.ndarray:
        return self._host[vid]

    def _reserve(self, extra: int) -> None:
        self._host, self._deleted = grow_rows(self._host, self._deleted,
                                              self._n, extra)

    def _build(self, data: np.ndarray, checkpoint=None) -> None:
        # exact index: single-stage build, nothing to checkpoint
        self._host = np.ascontiguousarray(data)
        self._n = data.shape[0]
        self._deleted = np.zeros(self._n, bool)
        self._device_snap = None
        self._invalidate_derived()

    # ---- mutation ---------------------------------------------------------

    def _add(self, data: np.ndarray) -> int:
        begin = self._append_rows_unlinked(data)
        self._device_snap = None
        self._invalidate_derived()
        return begin

    def _delete_id(self, vid: int) -> bool:
        if self._deleted[vid]:
            return False
        self._deleted[vid] = True
        self._device_snap = None
        self._invalidate_derived()
        return True

    def _append_rows_unlinked(self, data: np.ndarray) -> Optional[int]:
        """Rows land in the host corpus without touching the device
        snapshot, which keeps covering [0, _main_rows())."""
        begin = self._n
        self._reserve(data.shape[0])
        self._host[begin:begin + data.shape[0]] = data
        self._n += data.shape[0]
        return begin

    def _tombstone_mask(self) -> Optional[np.ndarray]:
        return self._deleted[:self._n]

    def _absorb_delta_impl(self, begin: int, count: int) -> None:
        # the rows are resident already: the next snapshot covers them
        self._device_snap = None
        self._invalidate_derived()

    def _refine_impl(self) -> None:
        """Compaction: drop the tombstoned rows, renumber the rest."""
        keep = np.flatnonzero(~self._deleted[:self._n])
        self._host = np.ascontiguousarray(self._host[keep])
        self._n = len(keep)
        self._deleted = np.zeros(self._n, dtype=bool)
        if self.metadata is not None:
            self.metadata = self.metadata.refine(keep.tolist())
        if self._meta_to_vec is not None:
            self.build_meta_mapping()
        self._device_snap = None
        self._invalidate_derived()

    def _snapshot(self):
        """(data (Npad, D), squared norms (Npad,), invalid (Npad,)) on the
        device over the main rows, built at first use after a change."""
        snap = self._device_snap
        if snap is not None:
            return snap
        with self._lock:
            if self._device_snap is None:
                n = self._main_rows()
                n_pad = max(_ROW_PAD, round_up(n, _ROW_PAD))
                data = np.zeros((n_pad, self.feature_dim),
                                dtype_of(self.value_type))
                data[:n] = self._host[:n]
                invalid = np.ones(n_pad, bool)
                invalid[:n] = self._deleted[:n]
                data_d = torch.from_numpy(data).to(self.device)
                snap = (data_d, dist_ops.row_sqnorms(data_d),
                        torch.from_numpy(invalid).to(self.device))
                # device-memory ledger: owned by the data tensor, so a
                # snapshot rebuild drops the old entry with the old tensors
                self._track_snapshot(snap)
                self._device_snap = snap
            return self._device_snap

    @staticmethod
    def _track_snapshot(snap) -> None:
        data_d, sqnorm_d, invalid_d = snap
        devmem.track("corpus", data_d,
                     data_d.nbytes + sqnorm_d.nbytes + invalid_d.nbytes)

    def _retrack_devmem(self) -> None:
        # DeviceBytesLedger re-enabled on a warm index: re-register the
        # live snapshot, sketches and cascade (disable dropped them)
        with self._lock:
            if self._device_snap is not None:
                self._track_snapshot(self._device_snap)
            if self._sketch is not None:
                packed, mean = self._sketch[1], self._sketch[2]
                devmem.track("sketch", packed, packed.nbytes + mean.nbytes)
            if self._cascade is not None:
                self._cascade.register_devmem()

    # ---- sketch prefilter -------------------------------------------------

    def _sketch_snapshot(self):
        """(snapshot, packed (Npad, W) int32 sketches, (D,) float32 mean,
        calibrated R) read as one: the sketches belong to the snapshot they
        were packed from, so a concurrent mutation never pairs one
        snapshot's rows with another's sketches."""
        with self._lock:
            snap = self._snapshot()
            cached = self._sketch
            if cached is not None and cached[0] is snap:
                return cached
            data_d, _, invalid_d = snap
            f = data_d.to(torch.float32)
            live = (~invalid_d).to(torch.float32)
            mean = ((f * live[:, None]).sum(0)
                    / torch.clamp_min(live.sum(), 1.0))
            packed = cascade.pack_sign_bits(f - mean[None, :])
            devmem.track("sketch", packed, packed.nbytes + mean.nbytes)
            # R is calibrated outside this lock (_ensure_calibrated):
            # explicit SketchRerank never pays for it
            self._sketch = (snap, packed, mean, None)
            return self._sketch

    def _calibrate(self, data_d, sqnorm_d, invalid_d, packed, mean
                   ) -> Optional[int]:
        """The measured auto shortlist: the 95th percentile of the sketch
        rank sampled self-queries' true neighbours need, rounded up to a
        power of two; None on any failure (calibration never fails a
        search)."""
        try:
            live_idx = np.flatnonzero(~invalid_d.cpu().numpy())
            if len(live_idx) < 8:
                return None
            rs = np.random.default_rng(0xC0FFEE)
            sample = live_idx[rs.integers(0, len(live_idx), _CAL_SAMPLE)]
            ranks = _sketch_ranks(
                data_d, sqnorm_d, invalid_d, packed, mean,
                data_d[torch.from_numpy(sample).to(data_d.device)], _CAL_K,
                int(self.dist_calc_method), self.base).cpu().numpy()
            r = int(np.percentile(ranks, 95))
            return 1 << (max(r, 1) - 1).bit_length()
        except Exception:                              # noqa: BLE001
            return None

    def _ensure_calibrated(self):
        """`_sketch_snapshot` with R calibrated: from a saved
        ``sketch_cal.bin`` while the corpus is untouched, else by the scan,
        outside the index lock, stored only if the snapshot is still
        current.  A failure is cached as -1 (tried once a snapshot)."""
        snap, packed, mean, cal_r = self._sketch_snapshot()
        if cal_r is not None:
            return snap, packed, mean, cal_r
        loaded = self._loaded_cal
        if loaded is not None and loaded[0] == self._main_rows() \
                and loaded[1] == self.num_deleted and loaded[2] > 0:
            cal_r = int(loaded[2])
        else:
            data_d, sqnorm_d, invalid_d = snap
            cal_r = self._calibrate(data_d, sqnorm_d, invalid_d, packed,
                                    mean)
        with self._lock:
            if self._sketch is not None and self._sketch[0] is snap:
                self._sketch = (snap, packed, mean,
                                cal_r if cal_r is not None else -1)
        return snap, packed, mean, cal_r

    def _sketch_prefilter(self, queries: np.ndarray, k: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        explicit_r = int(getattr(self.params, "sketch_rerank", 0) or 0)
        if explicit_r:
            snap, sketches, mean, cal_r = self._sketch_snapshot()
        else:
            snap, sketches, mean, cal_r = self._ensure_calibrated()
        data_d, sqnorm_d, invalid_d = snap
        n_rows = data_d.shape[0]
        k_eff = min(k, n_rows)
        # the calibrated R (16 k floor for depths past the calibration's),
        # capped at 8,192; an explicit SketchRerank wins
        auto = max(128, 16 * k_eff,
                   cal_r if (cal_r and cal_r > 0) else n_rows // 32)
        R = explicit_r or min(auto, 8192)
        R = min(max(R, k_eff), n_rows)
        out_d, out_i = [], []
        for lo in range(0, queries.shape[0], _SKETCH_CHUNK):
            q = torch.from_numpy(np.ascontiguousarray(
                queries[lo:lo + _SKETCH_CHUNK])).to(data_d.device)
            d, ids = _sketch_search(data_d, sqnorm_d, invalid_d, sketches,
                                    mean, q, k_eff, R,
                                    int(self.dist_calc_method), self.base)
            out_d.append(d.cpu().numpy())
            out_i.append(ids.cpu().numpy())
        return np.concatenate(out_d), np.concatenate(out_i)

    # ---- tiered cascade ---------------------------------------------------

    def _cascade_active(self) -> bool:
        """CascadeSearch applies to float value types only (an integer
        corpus is already quantized; the knob is a no-op there)."""
        return (int(getattr(self.params, "cascade_search", 0) or 0) != 0
                and np.issubdtype(dtype_of(self.value_type), np.floating))

    def _cascade_state(self) -> cascade.CascadeState:
        """The pinned cascade state, rebuilt after a mutation.  The device
        tier shares the exact oracle's fp snapshot; the host tiers never
        read the snapshot, so the fp corpus stays in host memory."""
        tier = cascade.normalize_tier(
            getattr(self.params, "corpus_tier", "device"))
        with self._lock:
            st = self._cascade
            if st is not None and st.tier == tier:
                return st
            n = self._main_rows()
            st = cascade.CascadeState(
                np.asarray(self._host[:n], np.float32), self._deleted[:n],
                tier, int(self.dist_calc_method), self.base,
                fp_dev=(self._snapshot()[0] if tier == "device" else None),
                device=self.device)
            st.register_devmem()
            self._cascade = st
            return st

    def cascade_triage(self, query: np.ndarray, truth_ids,
                       k: int = 10) -> Optional[dict]:
        """The quality monitor's triage hook: which cascade tier dropped
        the true neighbours of one sampled query (None with the cascade
        off)."""
        if not self._cascade_active():
            return None
        return self._cascade_state().tier_membership(
            query, truth_ids, k,
            int(getattr(self.params, "tier_budget_sketch", 0)),
            int(getattr(self.params, "tier_budget_int8", 0)))

    # ---- search -----------------------------------------------------------

    def _search_batch(self, queries: np.ndarray, k: int,
                      max_check: Optional[int] = None,
                      search_mode: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        if self._n == 0:
            raise RuntimeError("index is empty")
        del max_check, search_mode      # exact scan: no budget, no modes
        p = self.params
        if self._cascade_active():
            # before the snapshot read: a host tier never uploads the fp
            # corpus
            st = self._cascade_state()
            d, ids = st.search(
                np.asarray(queries, np.float32), min(k, st.n_pad),
                int(getattr(p, "tier_budget_sketch", 0)),
                int(getattr(p, "tier_budget_int8", 0)))
            return pad_results(d, ids, k)
        data_d, sqnorm_d, invalid_d = self._snapshot()
        if getattr(p, "sketch_prefilter", False) and data_d.shape[0] > 256:
            d, ids = self._sketch_prefilter(queries, k)
            return pad_results(d, ids, k)
        rt = topk_bins.validate_recall_target(
            getattr(p, "approx_recall_target", 0.99))
        bins = topk_bins.resolve_bins(
            str(getattr(p, "binned_topk", "off")),
            min(k, data_d.shape[0]), data_d.shape[0], rt)
        d, ids = _scan(data_d, sqnorm_d, invalid_d, queries, k,
                       int(self.dist_calc_method), self.base, bins)
        return pad_results(d, ids, k)

    def _exact_scan(self, queries: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The exact oracle, whatever the serving configuration; a host
        tier streams its host corpus through the card in blocks instead of
        uploading it."""
        if self._cascade_active():
            st = self._cascade_state()
            if st.fp_host is not None:
                return cascade.host_exact_scan(
                    st.fp_host, st.invalid_host, queries, min(k, st.n_pad),
                    int(self.dist_calc_method), self.base,
                    device=self.device)
        data_d, sqnorm_d, invalid_d = self._snapshot()
        return exact_device_scan(data_d, sqnorm_d, invalid_d, queries, k,
                                 int(self.dist_calc_method), self.base)

    # ---- persistence ------------------------------------------------------

    def _blob_writers(self):
        """Blob order: vectors, deletes."""
        p = self.params
        return [
            (p.vector_file,
             lambda f: fmt.write_matrix(f, self._host[:self._n])),
            (p.delete_file,
             lambda f: fmt.write_deletes(f, self._deleted[:self._n])),
        ]

    def _load_vectors_stream(self, f) -> None:
        self._build(fmt.read_matrix(f, dtype_of(self.value_type)))

    def _load_deletes_stream(self, f) -> None:
        mask = fmt.read_deletes(f)
        self._deleted[:len(mask)] = mask[:self._n]

    def _blob_loaders(self):
        p = self.params
        return [(p.vector_file, self._load_vectors_stream, False),
                (p.delete_file, self._load_deletes_stream, True)]

    # ---- the calibration's file -------------------------------------------
    # folder-only: not one of _blob_writers (the blob surface pairs blobs
    # with loaders by position); the folder's manifest checksums it

    _CAL_FILE = "sketch_cal.bin"
    _CAL_MAGIC = b"SPTSCAL1"
    _CAL_STRUCT = "<8sqqi"

    def _cal_payload(self) -> Optional[bytes]:
        """(rows, deletes, R) of the current corpus, or None when no valid
        calibration exists (nothing is written then)."""
        n, ndel = self._main_rows(), self.num_deleted
        cal_r = 0
        with self._lock:
            sk = self._sketch
            if (sk is not None and self._device_snap is not None
                    and sk[0] is self._device_snap and sk[3] and sk[3] > 0):
                cal_r = int(sk[3])
        loaded = self._loaded_cal
        if cal_r <= 0 and loaded is not None and loaded[0] == n \
                and loaded[1] == ndel:
            cal_r = int(loaded[2])
        if cal_r <= 0:
            return None
        return struct.pack(self._CAL_STRUCT, self._CAL_MAGIC, n, ndel, cal_r)

    def _save_index_data(self, folder: str) -> None:
        super()._save_index_data(folder)
        payload = self._cal_payload()
        if payload is not None:
            with atomic.checked_open(os.path.join(folder, self._CAL_FILE),
                                     "wb") as f:
                f.write(payload)

    def _load_index_data(self, folder: str) -> None:
        super()._load_index_data(folder)
        path = os.path.join(folder, self._CAL_FILE)
        if not os.path.exists(path):
            return
        try:
            with open(path, "rb") as f:
                magic, n, ndel, cal_r = struct.unpack(
                    self._CAL_STRUCT,
                    f.read(struct.calcsize(self._CAL_STRUCT)))
            if magic == self._CAL_MAGIC and cal_r > 0:
                # checked again against the live corpus when consumed
                self._loaded_cal = (int(n), int(ndel), int(cal_r))
        except Exception:                              # noqa: BLE001
            self._loaded_cal = None        # a corrupt file: recalibrate


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py; the JAX package's formulas)
# ---------------------------------------------------------------------------

def _flat_scan_cost(Q, N, D, k, itemsize=4, binned_bins=0, **_):
    """Exact scan: one (Q, D) x (N, D) contraction + norms + masked top-k.
    Bytes: corpus + queries + norms/tombstones in, results out, plus the
    materialised (Q, N) score matrix's mask/neg/top-k traffic.  With
    `binned_bins` the selection is the bin reduction."""
    flops = (costmodel.matmul_flops(Q, N, D) + 2.0 * D * (Q + N)
             + 2.0 * Q * N)
    if binned_bins:
        sel_f, sel_b = topk_bins.binned_select_cost(Q, N, k, binned_bins)
        nbytes = (N * D * itemsize + Q * D * itemsize + N * 4 + N
                  + Q * k * 8
                  + costmodel.SCAN_MATRIX_TRAFFIC * Q * N * 4
                  + sel_b)
        return flops + sel_f, nbytes
    nbytes = (N * D * itemsize + Q * D * itemsize + N * 4 + N + Q * k * 8
              + costmodel.SCAN_MATRIX_TRAFFIC * Q * N * 4)
    return flops, nbytes


def _flat_sketch_cost(Q, N, W, R, D, k, itemsize=4, **_):
    """Sketch prefilter: XOR+popcount Hamming scan over (N, W) packed
    words, top-R shortlist, exact re-rank of the gathered R rows."""
    flops = (3.0 * Q * N * W                    # xor + popcount + add
             + costmodel.topk_flops(Q, N)       # shortlist top-R
             + costmodel.matmul_flops(Q, R, D)  # exact re-rank
             + costmodel.topk_flops(Q, R))
    nbytes = (N * W * 4 + Q * W * 4
              + costmodel.SCAN_MATRIX_TRAFFIC * Q * N * 4
              + 2.0 * Q * R * D * itemsize      # gather out + re-read
              + N * D * itemsize                # gather operand
              + Q * k * 8)
    return flops, nbytes


def _sketch_cal_cost(S, N, W, D, k, itemsize=4, **_):
    """Calibration = one exact scan + one Hamming scan over S samples."""
    f1, b1 = _flat_scan_cost(S, N, D, k, itemsize)
    flops = f1 + 3.0 * S * N * W
    nbytes = b1 + N * W * 4 + costmodel.SCAN_MATRIX_TRAFFIC * S * N * 4
    return flops, nbytes


def _pack_bits_cost(R, D, **_):
    return 3.0 * R * D, R * D * 4 + R * ((D + 31) // 32) * 4


costmodel.register("flat.scan", _flat_search_kernel, _flat_scan_cost)
costmodel.register("flat.sketch_scan", _sketch_search, _flat_sketch_cost)
costmodel.register("flat.sketch_cal", FlatIndex._calibrate, _sketch_cal_cost)
# the sketch pack is the cascade's sign-bit packer (ops/cascade.py)
costmodel.register("flat.pack_bits", cascade.pack_sign_bits, _pack_bits_cost)
