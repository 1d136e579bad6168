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
Deletes tombstone; ``refine_index`` compacts.  ``SketchPrefilter`` and
``CascadeSearch`` belong to the cascade item of ROADMAP.md and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.core.index import (MAX_DIST, VectorIndex, grow_rows,
                                        not_ported, pad_results,
                                        register_algo)
from sptag_tpu_torch.core.params import FlatParams
from sptag_tpu_torch.core.types import (DistCalcMethod, IndexAlgoType,
                                        VectorValueType, dtype_of)
from sptag_tpu_torch.io import format as fmt
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import topk_bins
from sptag_tpu_torch.utils import devmem, round_up

_ROW_PAD = 128      # corpus rows are padded to a multiple of this
# score-matrix elements per query chunk (Q_chunk * Npad)
_SCAN_BUDGET = 1 << 28
# passes over the materialized (Q, N) score matrix in the exact scan (mask,
# negate, top-k): the JAX package's costmodel.SCAN_MATRIX_TRAFFIC
_SCAN_MATRIX_TRAFFIC = 3.2


def flat_scan_cost(Q: int, N: int, D: int, k: int,
                   itemsize: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one exact scan of Q queries over N rows of width
    D: the contraction, the norms and the masked top-k; bytes are the
    corpus, queries, norms and tombstones read, the results written and
    the score matrix's passes.  The JAX package's ``flat.scan``
    cost-ledger formula (its unbinned branch); the quality monitor's
    shadow budget charges each replay by it."""
    flops = 2.0 * Q * N * D + 2.0 * D * (Q + N) + 2.0 * Q * N
    nbytes = (N * D * itemsize + Q * D * itemsize + N * 4 + N + Q * k * 8
              + _SCAN_MATRIX_TRAFFIC * Q * N * 4)
    return flops, nbytes


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


@register_algo
class FlatIndex(VectorIndex):
    algo = IndexAlgoType.FLAT

    def __init__(self, value_type: VectorValueType, device: torch.device):
        super().__init__(value_type, device)
        self._host: Optional[np.ndarray] = None
        self._n = 0
        self._deleted = np.zeros(0, bool)
        self._device_snap = None

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

    # ---- mutation ---------------------------------------------------------

    def _add(self, data: np.ndarray) -> int:
        begin = self._append_rows_unlinked(data)
        self._device_snap = None
        return begin

    def _delete_id(self, vid: int) -> bool:
        if self._deleted[vid]:
            return False
        self._deleted[vid] = True
        self._device_snap = None
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
        # live snapshot (disable dropped its entry)
        with self._lock:
            if self._device_snap is not None:
                self._track_snapshot(self._device_snap)

    # ---- search -----------------------------------------------------------

    def _search_batch(self, queries: np.ndarray, k: int,
                      max_check: Optional[int] = None,
                      search_mode: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        if self._n == 0:
            raise RuntimeError("index is empty")
        del max_check, search_mode      # exact scan: no budget, no modes
        p = self.params
        if int(getattr(p, "cascade_search", 0)) and np.issubdtype(
                dtype_of(self.value_type), np.floating):
            raise not_ported("CascadeSearch=1", "cascade")
        data_d, sqnorm_d, invalid_d = self._snapshot()
        if getattr(p, "sketch_prefilter", False) and data_d.shape[0] > 256:
            raise not_ported("SketchPrefilter=true", "cascade")
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
