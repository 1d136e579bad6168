"""Delta shard — fresh vectors searchable at once, without re-linking (port
of ``sptag_tpu/core/delta.py``).

SPTAG's AddIndex pays an AddCEF-budget graph search and an RNG prune per
appended row inline, and the graph index then rebuilds its device
snapshot.  With ``DeltaShardCapacity`` set, appended rows land instead in
a bounded side index that is scanned exactly on every search:

* the host buffer is preallocated at capacity; its device snapshot
  ``(count, data, sqnorm)`` is republished as one attribute whenever
  ``count`` has moved;
* every search runs the main index over its frozen coverage
  ``[0, base_id)`` plus the exact scan over ``[base_id, n)`` and merges
  the two top-k lists (`merge_topk`);
* tombstones mask both tiers: the delta reads the owner's global mask at
  query time;
* a background refine (algo/bkt.py) links the delta rows into the graph
  off the lock, swaps a new engine in and `rebased` hands the rows that
  arrived meanwhile to a fresh shard.

The scan is the port's `algo.flat.exact_device_scan`; the class is under
the lock sanitizer like the JAX package's, and its rows are on the
device-memory ledger (``utils/devmem.py``) as the ``delta_shard``
component, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.utils import devmem, locksan, round_up

#: sentinel distance (core/index.py MAX_DIST)
_MAX_DIST = np.float32(3.4e38)

_ROW_PAD = 128      # the FLAT scan's row padding (algo/flat.py)


@locksan.race_track
class DeltaShard:
    """Bounded side index for rows appended after the engine snapshot.

    ``append`` runs under the owner VectorIndex's writer lock; ``search``
    runs lock-free from any reader.  `count` is read once per search and
    the device snapshot is one attribute: a reader sees the old or the
    new (count, arrays) tuple, never a torn pair."""

    def __init__(self, base_id: int, dim: int, dtype, capacity: int,
                 metric: int, base: int, device: DeviceLike = None):
        self.base_id = int(base_id)
        self.capacity = int(capacity)
        self.metric = int(metric)
        self.base = int(base)
        self.device = resolve_device(device)
        self._pad = max(_ROW_PAD, round_up(self.capacity, _ROW_PAD))
        self._rows = np.zeros((self._pad, dim), np.dtype(dtype))
        self.count = 0
        # (count, data_d, sqnorm_d), republished atomically
        self._device: Optional[tuple] = None
        # serializes the lazy re-upload (the owner lock is not held on
        # the search path); a leaf lock, never nested
        self._cache_lock = locksan.make_lock("DeltaShard._cache_lock")

    def append(self, data: np.ndarray, begin: int) -> None:
        """Append prepared rows whose global ids start at `begin`
        (owner lock held); the shard is the tail of the id space."""
        assert begin == self.base_id + self.count, \
            (begin, self.base_id, self.count)
        n = data.shape[0]
        assert self.count + n <= self.capacity, "delta shard overflow"
        self._rows[self.count:self.count + n] = data
        self.count += n

    def _snapshot(self) -> tuple:
        """(count, data_d, sqnorm_d), re-uploaded when appends outran the
        cached copy: the whole (pad, D) buffer, a few MB at most."""
        snap = self._device
        if snap is not None and snap[0] == self.count:
            return snap
        with self._cache_lock:
            snap = self._device
            count = self.count
            if snap is not None and snap[0] == count:
                return snap
            from sptag_tpu_torch.ops import distance as dist_ops

            data_d = torch.from_numpy(self._rows.copy()).to(self.device)
            snap = (count, data_d, dist_ops.row_sqnorms(data_d))
            devmem.track("delta_shard", self,
                         data_d.nbytes + snap[2].nbytes)
            self._device = snap
            return snap

    def search(self, queries: np.ndarray, k: int,
               deleted: Optional[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact masked scan over the shard: ((Q, k) dists, (Q, k) global
        int32 ids), ascending, MAX_DIST / -1 padded.  `deleted` is the
        owner's full tombstone mask (global ids)."""
        from sptag_tpu_torch.algo.flat import exact_device_scan

        count, data_d, sqnorm_d = self._snapshot()
        invalid = np.ones(self._pad, bool)
        if deleted is not None and len(deleted) >= self.base_id + count:
            invalid[:count] = deleted[self.base_id:self.base_id + count]
        else:
            invalid[:count] = False
        k_eff = max(1, min(k, count))
        d, ids = exact_device_scan(
            data_d, sqnorm_d, torch.from_numpy(invalid).to(self.device),
            queries, k_eff, self.metric, self.base)
        ids = np.where(ids >= 0, ids + np.int32(self.base_id),
                       np.int32(-1))
        return d, ids

    def rebased(self, new_base: int, tail_rows: Optional[np.ndarray]
                ) -> Optional["DeltaShard"]:
        """A fresh shard holding only the rows at/after `new_base` (the
        swap's handoff); None when nothing remains."""
        if tail_rows is None or tail_rows.shape[0] == 0:
            devmem.untrack(self)
            return None
        out = DeltaShard(new_base, self._rows.shape[1], self._rows.dtype,
                         self.capacity, self.metric, self.base, self.device)
        out.append(np.asarray(tail_rows), new_base)
        devmem.untrack(self)
        return out


def merge_topk(d_main: np.ndarray, i_main: np.ndarray,
               d_delta: np.ndarray, i_delta: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Union-merge two ascending top-k lists into one (Q, k) result.
    Duplicate ids keep their best distance: a swap landing between the two
    scans may briefly cover a row twice."""
    d = np.concatenate([np.asarray(d_main, np.float32),
                        np.asarray(d_delta, np.float32)], axis=1)
    i = np.concatenate([np.asarray(i_main, np.int32),
                        np.asarray(i_delta, np.int32)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")
    d = np.take_along_axis(d, order, axis=1)
    i = np.take_along_axis(i, order, axis=1)
    # duplicate suppression: rows are distance-sorted, so a stable
    # id-sort keeps the BEST occurrence first within each id run
    ido = np.argsort(i, axis=1, kind="stable")
    si = np.take_along_axis(i, ido, axis=1)
    dup_sorted = np.zeros_like(si, bool)
    dup_sorted[:, 1:] = (si[:, 1:] == si[:, :-1]) & (si[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, ido, dup_sorted, axis=1)
    d = np.where(dup, _MAX_DIST, d)
    i = np.where(dup, np.int32(-1), i)
    order = np.argsort(d, axis=1, kind="stable")
    d = np.take_along_axis(d, order, axis=1)[:, :k]
    i = np.take_along_axis(i, order, axis=1)[:, :k]
    if d.shape[1] < k:
        q = d.shape[0]
        d = np.concatenate(
            [d, np.full((q, k - d.shape[1]), _MAX_DIST, np.float32)],
            axis=1)
        i = np.concatenate(
            [i, np.full((q, k - i.shape[1]), -1, np.int32)], axis=1)
    return d, i.astype(np.int32)
