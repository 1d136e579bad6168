"""TPTree — random-projection trees that partition the corpus into small
leaves for the k-NN-graph candidate generation (a copy of
``sptag_tpu/graph/tptree.py``: host numpy, so the same generator gives the
same leaves in both packages).

Parity target: SPTAG's NeighborhoodGraph::PartitionByTptree
(AnnService/inc/Core/Common/NeighborhoodGraph.h:207-341): a random hyperplane
over the top-`numTopDimension`(5) variance dimensions splits each cell, with
100 candidate weight draws scored for balance, recursing until leaves hold at
most `TPTLeafSize`(2000) samples.

The split itself is cheap host math (one projection per cell per level,
vectorized numpy over all ids of the cell), so it stays on the host; the
expensive part — the per-leaf all-pairs join — runs on the device
(ops/graph.leaf_allpairs_topk).  Two deliberate departures from the
reference, both in service of the device side:

* splits are at the **median** projection instead of the mean-of-best-draw:
  every leaf of a tree then lands within one row of the same size, so a whole
  tree's leaves form a single dense (B, P, D) batch with ~zero padding waste —
  the reference's mean splits produce ragged leaves that would burn device
  cycles on padding.
* one weight draw per cell instead of 100 scored draws: with median splits
  the balance objective the 100 draws optimize for (NeighborhoodGraph.h:
  264-323) is already exact.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _split_projection(data: np.ndarray, ids: np.ndarray, top_dims: int,
                      samples: int, rng: np.random.Generator) -> np.ndarray:
    """Projection values of `ids` onto a random hyperplane over the top
    variance dims (reference NeighborhoodGraph.h:219-263)."""
    count = len(ids)
    pick = ids if count <= samples else rng.choice(ids, samples, replace=False)
    sample = data[pick].astype(np.float32)
    var = sample.var(axis=0)
    k = min(top_dims, data.shape[1])
    dims = np.argpartition(var, len(var) - k)[len(var) - k:]
    weights = rng.standard_normal(k).astype(np.float32)
    weights /= max(np.linalg.norm(weights), 1e-12)
    return data[ids][:, dims].astype(np.float32) @ weights


def tpt_partition(data: np.ndarray, leaf_size: int, top_dims: int,
                  samples: int, rng: np.random.Generator,
                  ids: np.ndarray | None = None) -> List[np.ndarray]:
    """Partition rows of `data` into leaves of at most `leaf_size` ids.

    Iterative level-synchronous splitting; returns the list of leaf id
    arrays (near-uniform sizes by construction — median splits).
    """
    if ids is None:
        ids = np.arange(data.shape[0], dtype=np.int64)
    cells = [ids]
    leaves: List[np.ndarray] = []
    while cells:
        next_cells: List[np.ndarray] = []
        for cell in cells:
            if len(cell) <= leaf_size:
                leaves.append(cell)
                continue
            proj = _split_projection(data, cell, top_dims, samples, rng)
            order = np.argsort(proj, kind="stable")
            half = len(cell) // 2
            next_cells.append(cell[order[:half]])
            next_cells.append(cell[order[half:]])
        cells = next_cells
    return leaves
