"""Carry the JAX package's state into the port.

The two packages draw different random numbers, so they build different
trees from the same corpus and seed.  To compute the same thing in both,
hand the port the JAX side's state as numpy arrays:

* ``sptag_tpu_torch.algo.dense.DenseTreeSearcher.from_layout(lay, ...)``
  takes the dict of ``sptag_tpu.algo.dense.DenseTreeSearcher.build_layout``;
* ``bkt_index_from_arrays`` rebuilds a BKT index from a corpus, a tree
  forest, tombstones, a graph and ``save_index_config()`` text.

Folders are interchangeable too: either package loads the other's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sptag_tpu_torch.core.index import VectorIndex, create_instance
from sptag_tpu_torch.core.types import dtype_of
from sptag_tpu_torch.device import DeviceLike
from sptag_tpu_torch.trees.bktree import BKTree
from sptag_tpu_torch.utils.ini import IniReader


def bkt_index_from_arrays(host: np.ndarray, tree_starts: np.ndarray,
                          tree_nodes: np.ndarray,
                          deleted: Optional[np.ndarray],
                          graph: Optional[np.ndarray], ini_text: str,
                          device: DeviceLike = None) -> VectorIndex:
    """A port BKT index holding exactly the given state.  `ini_text` is an
    ``indexloader.ini`` (``save_index_config()``); `host` the stored —
    already normalized — corpus."""
    reader = IniReader.loads(ini_text)
    index = create_instance(reader.get_parameter("Index", "IndexAlgoType"),
                            reader.get_parameter("Index", "ValueType"),
                            device)
    index.params.load_config(reader.section_items("Index"))
    p = index.params
    index._host = np.ascontiguousarray(host, dtype_of(index.value_type))
    index._n = index._host.shape[0]
    index._deleted = (np.zeros(index._n, bool) if deleted is None
                      else np.asarray(deleted, bool)[:index._n].copy())
    index._num_deleted = int(index._deleted.sum())
    index._tree = BKTree.from_arrays(
        tree_starts, tree_nodes, kmeans_k=p.kmeans_k, leaf_size=p.leaf_size,
        samples=p.samples, metric=int(index.dist_calc_method),
        base=index.base, device=index.device)
    index._graph = (np.full((index._n, p.neighborhood_size), -1, np.int32)
                    if graph is None else np.asarray(graph, np.int32))
    return index
