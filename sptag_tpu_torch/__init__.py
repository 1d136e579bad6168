"""sptag_tpu_torch — the PyTorch/CUDA port of ``sptag_tpu`` for NVIDIA Hopper.

The BKT index — balanced k-means forest plus the RNG graph
(``BuildGraph=1``, the default) — and the KDT index (kd-tree forest, the
same graph, the walk seeded per query from the kd-trees), built, saved and
loaded in the SPTAG folder format and searched with ``SearchMode=dense``
(hand-written CUDA block-dot kernels, ``ops/block_dots.py``,
``csrc/block_dots.cu``), ``beam`` (the batched graph walk,
``algo/engine.py``) or ``auto``; the exact FLAT index; and online mutation
of all three (add, delete, refine, merge, the write-ahead log and the delta
shard), with ``ContinuousBatching=1`` searches through the slot scheduler
(``algo/scheduler.py``); blobs, the capacity estimators and the TSV / BIN
reader (``io/reader.py``); the socket search server and its clients
(``serve/``: server, aggregator, admission, SLO engine, canary,
controller, metrics listener) with the host observability stack
(``utils/``, the card-memory ledger and resumable builds included); the
``AnnIndex`` / ``AnnClient`` wrappers and the ``tools/`` CLIs.  Entry
points run on the CUDA card unless given ``device="cpu"``.
The JAX package ``sptag_tpu`` is the reference; this package imports none
of it.
"""

from sptag_tpu_torch import device  # noqa: F401  (pins float32 precision)
from sptag_tpu_torch.algo import bkt  # noqa: F401  (registers BKT)
from sptag_tpu_torch.algo import flat  # noqa: F401  (registers FLAT)
from sptag_tpu_torch.algo import kdt  # noqa: F401  (registers KDT)
from sptag_tpu_torch.core.index import (SearchResult, VectorIndex,
                                        create_instance,
                                        estimated_hbm_usage,
                                        estimated_memory_usage,
                                        estimated_vector_count, load_index,
                                        load_index_blobs)
from sptag_tpu_torch.core.types import (DistCalcMethod, ErrorCode,
                                        IndexAlgoType, VectorValueType)
from sptag_tpu_torch.core.vectorset import (FileMetadataSet, MetadataSet,
                                            VectorSet)
from sptag_tpu_torch.wrappers import AnnClient, AnnIndex

__all__ = ["AnnClient", "AnnIndex", "DistCalcMethod", "ErrorCode",
           "FileMetadataSet", "IndexAlgoType", "MetadataSet", "SearchResult", "VectorIndex",
           "VectorSet", "VectorValueType", "create_instance",
           "estimated_hbm_usage", "estimated_memory_usage",
           "estimated_vector_count", "load_index", "load_index_blobs"]
