"""VectorIndex — the public API of the port (``sptag_tpu/core/index.py``).

build / search / search_batch / save_index / load_index / create_instance
with the JAX package's semantics and folder format.  Every index lives on a
torch device: ``None`` means the CUDA card (device.py), and the tests pass
``device="cpu"``.  Mutation (add / delete / refine), the write-ahead log,
the delta shard and the observability hooks belong to later slices of the
port and raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import abc
import errno
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Type, Union

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
from sptag_tpu_torch.core.vectorset import MetadataSet, VectorSet, metas_for
from sptag_tpu_torch.device import DeviceLike, resolve_device
from sptag_tpu_torch.io import atomic
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.utils.ini import IniReader

# float32-exact padding distance of every result
MAX_DIST = float(np.float32(3.4e38))

_WAL_NAME = "wal.bin"
_MUTATION = "mutation, WAL and delta shard"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sptag_tpu_torch yet (ROADMAP.md, "
        f"'What the port still lacks': {item})")


@dataclass
class SearchResult:
    """One query's results."""

    ids: np.ndarray                  # (K,) int32, -1 padded
    dists: np.ndarray                # (K,) float32, 3.4e38 padded
    metas: Optional[List[bytes]] = None


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
        if algo == IndexAlgoType.KDT:
            raise not_ported(f"the {algo.name} index", algo.name)
        raise ValueError(f"no index algorithm registered for {algo}")
    return cls(value_type, resolve_device(device))


class VectorIndex(abc.ABC):
    algo: IndexAlgoType = IndexAlgoType.Undefined

    def __init__(self, value_type: VectorValueType, device: torch.device):
        self.value_type = VectorValueType(value_type)
        self.device = device
        self.params: ParamSet = self._make_params()
        self.metadata: Optional[MetadataSet] = None
        self._meta_to_vec: Optional[Dict[bytes, int]] = None
        self._lock = threading.RLock()
        self._meta_file = "metadata.bin"
        self._meta_index_file = "metadataIndex.bin"

    # ---- subclass surface -------------------------------------------------

    @abc.abstractmethod
    def _make_params(self) -> ParamSet: ...

    @abc.abstractmethod
    def _build(self, data: np.ndarray) -> None:
        """Build the index over `data` (already normalized for cosine)."""

    @abc.abstractmethod
    def _search_batch(self, queries: np.ndarray, k: int,
                      max_check: Optional[int] = None,
                      search_mode: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Prepared (Q, D) queries -> ((Q, K) dists, (Q, K) int32 ids),
        ascending, -1 / 3.4e38 padded, deleted rows excluded."""

    @abc.abstractmethod
    def _save_index_data(self, folder: str) -> None: ...

    @abc.abstractmethod
    def _load_index_data(self, folder: str) -> None: ...

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

    # ---- parameters -------------------------------------------------------

    @property
    def dist_calc_method(self) -> DistCalcMethod:
        return DistCalcMethod(getattr(self.params, "dist_calc_method",
                                      DistCalcMethod.L2))

    @property
    def base(self) -> int:
        return base_of(self.value_type)

    def set_parameter(self, name: str, value: str) -> bool:
        return self.params.set_param(name, value)

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
              with_meta_index: bool = False) -> ErrorCode:
        data = self._prepare_vectors(vectors)
        if data.size == 0:
            return ErrorCode.EmptyData
        with self._lock:
            self._build(data)
            self.metadata = metadata
            if with_meta_index and metadata is not None:
                self.build_meta_mapping()
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
        SearchMode for this call only."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.feature_dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.feature_dim}")
        return self._search_batch(self._prepare_query(queries), k, max_check,
                                  search_mode)

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
        dists, ids = self._exact_scan(self._prepare_query(queries),
                                      min(k, self.num_samples))
        return pad_results(dists, ids, k)

    # ---- not in this slice ------------------------------------------------

    def add(self, vectors, metadata=None, with_meta_index=False):
        raise not_ported("add", _MUTATION)

    def delete(self, vectors):
        raise not_ported("delete", _MUTATION)

    def delete_by_metadata(self, meta: bytes):
        raise not_ported("delete_by_metadata", _MUTATION)

    def refine_index(self):
        raise not_ported("refine_index", _MUTATION)

    def merge_index(self, other):
        raise not_ported("merge_index", _MUTATION)

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
        if int(getattr(self.params, "wal_enabled", 0) or 0):
            raise not_ported("WalEnabled=1", _MUTATION)
        if self.need_refine:
            raise not_ported("compaction of a mostly-deleted index",
                             _MUTATION)
        with self._lock:
            existing = os.path.exists(os.path.join(folder, "indexloader.ini"))
            token = f"{os.getpid()}-{threading.get_ident()}"
            target = folder.rstrip("/\\") + f".saving-{token}"
            os.makedirs(target, exist_ok=True)
            with atomic.checked_open(
                    os.path.join(target, "indexloader.ini"), "w") as f:
                f.write(self.save_index_config())
            if self.metadata is not None:
                self.metadata.save(
                    os.path.join(target, self._meta_file),
                    os.path.join(target, self._meta_index_file))
            self._save_index_data(target)
            atomic.write_manifest(target,
                                  exclude=(_WAL_NAME, "indexloader.ini"))
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
                    return ErrorCode.Success
                os.rename(target, folder)
                shutil.rmtree(backup, ignore_errors=True)
            elif not os.path.exists(folder):
                os.rename(target, folder)
            else:
                # a pre-created folder that may hold other files
                _move_files_in(target, folder)
        return ErrorCode.Success

    def load_index_data(self, folder: str, reader: IniReader) -> None:
        with self._lock:
            self.params.load_config(reader.section_items("Index"))
            self._load_index_data(folder)
            if reader.does_section_exist("MetaData"):
                self._meta_file = reader.get_parameter(
                    "MetaData", "MetaDataFilePath", self._meta_file)
                self._meta_index_file = reader.get_parameter(
                    "MetaData", "MetaDataIndexPath", self._meta_index_file)
                self.metadata = MetadataSet.load(
                    os.path.join(folder, self._meta_file),
                    os.path.join(folder, self._meta_index_file))
                if reader.get_parameter("MetaData", "MetaDataToVectorIndex",
                                        "") == "true":
                    self.build_meta_mapping()


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


def load_index(folder: str, device: DeviceLike = None) -> VectorIndex:
    """Load a folder saved by either package (or by SPTAG) onto `device`
    (None: the CUDA card).  The manifest, when present, is verified first."""
    device = resolve_device(device)
    if os.path.exists(os.path.join(folder, "sharded.json")):
        raise not_ported("a sharded (mesh) index folder", "multi-GPU")
    _recover_interrupted_save(folder)
    atomic.verify_manifest(folder)
    reader = IniReader.load(os.path.join(folder, "indexloader.ini"))
    algo = reader.get_parameter("Index", "IndexAlgoType")
    value_type = reader.get_parameter("Index", "ValueType")
    if algo is None or value_type is None:
        raise ValueError("indexloader.ini missing IndexAlgoType/ValueType")
    index = create_instance(algo, value_type, device)
    index.load_index_data(folder, reader)
    if int(getattr(index.params, "wal_enabled", 0) or 0):
        raise not_ported("WalEnabled=1 (WAL replay)", _MUTATION)
    return index
