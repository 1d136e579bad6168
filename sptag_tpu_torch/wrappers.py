"""AnnIndex / AnnClient — the reference SWIG wrapper surface, natively
(copy of ``sptag_tpu/wrappers.py`` over the port's core index and client).

Parity: the Python module generated from Wrappers/inc/
CoreInterface.h:14-65 and ClientInterface.h:15-60 (modules ``SPTAG`` and
``SPTAGClient``) — the API most reference users actually call
(docs/GettingStart.md, docs/Tutorial.ipynb).  Semantics preserved:

* vectors cross the boundary as raw bytes (ByteArray) OR numpy arrays; the
  declared (valuetype, dimension) pair interprets raw bytes exactly like the
  SWIG typemaps (Wrappers/inc/PythonCommon.i:4-33);
* metadata batches are newline-separated blobs — BuildWithMetaData splits on
  ``\\n`` per vector (CoreInterface.cpp semantics);
* Search returns a result object exposing ids/dists (+ metadata when
  requested) the way QueryResult does;
* AnnClient speaks the wire protocol to a (reference, sptag_tpu or
  sptag_tpu_torch) server, building the same text query CreateSearchQuery
  builds (base64 vector + ``$datatype`` / ``$resultnum`` /
  ``$extractmetadata`` options).

An AnnIndex builds and loads onto the CUDA card unless it is given
``device="cpu"`` (no card: a RuntimeError, never a fallback).
"""

from __future__ import annotations

import base64
from typing import List, Optional, Tuple, Union

import numpy as np

from sptag_tpu_torch.core.index import (
    SearchResult,
    VectorIndex,
    create_instance,
    load_index,
)
from sptag_tpu_torch.core.types import (
    ErrorCode,
    VectorValueType,
    dtype_of,
    enum_from_string,
)
from sptag_tpu_torch.core.vectorset import MetadataSet
from sptag_tpu_torch.device import DeviceLike

Buffer = Union[bytes, bytearray, memoryview, np.ndarray]


def _as_matrix(data: Buffer, value_type: VectorValueType, dimension: int,
               num: Optional[int] = None) -> np.ndarray:
    if isinstance(data, np.ndarray):
        mat = data.astype(dtype_of(value_type), copy=False)
        if mat.ndim == 1:
            mat = mat.reshape(-1, dimension)
        return mat
    flat = np.frombuffer(bytes(data), dtype=dtype_of(value_type))
    mat = flat.reshape(-1, dimension)
    if num is not None:
        mat = mat[:num]
    return mat


def _split_metas(meta: Union[bytes, List[bytes]], num: int) -> MetadataSet:
    """SWIG callers pass one newline-separated blob; list input also works."""
    if isinstance(meta, (list, tuple)):
        metas = [bytes(m) for m in meta]
    else:
        metas = bytes(meta).split(b"\n")
    if metas and metas[-1] == b"":
        metas = metas[:-1]
    if len(metas) < num:
        metas += [b""] * (num - len(metas))
    return MetadataSet(metas[:num])


class AnnIndex:
    """Parity: Wrappers/inc/CoreInterface.h:14-65."""

    def __init__(self, algo_type: str = "BKT", value_type: str = "Float",
                 dimension: int = 0, device: DeviceLike = None):
        self._dimension = dimension
        self._algo = algo_type
        self._value_type = enum_from_string(VectorValueType, value_type)
        self._index: VectorIndex = create_instance(
            algo_type, self._value_type, device=device)
        self._search_params: List[Tuple[str, str]] = []

    # ------------------------------------------------------------ parameters

    def SetBuildParam(self, name: str, value: str) -> None:
        self._index.set_parameter(name, value)

    def SetSearchParam(self, name: str, value: str) -> None:
        self._index.set_parameter(name, value)
        self._search_params.append((name, value))

    # ----------------------------------------------------------------- build

    def Build(self, data: Buffer, num: int) -> bool:
        mat = _as_matrix(data, self._value_type, self._dimension, num)
        self._dimension = self._dimension or mat.shape[1]
        return self._index.build(mat) == ErrorCode.Success

    def BuildWithMetaData(self, data: Buffer, meta, num: int,
                          with_meta_index: bool = False) -> bool:
        mat = _as_matrix(data, self._value_type, self._dimension, num)
        self._dimension = self._dimension or mat.shape[1]
        return self._index.build(
            mat, _split_metas(meta, mat.shape[0]),
            with_meta_index=with_meta_index) == ErrorCode.Success

    def ReadyToServe(self) -> bool:
        return self._index.num_samples > 0

    # ---------------------------------------------------------------- search

    def Search(self, data: Buffer, result_num: int) -> SearchResult:
        mat = _as_matrix(data, self._value_type, self._dimension)
        return self._index.search(mat[0], k=result_num)

    def SearchWithMetaData(self, data: Buffer,
                           result_num: int) -> SearchResult:
        mat = _as_matrix(data, self._value_type, self._dimension)
        return self._index.search(mat[0], k=result_num, with_metadata=True)

    def BatchSearch(self, data: Buffer, vector_num: int, result_num: int,
                    with_meta_data: bool = False
                    ) -> List[SearchResult]:
        mat = _as_matrix(data, self._value_type, self._dimension, vector_num)
        dists, ids = self._index.search_batch(mat, result_num)
        out = []
        for row in range(mat.shape[0]):
            metas = None
            if with_meta_data and self._index.metadata is not None:
                metas = [self._index.metadata.get_metadata(int(v))
                         if v >= 0 else b"" for v in ids[row]]
            out.append(SearchResult(ids[row], dists[row], metas))
        return out

    # -------------------------------------------------------------- mutation

    def Add(self, data: Buffer, num: int) -> bool:
        mat = _as_matrix(data, self._value_type, self._dimension, num)
        self._dimension = self._dimension or mat.shape[1]
        return self._index.add(mat) == ErrorCode.Success

    def AddWithMetaData(self, data: Buffer, meta, num: int) -> bool:
        mat = _as_matrix(data, self._value_type, self._dimension, num)
        return self._index.add(
            mat, _split_metas(meta, mat.shape[0])) == ErrorCode.Success

    def Delete(self, data: Buffer, num: int) -> bool:
        mat = _as_matrix(data, self._value_type, self._dimension, num)
        return self._index.delete(mat) == ErrorCode.Success

    def DeleteByMetaData(self, meta: bytes) -> bool:
        return self._index.delete_by_metadata(
            bytes(meta)) == ErrorCode.Success

    # ----------------------------------------------------------- persistence

    def Save(self, folder: str) -> bool:
        return self._index.save_index(folder) == ErrorCode.Success

    @classmethod
    def Load(cls, folder: str, device: DeviceLike = None) -> "AnnIndex":
        index = load_index(folder, device=device)
        self = cls.__new__(cls)
        self._index = index
        self._value_type = index.value_type
        self._algo = index.algo.name
        self._dimension = index.feature_dim
        self._search_params = []
        return self

    @classmethod
    def Merge(cls, folder1: str, folder2: str,
              device: DeviceLike = None) -> "AnnIndex":
        """Parity: AnnIndex::Merge — load both, re-add the second into the
        first (VectorIndex::MergeIndex, VectorIndex.cpp:246-268)."""
        a = load_index(folder1, device=device)
        b = load_index(folder2, device=device)
        a.merge_index(b)
        self = cls.__new__(cls)
        self._index = a
        self._value_type = a.value_type
        self._algo = a.algo.name
        self._dimension = a.feature_dim
        self._search_params = []
        return self

    # --------------------------------------------------------------- access

    @property
    def index(self) -> VectorIndex:
        """The underlying native index (no reference counterpart — the SWIG
        wrapper hides it; exposed here because Python users want it)."""
        return self._index


class AnnClient:
    """Parity: Wrappers/inc/ClientInterface.h:15-60 — remote search over the
    wire protocol, queries built like CreateSearchQuery (base64 vector)."""

    def __init__(self, server_addr: str, server_port: Union[str, int]):
        from sptag_tpu_torch.serve.client import AnnClient as _Transport

        self._transport = _Transport(server_addr, int(server_port))
        self._timeout_ms = 9000
        self._params: List[Tuple[str, str]] = []
        try:
            self._transport.connect()
        except OSError:
            pass

    def SetTimeoutMilliseconds(self, timeout_ms: int) -> None:
        self._timeout_ms = timeout_ms

    def SetSearchParam(self, name: str, value: str) -> None:
        self._params.append((name, value))

    def ClearSearchParam(self) -> None:
        self._params.clear()

    def IsConnected(self) -> bool:
        return self._transport.is_connected

    def Search(self, data: Buffer, result_num: int, value_type: str,
               with_meta_data: bool = False):
        vt = enum_from_string(VectorValueType, value_type)
        if isinstance(data, np.ndarray):
            raw = data.astype(dtype_of(vt), copy=False).tobytes()
        else:
            raw = bytes(data)
        parts = [f"$datatype:{vt.name}", f"$resultnum:{result_num}"]
        if with_meta_data:
            parts.append("$extractmetadata:true")
        parts += [f"${n}:{v}" for n, v in self._params]
        parts.append("#" + base64.b64encode(raw).decode())
        return self._transport.search(" ".join(parts),
                                      timeout_s=self._timeout_ms / 1000.0)
