"""VectorSet, MetadataSet and FileMetadataSet (port of
``sptag_tpu/core/vectorset.py``).

Host-side numpy containers, as in the JAX package; the folder metadata
files keep SPTAG's layout: ``metadata.bin`` is the raw concatenation of
the payloads, ``metadataIndex.bin`` an int32 count followed by (count + 1)
uint64 byte offsets (MetadataSet.cpp:22-35).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from sptag_tpu_torch.core.types import VectorValueType, dtype_of, value_type_of
from sptag_tpu_torch.io import format as fmt


class VectorSet:
    """A (count, dim) matrix of vectors of one VectorValueType."""

    def __init__(self, data: np.ndarray,
                 value_type: Optional[VectorValueType] = None):
        data = np.ascontiguousarray(data)
        if data.ndim != 2:
            raise ValueError("VectorSet expects a 2-D array")
        if value_type is None:
            value_type = value_type_of(data.dtype)
        self._value_type = VectorValueType(value_type)
        self._data = data.astype(dtype_of(self._value_type), copy=False)

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def value_type(self) -> VectorValueType:
        return self._value_type

    @property
    def count(self) -> int:
        return self._data.shape[0]

    @property
    def dimension(self) -> int:
        return self._data.shape[1]

    def get_vector(self, i: int) -> np.ndarray:
        return self._data[i]

    def save(self, path_or_stream) -> None:
        """SPTAG's vectors.bin layout: int32 rows, int32 cols, the rows."""
        fmt.write_matrix(path_or_stream, self._data)

    @classmethod
    def load(cls, path_or_stream, value_type: VectorValueType) -> "VectorSet":
        return cls(fmt.read_matrix(path_or_stream, dtype_of(value_type)),
                   value_type)


def metas_for(metadata: Optional["MetadataSet"],
              ids) -> Optional[List[bytes]]:
    """Result metadata for one query's id row: b"" for -1 padding, None
    when there is no store."""
    if metadata is None:
        return None
    return [metadata.get_metadata(int(v)) if v >= 0 else b"" for v in ids]


class MetadataSet:
    """Per-vector opaque byte payloads."""

    def __init__(self, metas: Optional[Iterable[bytes]] = None):
        self._metas: List[bytes] = [bytes(m) for m in metas] if metas else []

    @classmethod
    def from_lines(cls, blob: bytes, offsets: Sequence[int]) -> "MetadataSet":
        return cls(bytes(blob[offsets[i]:offsets[i + 1]])
                   for i in range(len(offsets) - 1))

    @property
    def count(self) -> int:
        return len(self._metas)

    def get_metadata(self, i: int) -> bytes:
        if i < 0 or i >= len(self._metas):
            return b""
        return self._metas[i]

    def add(self, meta: bytes) -> None:
        self._metas.append(bytes(meta))

    def add_batch(self, other: "MetadataSet") -> None:
        self._metas.extend(other._metas)

    def refine(self, indices: Sequence[int]) -> "MetadataSet":
        """The payloads of `indices`, in that order (compaction)."""
        return MetadataSet(self._metas[i] for i in indices)

    def save(self, meta_path_or_stream, index_path_or_stream) -> None:
        blob = b"".join(self._metas)
        offsets = np.zeros(len(self._metas) + 1, dtype=np.uint64)
        np.cumsum([len(m) for m in self._metas], out=offsets[1:])
        with fmt.open_write(meta_path_or_stream) as f:
            f.write(blob)
        with fmt.open_write(index_path_or_stream) as f:
            f.write(struct.pack("<i", len(self._metas)) + offsets.tobytes())

    @classmethod
    def load(cls, meta_path_or_stream, index_path_or_stream) -> "MetadataSet":
        with fmt.open_read(index_path_or_stream) as f:
            idx = f.read()
        (count,) = struct.unpack_from("<i", idx, 0)
        offsets = np.frombuffer(idx, dtype=np.uint64, count=count + 1,
                                offset=4).astype(np.int64)
        with fmt.open_read(meta_path_or_stream) as f:
            blob = f.read()
        return cls.from_lines(blob, offsets.tolist())


class FileMetadataSet(MetadataSet):
    """Metadata read from its file on demand: only the (count + 1)
    offset table is resident (SPTAG's FileMetadataSet), for stores too
    large to hold.  Adds are kept in memory and written on `save`."""

    def __init__(self, meta_path: str, index_path: str):
        super().__init__()
        self._meta_path = meta_path
        self._file = open(meta_path, "rb")
        with fmt.open_read(index_path) as f:
            idx = f.read()
        (self._count,) = struct.unpack_from("<i", idx, 0)
        self._offsets = np.frombuffer(
            idx, dtype=np.uint64, count=self._count + 1,
            offset=4).astype(np.int64)

    @property
    def count(self) -> int:
        return self._count + len(self._metas)

    def get_metadata(self, i: int) -> bytes:
        if i < 0 or i >= self.count:
            return b""
        if i >= self._count:                     # an add kept in memory
            return self._metas[i - self._count]
        start = int(self._offsets[i])
        self._file.seek(start)
        return self._file.read(int(self._offsets[i + 1]) - start)

    def refine(self, indices: Sequence[int]) -> MetadataSet:
        # a compaction materializes the survivors
        return MetadataSet(self.get_metadata(i) for i in indices)

    def save(self, meta_path_or_stream, index_path_or_stream) -> None:
        # saving over the backing file would truncate it under the open
        # handle: read every payload before the target is opened
        in_place = isinstance(meta_path_or_stream, str) and \
            os.path.realpath(meta_path_or_stream) == \
            os.path.realpath(self._meta_path)
        staged = [self.get_metadata(i) for i in range(self.count)] \
            if in_place else None
        sizes = []
        with fmt.open_write(meta_path_or_stream) as f:
            for i in range(self.count):
                m = staged[i] if staged is not None else self.get_metadata(i)
                sizes.append(len(m))
                f.write(m)
        offsets = np.zeros(self.count + 1, dtype=np.uint64)
        np.cumsum(sizes, out=offsets[1:])
        with fmt.open_write(index_path_or_stream) as f:
            f.write(struct.pack("<i", self.count) + offsets.tobytes())
        if in_place:
            # the adds are on disk now: read from the rewritten file
            self._file.close()
            self._file = open(self._meta_path, "rb")
            self._count = len(offsets) - 1
            self._offsets = offsets.astype(np.int64)
            self._metas = []

    def close(self) -> None:
        self._file.close()

    def __del__(self):                            # pragma: no cover
        try:
            self._file.close()
        except (AttributeError, OSError):
            pass


def metadata_from_texts(texts: Iterable[Union[str, bytes]]) -> MetadataSet:
    """A MetadataSet of `texts`, str encoded as UTF-8."""
    return MetadataSet(
        t.encode() if isinstance(t, str) else bytes(t) for t in texts)
