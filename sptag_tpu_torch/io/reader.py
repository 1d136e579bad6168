"""VectorSetReader — parallel TSV -> binary ingestion (port of
``sptag_tpu/io/reader.py``; host code, the same in both packages).

SPTAG's Helper::VectorSetReader / DefaultReader:

* input line format ``<metadata>\\t<v1><delim><v2><delim>...`` (delimiter
  default ``|``);
* the file is parsed by the native library (sptag_tpu_torch/native.py)
  when g++ can build it, else split into byte blocks on line boundaries
  that threads parse in Python, the results merged in order;
* outputs SPTAG's binary triple: ``vectors.bin`` (int32 rows/cols +
  row-major data), ``metadata.bin`` (concatenated bytes) and
  ``metadataIndex.bin`` (int32 count + (count+1) uint64 offsets);
* ``ReaderOptions{thread_num=32, dimension, delimiter, value_type}``.

A ``BIN:`` input path loads an already-binary vector file instead (the
index builder's convention).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from sptag_tpu_torch.core.types import VectorValueType, dtype_of
from sptag_tpu_torch.core.vectorset import MetadataSet, VectorSet
from sptag_tpu_torch.io import format as fmt


@dataclasses.dataclass
class ReaderOptions:
    """Parity: Helper::ReaderOptions (VectorSetReader.h:19-46)."""

    value_type: VectorValueType = VectorValueType.Float
    dimension: int = 0
    delimiter: str = "|"
    thread_num: int = 32


class VectorSetReader:
    def __init__(self, options: ReaderOptions):
        self.options = options
        self.vectors: Optional[np.ndarray] = None
        self.metadata: Optional[List[bytes]] = None

    # ------------------------------------------------------------------ load

    def load_file(self, path: str) -> bool:
        """Parse the whole TSV file (parallel blocks)."""
        opts = self.options
        with open(path, "rb") as f:
            blob = f.read()
        if not blob:
            return False

        # native C++ parallel parser (native/sptag_host.cpp) when available;
        # dimension probed from the first line if not declared
        dim = opts.dimension or _probe_dim(blob, opts.delimiter)
        if dim > 0:
            from sptag_tpu_torch import native
            parsed = native.parse_tsv(blob, opts.delimiter, dim,
                                      opts.thread_num)
            if parsed is not None:
                vectors, metas = parsed
                if len(vectors):
                    self.vectors = vectors.astype(dtype_of(opts.value_type),
                                                  copy=False)
                    self.metadata = metas
                    return (not opts.dimension
                            or self.vectors.shape[1] == opts.dimension)

        # pure-Python fallback:
        # split into ~thread_num byte blocks on line boundaries
        # (DefaultReader.cpp:200-241)
        n_blocks = max(1, min(opts.thread_num, len(blob) // (1 << 16) + 1))
        bounds = [0]
        step = len(blob) // n_blocks
        for i in range(1, n_blocks):
            pos = blob.find(b"\n", i * step)
            if pos == -1:
                break
            pos += 1
            if pos > bounds[-1]:
                bounds.append(pos)
        bounds.append(len(blob))

        blocks = [(blob[bounds[i]:bounds[i + 1]])
                  for i in range(len(bounds) - 1)]
        parse = lambda b: _parse_block(b, opts)  # noqa: E731
        if len(blocks) > 1:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=len(blocks),
                    thread_name_prefix="reader-parse") as pool:
                parts = list(pool.map(parse, blocks))
        else:
            parts = [parse(blocks[0])]

        vec_parts = [p[0] for p in parts if p[0] is not None and len(p[0])]
        meta_parts = [m for p in parts for m in p[1]]
        if not vec_parts:
            return False
        dims = {v.shape[1] for v in vec_parts}
        if len(dims) != 1:
            return False
        self.vectors = np.concatenate(vec_parts, axis=0)
        self.metadata = meta_parts
        if opts.dimension and self.vectors.shape[1] != opts.dimension:
            return False
        return True

    # ----------------------------------------------------------------- views

    def get_vector_set(self) -> VectorSet:
        return VectorSet(self.vectors, self.options.value_type)

    def get_metadata_set(self) -> Optional[MetadataSet]:
        if self.metadata is None:
            return None
        return MetadataSet(self.metadata)

    # ------------------------------------------------------------------ save

    def save(self, folder: str, vector_file: str = "vectors.bin",
             meta_file: str = "metadata.bin",
             meta_index_file: str = "metadataIndex.bin") -> None:
        os.makedirs(folder, exist_ok=True)
        fmt.write_matrix(os.path.join(folder, vector_file), self.vectors)
        self.get_metadata_set().save(os.path.join(folder, meta_file),
                                     os.path.join(folder, meta_index_file))


def _probe_dim(blob: bytes, delimiter: str) -> int:
    """Dimension of the first parseable line (for undeclared -d)."""
    for line in blob.split(b"\n", 50)[:50]:
        line = line.rstrip(b"\r")
        if not line:
            continue
        tab = line.find(b"\t")
        vec = line[tab + 1:] if tab >= 0 else line
        parts = [p for p in vec.split(delimiter.encode()) if p]
        if parts:
            return len(parts)
    return 0


def _parse_block(block: bytes, opts: ReaderOptions
                 ) -> Tuple[Optional[np.ndarray], List[bytes]]:
    dt = dtype_of(opts.value_type)
    delim = opts.delimiter.encode()
    metas: List[bytes] = []
    rows: List[np.ndarray] = []
    for line in block.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line:
            continue
        tab = line.find(b"\t")
        if tab < 0:
            meta, vec_str = b"", line
        else:
            meta, vec_str = line[:tab], line[tab + 1:]
        parts = [p for p in vec_str.split(delim) if p]
        if not parts:
            continue
        try:
            row = np.asarray([float(p) for p in parts]).astype(dt)
        except ValueError:
            continue
        metas.append(meta)
        rows.append(row)
    if not rows:
        return None, []
    return np.stack(rows), metas


def load_vectors(path: str, options: ReaderOptions
                 ) -> Tuple[VectorSet, Optional[MetadataSet]]:
    """Dispatch on the ``BIN:`` prefix like the builder CLI
    (IndexBuilder/main.cpp:66-78): binary vector file vs TSV."""
    if path.startswith("BIN:"):
        data = fmt.read_matrix(path[4:], dtype_of(options.value_type))
        return VectorSet(data, options.value_type), None
    reader = VectorSetReader(options)
    if not reader.load_file(path):
        raise ValueError(f"failed to parse vector file: {path}")
    return reader.get_vector_set(), reader.get_metadata_set()
