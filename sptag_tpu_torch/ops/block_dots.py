"""Block-dot products of the dense search: hand-written Hopper kernels and
their plain PyTorch versions.

The dense tree-partition search (algo/dense.py) scores each query against
every row of the corpus blocks it probes.  Gathering those blocks first
would materialise a (Q, nprobe, P, D) tensor — about 1 GB for a 1,024-query
chunk at the headline shapes — only for a contraction to read it back.  The
kernels in ``csrc/block_dots.cu`` never build it: each CTA loads its own
block id and streams that block from device memory straight into the dot
products.

Routing is by device and nothing else: a CPU tensor goes to the plain
version (``*_reference``), a CUDA tensor to the kernel, which raises when it
does not build or launch.  Only the dot products are computed here; the
metric composition (``|q|^2 + |x|^2 - 2 q.x`` / ``base^2 - dot``) stays with
the caller.

probe_block_dots
    Replaces ``sptag_tpu/ops/pallas_kernels.py::probe_block_dots``
    (``pallas_call`` at line 151).  Bound on the H100: bytes.  At the f32
    headline (Q=1024, nprobe=8, P=256, D=128, C=904) the distinct probed
    blocks are at most 904*256*128*4 B = 118.5 MB, plus 0.5 MB of queries and
    8.4 MB of output: about 127 MB, so at least 38 us at 3.35 TB/s; the
    0.54 GFLOP take 8 us at the 67 TFLOP/s float32 rate.  Design: one CTA
    per (query, probe) pair holds the query row in shared memory and streams
    the P x D block with coalesced 16-byte loads, several lanes per row,
    reduced with ``__shfl_xor_sync``; float32 uses FFMA only (no TF32, which
    HIGHEST parity forbids), int8 uses ``__dp4a`` with exact int32 sums.  A
    block probed by many queries of a chunk is read once per pair (from L2
    when it is still resident), not once per chunk: cross-query block reuse
    is later work.

group_block_dots
    Replaces ``sptag_tpu/ops/pallas_kernels.py::group_block_dots``
    (``pallas_call`` at line 214).  At the int8 grouped shapes (NG=32, U=32,
    G=32, P=256, D=128, C~200) the bytes are at most 6.6 MB of blocks, 0.1
    MB of queries and 33.6 MB of int32 output: 40 MB, 12 us at 3.35 TB/s.
    The 2.15 GOP take 1.1 us at the 1,979 TOP/s int8 tensor-core rate, but
    16 us on ``__dp4a`` (estimated 132 SMs x 64 dp4a/clock x 8 ops x 1.98
    GHz = 134 TOP/s): with dp4a the kernel is bound by operations, with IMMA
    it would be bound by its int32 output.  Design: one CTA per (group,
    union slot) stages the (G, D) query tile (8, 16 or 32 rows, the least
    that holds G) and the block in shared-memory row tiles and keeps a 2 x 4
    accumulator tile per thread in registers (FFMA for float32, dp4a for
    int8).  Tensor cores (IMMA / ``wgmma`` for int8, split-TF32 for float32)
    are later work.
"""

from __future__ import annotations

import ctypes

import torch

from sptag_tpu_torch import _build
from sptag_tpu_torch.ops import distance as dist_ops

#: launches of each CUDA kernel (plain ints; the CPU path never counts)
probe_f32_launches = 0
probe_i8_launches = 0
group_f32_launches = 0
group_i8_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
# (blocks, queries, ids, out, C, P, D, [Q, nprobe | NG, U, G], vec, stream)
_SIGNATURES = {
    f"sptag_{kind}_block_dots_{t}": (_I, (_P,) * 4 + (_I,) * n + (_P,))
    for kind, n in (("probe", 6), ("group", 7)) for t in ("f32", "i8")}
_SMEM_LIMIT = 48 * 1024       # the probe kernel's query row in shared memory


def launch_counts() -> dict:
    return {"probe_block_dots_f32": probe_f32_launches,
            "probe_block_dots_i8": probe_i8_launches,
            "group_block_dots_f32": group_f32_launches,
            "group_block_dots_i8": group_i8_launches}


def reset_launch_counts() -> None:
    global probe_f32_launches, probe_i8_launches
    global group_f32_launches, group_i8_launches
    probe_f32_launches = probe_i8_launches = 0
    group_f32_launches = group_i8_launches = 0


def library() -> ctypes.CDLL:
    """The built kernel library (compiled at first use)."""
    return _build.load("block_dots", _SIGNATURES)


def probe_block_dots_reference(blocks: torch.Tensor, queries: torch.Tensor,
                               topc: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the probed blocks, then one einsum."""
    gathered = blocks[topc.long()]                       # (Q, nprobe, P, D)
    if blocks.dtype == torch.int8:
        return dist_ops.int_contract("qd,qjpd->qjp", queries,
                                     gathered).to(torch.int32)
    return torch.einsum("qd,qjpd->qjp", queries, gathered)


def group_block_dots_reference(blocks: torch.Tensor, queries: torch.Tensor,
                               union: torch.Tensor) -> torch.Tensor:
    """Plain version: (NG, U, G, P) from the gathered union blocks."""
    NG = union.shape[0]
    G = queries.shape[0] // NG
    gathered = blocks[union.long()]                      # (NG, U, P, D)
    qg = queries.reshape(NG, G, queries.shape[1])
    if blocks.dtype == torch.int8:
        return dist_ops.int_contract("gqd,gupd->guqp", qg,
                                     gathered).to(torch.int32)
    return torch.einsum("gqd,gupd->guqp", qg, gathered)


def _check(blocks, queries, ids, what: str) -> None:
    if blocks.dim() != 3 or queries.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"{what}: expected (C,P,D) blocks, (Q,D) queries "
                         f"and 2-D ids, got {tuple(blocks.shape)}, "
                         f"{tuple(queries.shape)}, {tuple(ids.shape)}")
    if queries.shape[1] != blocks.shape[2]:
        raise ValueError(f"{what}: query dim {queries.shape[1]} != block "
                         f"dim {blocks.shape[2]}")
    if blocks.dtype not in (torch.float32, torch.int8) \
            or queries.dtype != blocks.dtype:
        raise TypeError(f"{what}: takes float32 or int8 blocks with queries "
                        f"of the same type, got {blocks.dtype} / "
                        f"{queries.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"{what}: block ids must be int32, got {ids.dtype}")
    devs = {blocks.device, queries.device, ids.device}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on different devices {devs}")
    dev = blocks.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and not (blocks.is_contiguous()
                                   and queries.is_contiguous()
                                   and ids.is_contiguous()):
        raise ValueError(f"{what}: the CUDA kernel takes contiguous tensors")


def _vec_ok(row_bytes: int, align: int, *tensors) -> int:
    return int(row_bytes % align == 0
               and all(t.data_ptr() % align == 0 for t in tensors))


def probe_block_dots(blocks: torch.Tensor, queries: torch.Tensor,
                     topc: torch.Tensor) -> torch.Tensor:
    """(C, P, D) blocks, (Q, D) queries, (Q, nprobe) int32 block ids ->
    (Q, nprobe, P) dots: float32 for float32 blocks, exact int32 for int8
    blocks (int8 queries).  Block ids must lie in [0, C)."""
    global probe_f32_launches, probe_i8_launches
    _check(blocks, queries, topc, "probe_block_dots")
    if topc.shape[0] != queries.shape[0]:
        raise ValueError("probe_block_dots: topc rows != query rows")
    if blocks.device.type == "cpu":
        return probe_block_dots_reference(blocks, queries, topc)
    C, P, D = blocks.shape
    Q, nprobe = topc.shape
    is_i8 = blocks.dtype == torch.int8
    out = torch.empty((Q, nprobe, P),
                      dtype=torch.int32 if is_i8 else torch.float32,
                      device=blocks.device)
    if out.numel() == 0:
        return out
    if D * blocks.element_size() > _SMEM_LIMIT:
        raise ValueError(f"probe_block_dots: D={D} exceeds the kernel's "
                         "shared-memory query row")
    vec = _vec_ok(D * blocks.element_size(), 16, blocks, queries)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = (library().sptag_probe_block_dots_i8 if is_i8
              else library().sptag_probe_block_dots_f32)
        rc = fn(blocks.data_ptr(), queries.data_ptr(), topc.data_ptr(),
                out.data_ptr(), C, P, D, Q, nprobe, vec, stream)
    if rc != 0:
        raise RuntimeError(f"probe_block_dots: CUDA launch failed ({rc})")
    if is_i8:
        probe_i8_launches += 1
    else:
        probe_f32_launches += 1
    return out


def group_block_dots(blocks: torch.Tensor, queries: torch.Tensor,
                     union: torch.Tensor) -> torch.Tensor:
    """(C, P, D) blocks, (Q, D) queries sorted into NG groups of G = Q/NG,
    (NG, U) int32 per-group block ids -> (NG, U, G, P) dots (float32, or
    exact int32 for int8).  Block ids must lie in [0, C)."""
    global group_f32_launches, group_i8_launches
    _check(blocks, queries, union, "group_block_dots")
    NG, U = union.shape
    Q = queries.shape[0]
    if NG == 0 or Q % NG:
        raise ValueError(f"group_block_dots: {Q} queries do not split into "
                         f"{NG} groups")
    if blocks.device.type == "cpu":
        return group_block_dots_reference(blocks, queries, union)
    C, P, D = blocks.shape
    G = Q // NG
    is_i8 = blocks.dtype == torch.int8
    out = torch.empty((NG, U, G, P),
                      dtype=torch.int32 if is_i8 else torch.float32,
                      device=blocks.device)
    if out.numel() == 0:
        return out
    vec = _vec_ok(D, 4, blocks, queries) if is_i8 else 1
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = (library().sptag_group_block_dots_i8 if is_i8
              else library().sptag_group_block_dots_f32)
        rc = fn(blocks.data_ptr(), queries.data_ptr(), union.data_ptr(),
                out.data_ptr(), C, P, D, NG, U, G, vec, stream)
    if rc != 0:
        raise RuntimeError(f"group_block_dots: CUDA launch failed ({rc})")
    if is_i8:
        group_i8_launches += 1
    else:
        group_f32_launches += 1
    return out
