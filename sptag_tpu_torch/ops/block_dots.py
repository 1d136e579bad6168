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
    headline (Q=1024, nprobe=8, P=256, D=128, C=894) the distinct probed
    blocks are at most 894*256*128*4 B = 117 MB, plus 0.5 MB of queries and
    8.4 MB of output: about 126 MB, so at least 38 us at 3.35 TB/s; the
    0.54 GFLOP take 8 us at the 67 TFLOP/s float32 rate.  int8: one CTA per
    (query, probe) pair holds the query row in shared memory and streams the
    P x D block with coalesced 16-byte loads, several lanes per row, into
    ``__dp4a`` with exact int32 sums, reduced with ``__shfl_xor_sync``.
    float32: block-major (below).

group_block_dots
    Replaces ``sptag_tpu/ops/pallas_kernels.py::group_block_dots``
    (``pallas_call`` at line 214).  At the int8 grouped shapes (NG=32, U=32,
    G=32, P=256, D=128, C~250) the bytes are at most 6.6 MB of blocks, 0.1
    MB of queries and 33.6 MB of int32 output: 40 MB, 12 us at 3.35 TB/s.
    The 2.15 GOP take 1.1 us at the 1,979 TOP/s int8 tensor-core rate, but
    16 us on ``__dp4a`` (estimated 132 SMs x 64 dp4a/clock x 8 ops x 1.98
    GHz = 134 TOP/s).  int8: one CTA per (group, union slot) stages the
    (G, D) query tile (8, 16 or 32 rows, the least that holds G) and the
    block in shared-memory row tiles and keeps a 2 x 4 accumulator tile per
    thread in registers (dp4a).  At the f32 grouped shapes (NG=128, U=16,
    G=8) the bound is bytes too: at most 117 MB of distinct blocks and 16.8
    MB of output, 40 us.  float32: block-major (below).

float32, both functions: block-major
    Turned block-major, the two are one operation.  Entry e of the output
    (row e of ``(Q * nprobe, P)`` or ``(NG * U * G, P)``) scores query row
    ``(e // G // U) * G + e % G`` against block ``ids.flat[e // G]`` (the
    probe function is G = 1, U = nprobe).  A probe-major kernel reads each
    block once per (query, probe) pair — 8,192 x 128 KB = 1.07 GB per
    headline call, mostly from HBM because the 117 MB block set exceeds the
    50 MB L2 — so it sits at the HBM roof of its own design.  Here a
    single-CTA prep kernel sorts the entries by block id on the card (a
    counting sort: histogram, exclusive scan, scatter, one shared atomic
    per id slot of G entries; out-of-range ids go to an extra bucket C that
    scores zeros) and cuts each block's list into tiles of at most
    ``TILE_ENTRIES`` entries, so a hot block (padding queries, the grouped
    path's clamped empty slots) spreads over several CTAs.  Each CTA
    streams its block's P rows once, and its entries' query rows beside
    them, through a 3-stage ``cp.async`` ring in shared memory, 16 floats
    of D per stage, into float32 FFMA: thread t owns block row t of a
    256-row pass (rows t and t + 128 in the group kernel) and all of the
    tile's entries in registers (a uniform branch skips entries past the
    tile's count), and stores each entry's dots as coalesced row pieces.
    Blocks read per call: at most (distinct blocks) + E / TILE_ENTRIES
    instead of E or NG * U.  The grid is sized
    on the host from the bound ``min(E, ceil(E / TILE_ENTRIES) + C)``
    (``tile_bound``); CTAs past the real tile count exit at once, so the
    wrapper never waits for the card.

    Summation order.  An L2 distance ``|q|^2 + |x|^2 - 2 q.x`` cancels most
    of a dot's magnitude (dots ~2,000 for distances ~200 at the headline),
    so float32 rounding in the dot shows in the distance, and the card's
    search is held to the CPU's within rtol 1e-5.  The plain versions'
    contractions on the CPU sum differently: the probe function's batched
    matrix-vector product in SIMD partial sums (close to the exact dot), the
    group function's matrix product in one chain per output.  So each
    function keeps the order of the kernel it replaces: probe sums each
    16-wide slice of D in one chain and adds the slices in ascending order
    (as accurate as a tree of partial sums); group runs one chain over D.
    Each output element is computed by one CTA in that fixed order, so the
    result is deterministic although the order inside a block's entry list
    is not.

    Why FFMA and not the tensor cores: 3xTF32 ``mma.sync.m16n8k8`` (x =
    big + small, both TF32, three products) was built and measured on the
    H100.  The tensor core's float32 sums truncate, which biased headline
    dots toward zero by ~1e-6 of their value and missed the rtol above;
    zeroed per-k8-step accumulators added in round-to-nearest FADDs cut the
    bias tenfold but still missed, and no order of tensor-core sums matches
    a one-chain CPU matrix product.  The bound is bytes: the headline's
    0.54 / 1.07 GFLOP take 8 / 16 us at the float32 FFMA rate, against 38 /
    40 us for the bytes.  ``block_major_prep_reference`` is the plain
    version of the prep.
"""

from __future__ import annotations

import ctypes

import torch

from sptag_tpu_torch import _build
from sptag_tpu_torch.ops import distance as dist_ops

#: entries (query rows) per tile of the block-major float32 kernel: the
#: plain prep's default, replaced by the library's own tile when it loads
TILE_ENTRIES = 32

#: launches of each CUDA kernel (plain ints; the CPU path never counts)
probe_f32_launches = 0
probe_i8_launches = 0
group_f32_launches = 0
group_i8_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
# int8: (blocks, queries, ids, out, C, P, D, [Q, nprobe | NG, U, G], vec,
# stream); float32: (blocks, queries, ids, out, scratch, C, P, D, E, U, G,
# vec, sliced, stream); prep: (ids, scratch, E, G, C, stream)
_SIGNATURES = {
    "sptag_probe_block_dots_i8": (_I, (_P,) * 4 + (_I,) * 6 + (_P,)),
    "sptag_group_block_dots_i8": (_I, (_P,) * 4 + (_I,) * 7 + (_P,)),
    "sptag_block_dots_f32": (_I, (_P,) * 5 + (_I,) * 8 + (_P,)),
    "sptag_block_major_prep": (_I, (_P,) * 2 + (_I,) * 3 + (_P,)),
    "sptag_block_major_tile_entries": (_I, ()),
}
_SMEM_LIMIT = 48 * 1024       # the int8 probe kernel's query row in smem


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
    """The built kernel library (compiled at first use); its tile size
    becomes ``TILE_ENTRIES``."""
    global TILE_ENTRIES
    lib = _build.load("block_dots", _SIGNATURES)
    TILE_ENTRIES = lib.sptag_block_major_tile_entries()
    return lib


def tile_bound(E: int, C: int, nt: int | None = None) -> int:
    """Most tiles the block-major prep can emit for E entries over C
    blocks: C + 1 buckets (the last for out-of-range ids) cut into tiles of
    at most `nt` (``TILE_ENTRIES``) entries, and never more than one tile
    per entry."""
    nt = nt or TILE_ENTRIES
    return min(E, -(-E // nt) + C)


def block_major_prep_reference(ids: torch.Tensor, G: int, C: int,
                               nt: int | None = None):
    """Plain version of the block-major prep (what the CUDA prep kernel
    computes, with a stable order inside each block).  Entry e has block
    ``ids.flat[e // G]``, or bucket C when that lies outside [0, C).

    Returns (order, tiles): the E entries sorted by bucket, int32; and the
    tile table, int32 (T, 3) rows of (bucket, first position in `order`,
    entry count <= nt), buckets ascending."""
    nt = nt or TILE_ENTRIES
    dev = ids.device
    b = ids.reshape(-1).to(torch.int64)
    b = torch.where((b >= 0) & (b < C), b, C)
    bucket = torch.repeat_interleave(b, G)
    order = torch.argsort(bucket, stable=True).to(torch.int32)
    counts = torch.bincount(bucket, minlength=C + 1)
    starts = torch.cumsum(counts, 0) - counts
    ntile = (counts + nt - 1) // nt
    tb = torch.repeat_interleave(torch.arange(C + 1, device=dev), ntile)
    tile_start = torch.cumsum(ntile, 0) - ntile
    within = torch.arange(tb.numel(), device=dev) - tile_start[tb]
    first = starts[tb] + within * nt
    count = torch.clamp(counts[tb] - within * nt, max=nt)
    tiles = torch.stack([tb, first, count], 1).to(torch.int32)
    return order, tiles


def _scratch(E: int, C: int, device) -> torch.Tensor:
    """The prep's int32 scratch: tile count (padded to 4), the int4 tile
    table, the sorted entries, C + 1 bucket counters."""
    return torch.empty(4 + 4 * tile_bound(E, C) + E + C + 1,
                       dtype=torch.int32, device=device)


def block_major_prep(ids: torch.Tensor, G: int, C: int):
    """The block-major prep on the device of `ids`: the plain version on
    the CPU, the CUDA prep kernel on the card (which the float32 wrappers
    run as part of their own call).  Returns (order, tiles, ntiles): on the
    card `tiles` has ``tile_bound`` rows, of which the first ``ntiles`` (a
    one-element device tensor) are real, and the order inside a block's
    list is free."""
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        raise TypeError("block_major_prep: takes contiguous int32 ids")
    E = ids.numel() * G
    if ids.device.type == "cpu":
        order, tiles = block_major_prep_reference(ids, G, C)
        return order, tiles, torch.tensor([tiles.shape[0]], dtype=torch.int32)
    lib = library()                      # sets TILE_ENTRIES for the bound
    bound = tile_bound(E, C)
    scratch = _scratch(E, C, ids.device)
    if E:
        with torch.cuda.device(ids.device):
            rc = lib.sptag_block_major_prep(
                ids.data_ptr(), scratch.data_ptr(), E, G, C,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"block_major_prep: CUDA launch failed ({rc})")
    else:
        scratch[0] = 0
    tiles = scratch[4:4 + 4 * bound].view(bound, 4)[:, :3]
    order = scratch[4 + 4 * bound:4 + 4 * bound + E]
    return order, tiles, scratch[:1]


def _block_dots_f32(blocks, queries, ids, out, U: int, G: int,
                    what: str) -> None:
    """Launch the block-major float32 kernel (prep included) into `out`;
    the probe function (G = 1) sums each dot slice by slice, the group
    function in one chain (module notes)."""
    C, P, D = blocks.shape
    E = ids.numel() * G
    if E >= 2 ** 31:
        raise ValueError(f"{what}: {E} entries exceed the kernel's int32 "
                         "entry index")
    vec = _vec_ok(D * 4, 16, blocks, queries)
    dev = blocks.device
    fn = library().sptag_block_dots_f32  # sets TILE_ENTRIES for the scratch
    scratch = _scratch(E, C, dev)
    args = (blocks.data_ptr(), queries.data_ptr(), ids.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), C, P, D, E, U, G, vec,
            int(what == "probe_block_dots"),
            torch.cuda.current_stream(dev).cuda_stream)
    # the kernel launches on the current device: switch only when `dev`
    # is another one
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed ({rc})")


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
    if not is_i8:
        _block_dots_f32(blocks, queries, topc, out, nprobe, 1,
                        "probe_block_dots")
        probe_f32_launches += 1
        return out
    if D > _SMEM_LIMIT:
        raise ValueError(f"probe_block_dots: D={D} exceeds the int8 "
                         "kernel's shared-memory query row")
    vec = _vec_ok(D, 16, blocks, queries)
    with torch.cuda.device(blocks.device):
        rc = library().sptag_probe_block_dots_i8(
            blocks.data_ptr(), queries.data_ptr(), topc.data_ptr(),
            out.data_ptr(), C, P, D, Q, nprobe, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_block_dots: CUDA launch failed ({rc})")
    probe_i8_launches += 1
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
    if not is_i8:
        _block_dots_f32(blocks, queries, union, out, U, G,
                        "group_block_dots")
        group_f32_launches += 1
        return out
    vec = _vec_ok(D, 4, blocks, queries)
    with torch.cuda.device(blocks.device):
        rc = library().sptag_group_block_dots_i8(
            blocks.data_ptr(), queries.data_ptr(), union.data_ptr(),
            out.data_ptr(), C, P, D, NG, U, G, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_block_dots: CUDA launch failed ({rc})")
    group_i8_launches += 1
    return out
