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
    0.54 GFLOP take 8 us at the 67 TFLOP/s float32 rate.  At the int8
    shapes (C=252) 8.3 MB of blocks and 8.4 MB of int32 output: 16.8 MB,
    5.0 us; the 0.54 GOP take 0.3 us at the 1,979 TOP/s int8 tensor-core
    rate.

group_block_dots
    Replaces ``sptag_tpu/ops/pallas_kernels.py::group_block_dots``
    (``pallas_call`` at line 214).  At the int8 grouped shapes (NG=32, U=32,
    G=32, P=256, D=128, C=252) the bytes are at most 8.3 MB of blocks, 0.1
    MB of queries and 33.5 MB of int32 output: 42 MB, 12.5 us at 3.35 TB/s;
    the 2.15 GOP take 1.1 us at the int8 tensor-core rate.  At the f32
    grouped shapes (NG=128, U=16, G=8) at most 117 MB of distinct blocks
    and 16.8 MB of output, 40 us.

Both functions, both types: block-major
    Turned block-major, the two are one operation.  Entry e of the output
    (row e of ``(Q * nprobe, P)`` or ``(NG * U * G, P)``) scores query row
    ``(e // G // U) * G + e % G`` against block ``ids.flat[e // G]`` (the
    probe function is G = 1, U = nprobe).  A probe-major kernel reads each
    block once per (query, probe) pair — 8,192 x 128 KB = 1.07 GB per f32
    headline call, mostly from HBM because the 117 MB block set exceeds the
    50 MB L2 — so it sits at the HBM roof of its own design.  Here a
    single-CTA prep kernel sorts the entries by block id on the card (a
    counting sort: histogram, exclusive scan, scatter, one shared atomic
    per id slot of G entries; out-of-range ids go to an extra bucket C that
    scores zeros) and cuts each block's list into tiles of at most
    ``TILE_ENTRIES`` entries, so a hot block (padding queries, the grouped
    path's clamped empty slots) spreads over several CTAs.  The prep does
    not look at the blocks' type; one scoring kernel per type runs on its
    tile table, one CTA per tile, streaming its block's P rows once, and
    its entries' query rows beside them, through a 3-stage ``cp.async``
    ring in shared memory, and storing each entry's dots as coalesced row
    pieces.  Blocks read per call: at most (distinct blocks) + E /
    TILE_ENTRIES instead of E or NG * U.  The grid is sized on the host from
    the bound ``min(E, ceil(E / TILE_ENTRIES) + C)`` (``tile_bound``); CTAs
    past the real tile count exit at once, so the wrapper never waits for
    the card.  ``block_major_prep_reference`` is the plain version of the
    prep.

int8 scoring: tensor cores
    The tile is an (entries <= 32) x (P block rows) x (D) int8 product on
    ``mma.sync.m16n8k32`` s8 x s8 -> s32: each of 8 warps owns 32 block rows
    of a 256-row pass (two m16 x four n8 accumulator tiles), 32 bytes of D
    per stage, fragments read from rows padded to 48 bytes so no two of the
    8 rows behind one load share a bank; the accumulators go out through
    shared memory as whole 128-byte lines.  Integer sums are exact in any
    order while |dot| < 2^31, which ``128^2 * D`` guarantees for D < 2^17
    (the wrapper checks), so the result equals the plain version's bit for
    bit.  Unaligned queries or blocks, or D % 16 != 0, stage with byte loads
    instead of 16-byte copies.

float32 queries against int8 blocks
    The cascade (``CascadeSearch``, algo/dense.py) keeps the dense layout
    as the int8 quantization of a float corpus and scores float32 queries
    ``q / scale`` against it: the JAX package's XLA branch
    (``sptag_tpu/algo/dense.py:321`` and ``:433``), which widens the
    gathered int8 blocks to float32 and contracts in float32.  Its kernel
    (``sptag_block_dots_f32i8``: the same prep, then
    ``block_major_f32i8_kernel``) keeps the float32 kernel's tiles and the
    order of every sum, so the result equals the float32 kernel's on
    ``blocks.float()`` bit for bit, but stages the blocks as they are: raw
    int8 rows in a 2-stage ``cp.async`` ring (64 bytes of K a stage, each
    row's 16-byte pieces swizzled so 8 consecutive rows read distinct
    banks; all of K at D = 128 in flight at once), a quarter of the shared
    memory of widened rows.  Each thread owns 2 block rows x 16 entries in
    registers (256 threads, 2 CTAs an SM, both functions) and widens each
    byte just before its FFMAs (byte permute and one add, exact); the
    entry count picks an unrolled routine per 4 entries.  The group form is bound by operations at the cascade's
    G = 32 (full 32-entry tiles), the probe form by bytes (about 9 entries
    a tile).  Its scoring grid is launched as a programmatic dependent of
    the prep, so its CTAs are resident when the tile table lands.  Tuning
    macros (``SPTAG_F32I8_*``) are what ``tools/cuda_kernel_sweep.py``
    varies.
    Counted as ``*_block_dots_f32i8``.

float32 scoring: FFMA
    16 floats of D per stage: thread t owns block row t of a 256-row pass
    (rows t and t + 128 in the group kernel) and all of the tile's entries
    in registers (a uniform branch skips entries past the tile's count).

    Summation order.  An L2 distance ``|q|^2 + |x|^2 - 2 q.x`` cancels most
    of a dot's magnitude (dots ~2,000 for distances ~200 at the headline),
    so float32 rounding in the dot shows in the distance.  This kernel was
    written while the card's search was held to the CPU's within rtol 1e-5,
    and the plain versions' contractions on the CPU sum differently: the
    probe function's batched matrix-vector product in SIMD partial sums
    (close to the exact dot), the group function's matrix product in one
    chain per output.  So each function keeps the order of the kernel it
    replaces: probe sums each 16-wide slice of D in one chain and adds the
    slices in ascending order (as accurate as a tree of partial sums); group
    runs one chain over D.  (The test now bounds each distance's error by
    1e-5 of the magnitudes of its terms, which no longer needs the CPU's
    order.)  Each output element is computed by one CTA in that fixed
    order, so the result is deterministic although the order inside a
    block's entry list is not.

    Why FFMA and not the tensor cores: 3xTF32 ``mma.sync.m16n8k8`` (x =
    big + small, both TF32, three products) was built and measured on the
    H100.  The tensor core's float32 sums truncate, which biased headline
    dots toward zero by ~1e-6 of their value and missed the rtol above;
    zeroed per-k8-step accumulators added in round-to-nearest FADDs cut the
    bias tenfold but still missed, and no order of tensor-core sums matches
    a one-chain CPU matrix product.  The bound is bytes: the headline's
    0.54 / 1.07 GFLOP take 8 / 16 us at the float32 FFMA rate, against 38 /
    40 us for the bytes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from sptag_tpu_torch import _build
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.utils import costmodel

#: entries (query rows) per tile of the block-major kernels: the
#: plain prep's default, replaced by the library's own tile when it loads
TILE_ENTRIES = 32

#: launches of each CUDA kernel (plain ints; the CPU path never counts).
#: Readers, writers and the background worker of a mutating index launch
#: from several threads: every increment holds _count_lock
probe_f32_launches = 0
probe_i8_launches = 0
group_f32_launches = 0
group_i8_launches = 0
probe_f32i8_launches = 0
group_f32i8_launches = 0
_count_lock = threading.Lock()
#: the same launches by card: (kernel name, str(device)) -> launches
_card_launches: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# scoring: (blocks, queries, ids, out, scratch, C, P, D, E, U, G, vec,
# [sliced: float32 only,] stream); prep: (ids, scratch, E, G, C, stream)
_SIGNATURES = {
    "sptag_block_dots_f32": (_I, (_P,) * 5 + (_I,) * 8 + (_P,)),
    "sptag_block_dots_f32i8": (_I, (_P,) * 5 + (_I,) * 8 + (_P,)),
    "sptag_block_dots_i8": (_I, (_P,) * 5 + (_I,) * 7 + (_P,)),
    "sptag_block_major_prep": (_I, (_P,) * 2 + (_I,) * 3 + (_P,)),
    "sptag_block_major_tile_entries": (_I, ()),
}


def launch_counts() -> dict:
    return {"probe_block_dots_f32": probe_f32_launches,
            "probe_block_dots_i8": probe_i8_launches,
            "group_block_dots_f32": group_f32_launches,
            "group_block_dots_i8": group_i8_launches,
            "probe_block_dots_f32i8": probe_f32i8_launches,
            "group_block_dots_f32i8": group_f32i8_launches}


def launch_counts_by_card() -> dict:
    """`launch_counts` split by card: ``str(device)`` -> {kernel:
    launches}, the cards that launched only."""
    with _count_lock:
        out: dict = {}
        for (name, card), n in _card_launches.items():
            out.setdefault(card, {})[name] = n
    return out


def reset_launch_counts() -> None:
    global probe_f32_launches, probe_i8_launches
    global group_f32_launches, group_i8_launches
    global probe_f32i8_launches, group_f32i8_launches
    with _count_lock:
        probe_f32_launches = probe_i8_launches = 0
        group_f32_launches = group_i8_launches = 0
        probe_f32i8_launches = group_f32i8_launches = 0
        _card_launches.clear()


def _count_card(name: str, device) -> None:
    key = (name, str(device))
    _card_launches[key] = _card_launches.get(key, 0) + 1


def variant(blocks: torch.Tensor, queries: torch.Tensor) -> str:
    """The kernel a call takes: "f32", "i8" or "f32i8" (float32 queries
    against int8 blocks)."""
    if blocks.dtype == torch.int8:
        return "f32i8" if queries.dtype == torch.float32 else "i8"
    return "f32"


_lib = None


def library() -> ctypes.CDLL:
    """The built kernel library (compiled at first use); its tile size
    becomes ``TILE_ENTRIES``."""
    global TILE_ENTRIES, _lib
    if _lib is None:
        lib = _build.load("block_dots", _SIGNATURES)
        TILE_ENTRIES = lib.sptag_block_major_tile_entries()
        _lib = lib
    return _lib


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


def _scratch_len(E: int, C: int) -> int:
    """int32 words of the prep's scratch: tile count (padded to 4), the
    int4 tile table, the sorted entries, C + 1 bucket counters."""
    return 4 + 4 * tile_bound(E, C) + E + C + 1


def block_major_prep(ids: torch.Tensor, G: int, C: int):
    """The block-major prep on the device of `ids`: the plain version on
    the CPU, the CUDA prep kernel on the card (which the wrappers run as
    part of their own call).  Returns (order, tiles, ntiles): on the
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
    scratch = torch.empty(_scratch_len(E, C), dtype=torch.int32,
                          device=ids.device)
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


def _block_dots(blocks, queries, ids, shape, U: int, G: int,
                what: str) -> torch.Tensor:
    """Launch the block-major kernel of the blocks' type (prep included);
    returns the dots in `shape`.  float32: the probe function (G = 1) sums
    each dot slice by slice, the group function in one chain (module
    notes); int8: exact int32 on the tensor cores.  One allocation holds
    the output and, behind it, the prep's scratch."""
    C, P, D = blocks.shape
    E = ids.numel() * G
    is_i8 = variant(blocks, queries) == "i8"
    dev = blocks.device
    if E * P == 0:
        return torch.empty(shape, dtype=torch.int32 if is_i8
                           else torch.float32, device=dev)
    if E >= 2 ** 31:
        raise ValueError(f"{what}: {E} entries exceed the kernel's int32 "
                         "entry index")
    if is_i8 and D >= 2 ** 17:
        raise ValueError(f"{what}: D={D} int8 dots may pass 2^31; the "
                         "kernel's int32 sums are exact for D < 2^17")
    vec = _vec_ok(D * blocks.element_size(), 16, blocks, queries)
    lib = library()                      # sets TILE_ENTRIES for the scratch
    n_out = E * P
    n_pad = -(-n_out // 4) * 4           # the scratch starts 16-byte aligned
    buf = torch.empty(n_pad + _scratch_len(E, C), dtype=torch.int32,
                      device=dev)
    args = (blocks.data_ptr(), queries.data_ptr(), ids.data_ptr(),
            buf.data_ptr(), buf.data_ptr() + 4 * n_pad, C, P, D, E, U, G,
            vec)
    if is_i8:
        fn = lib.sptag_block_dots_i8
    else:
        fn = (lib.sptag_block_dots_f32i8 if blocks.dtype == torch.int8
              else lib.sptag_block_dots_f32)
        args += (int(what == "probe_block_dots"),)
    # the current stream's raw handle: building a Stream object for it
    # costs host time on every call
    args += (torch._C._cuda_getCurrentRawStream(dev.index),)
    # the kernel launches on the current device: switch only when `dev`
    # is another one
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed ({rc})")
    out = buf[:n_out]
    return (out if is_i8 else out.view(torch.float32)).view(shape)


def probe_block_dots_reference(blocks: torch.Tensor, queries: torch.Tensor,
                               topc: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the probed blocks, then one einsum."""
    gathered = blocks[topc.long()]                       # (Q, nprobe, P, D)
    if variant(blocks, queries) == "i8":
        return dist_ops.int_contract("qd,qjpd->qjp", queries,
                                     gathered).to(torch.int32)
    return torch.einsum("qd,qjpd->qjp", queries,
                        gathered.to(torch.float32))


def group_block_dots_reference(blocks: torch.Tensor, queries: torch.Tensor,
                               union: torch.Tensor) -> torch.Tensor:
    """Plain version: (NG, U, G, P) from the gathered union blocks."""
    NG = union.shape[0]
    G = queries.shape[0] // NG
    gathered = blocks[union.long()]                      # (NG, U, P, D)
    qg = queries.reshape(NG, G, queries.shape[1])
    if variant(blocks, queries) == "i8":
        return dist_ops.int_contract("gqd,gupd->guqp", qg,
                                     gathered).to(torch.int32)
    return torch.einsum("gqd,gupd->guqp", qg, gathered.to(torch.float32))


def _check(blocks, queries, ids, what: str) -> None:
    if blocks.dim() != 3 or queries.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"{what}: expected (C,P,D) blocks, (Q,D) queries "
                         f"and 2-D ids, got {tuple(blocks.shape)}, "
                         f"{tuple(queries.shape)}, {tuple(ids.shape)}")
    if queries.shape[1] != blocks.shape[2]:
        raise ValueError(f"{what}: query dim {queries.shape[1]} != block "
                         f"dim {blocks.shape[2]}")
    if blocks.dtype not in (torch.float32, torch.int8) \
            or queries.dtype not in (blocks.dtype, torch.float32):
        raise TypeError(f"{what}: takes float32 or int8 blocks with queries "
                        f"of the same type (or float32 queries against int8 "
                        f"blocks), got {blocks.dtype} / {queries.dtype}")
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
    (Q, nprobe, P) dots: float32 for float32 queries (float32 or int8
    blocks), exact int32 for int8 blocks with int8 queries.  Block ids must
    lie in [0, C)."""
    global probe_f32_launches, probe_i8_launches, probe_f32i8_launches
    _check(blocks, queries, topc, "probe_block_dots")
    if topc.shape[0] != queries.shape[0]:
        raise ValueError("probe_block_dots: topc rows != query rows")
    if blocks.device.type == "cpu":
        return probe_block_dots_reference(blocks, queries, topc)
    Q, nprobe = topc.shape
    out = _block_dots(blocks, queries, topc, (Q, nprobe, blocks.shape[1]),
                      nprobe, 1, "probe_block_dots")
    v = variant(blocks, queries)
    with _count_lock:
        if v == "i8":
            probe_i8_launches += 1
        elif v == "f32i8":
            probe_f32i8_launches += 1
        else:
            probe_f32_launches += 1
        _count_card(f"probe_block_dots_{v}", blocks.device)
    return out


def group_block_dots(blocks: torch.Tensor, queries: torch.Tensor,
                     union: torch.Tensor) -> torch.Tensor:
    """(C, P, D) blocks, (Q, D) queries sorted into NG groups of G = Q/NG,
    (NG, U) int32 per-group block ids -> (NG, U, G, P) dots (float32, or
    exact int32 for int8 blocks with int8 queries).  Block ids must lie in
    [0, C)."""
    global group_f32_launches, group_i8_launches, group_f32i8_launches
    _check(blocks, queries, union, "group_block_dots")
    NG, U = union.shape
    Q = queries.shape[0]
    if NG == 0 or Q % NG:
        raise ValueError(f"group_block_dots: {Q} queries do not split into "
                         f"{NG} groups")
    if blocks.device.type == "cpu":
        return group_block_dots_reference(blocks, queries, union)
    G = Q // NG
    out = _block_dots(blocks, queries, union, (NG, U, G, blocks.shape[1]),
                      U, G, "group_block_dots")
    v = variant(blocks, queries)
    with _count_lock:
        if v == "i8":
            group_i8_launches += 1
        elif v == "f32i8":
            group_f32i8_launches += 1
        else:
            group_f32_launches += 1
        _count_card(f"group_block_dots_{v}", blocks.device)
    return out


# ---------------------------------------------------------------------------
# cost-ledger entries (utils/costmodel.py): the JAX package's
# ``pallas.*_block_dots`` families, bound to the wrappers of the Hopper
# kernels that replace the two Pallas kernels.  Bytes are the true block
# traffic (no materialised intermediate), as there.
# ---------------------------------------------------------------------------

def _probe_block_cost(Q, nprobe, P, D, itemsize=4, **_):
    flops = 2.0 * Q * nprobe * P * D
    nbytes = (Q * nprobe * P * D * itemsize + Q * D * itemsize
              + Q * nprobe * P * 4)
    return flops, nbytes


def _group_block_cost(NG, U, G, P, D, itemsize=4, **_):
    flops = 2.0 * NG * U * G * P * D
    nbytes = (NG * U * P * D * itemsize + NG * G * D * itemsize
              + NG * U * G * P * 4)
    return flops, nbytes


costmodel.register("pallas.probe_block_dots", probe_block_dots,
                   _probe_block_cost)
costmodel.register("pallas.group_block_dots", group_block_dots,
                   _group_block_cost)
