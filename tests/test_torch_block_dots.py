"""The port's block-dot functions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs ``probe_block_dots`` / ``group_block_dots`` in Pallas interpret
mode, as tests/test_pallas.py does.  Tolerances: float32 dots within
rtol 1e-5, atol 1e-4 on unit-normal data (as test_pallas.py); int8 dots
exactly equal.  The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py compares them with the plain versions there, and
``python3 chip_smoke.py`` does the same at the main path's shapes.  The
block-major kernels' host-side arithmetic (the entry-list prep, the
tile bound, the entry -> query row / output row map) is checked here
against numpy and against the plain versions.
"""

import numpy as np
import pytest
import torch

from sptag_tpu.ops import pallas_kernels
from sptag_tpu_torch import _build
from sptag_tpu_torch.ops import block_dots


def _inputs(rng, C, P, D, Q, int8):
    if int8:
        blocks = rng.integers(-127, 128, (C, P, D)).astype(np.int8)
        queries = rng.integers(-127, 128, (Q, D)).astype(np.int8)
    else:
        blocks = rng.standard_normal((C, P, D)).astype(np.float32)
        queries = rng.standard_normal((Q, D)).astype(np.float32)
    return blocks, queries


def _compare(got, want, int8):
    if int8:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


# (C, P, D, Q, nprobe): aligned, ragged P (not a multiple of 8), D=16,
# ragged P and D (P=300, D=130; D=20)
PROBE_SHAPES = [(7, 32, 128, 4, 3), (5, 13, 128, 6, 2), (9, 40, 16, 5, 4),
                (4, 300, 130, 3, 2), (3, 7, 20, 9, 3)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,P,D,Q,nprobe", PROBE_SHAPES)
def test_probe_block_dots_matches_pallas(C, P, D, Q, nprobe, int8):
    rng = np.random.default_rng(C * 100 + P + D)
    blocks, queries = _inputs(rng, C, P, D, Q, int8)
    topc = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    want = pallas_kernels.probe_block_dots(blocks, queries, topc,
                                           interpret=True)
    got = block_dots.probe_block_dots(torch.from_numpy(blocks),
                                      torch.from_numpy(queries),
                                      torch.from_numpy(topc))
    assert tuple(got.shape) == (Q, nprobe, P)
    _compare(got, want, int8)


# (C, P, D, NG, U, G): G=1 and G=64 too
GROUP_SHAPES = [(9, 32, 128, 4, 5, 8), (5, 13, 128, 2, 3, 32),
                (6, 40, 16, 3, 4, 4), (3, 64, 128, 1, 2, 64),
                (4, 9, 12, 3, 3, 1)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,P,D,NG,U,G", GROUP_SHAPES)
def test_group_block_dots_matches_pallas(C, P, D, NG, U, G, int8):
    rng = np.random.default_rng(C * 100 + P + D + G)
    blocks, queries = _inputs(rng, C, P, D, NG * G, int8)
    union = rng.integers(0, C, (NG, U)).astype(np.int32)
    want = pallas_kernels.group_block_dots(blocks, queries, union,
                                           interpret=True)
    got = block_dots.group_block_dots(torch.from_numpy(blocks),
                                      torch.from_numpy(queries),
                                      torch.from_numpy(union))
    assert tuple(got.shape) == (NG, U, G, P)
    _compare(got, want, int8)


def test_int8_extremes_are_exact():
    """-128 * -128 * D sums well past int16 and float16 range stay exact."""
    blocks = torch.full((2, 4, 128), -128, dtype=torch.int8)
    queries = torch.full((3, 128), -128, dtype=torch.int8)
    topc = torch.zeros((3, 2), dtype=torch.int32)
    out = block_dots.probe_block_dots(blocks, queries, topc)
    assert (out == 128 * 128 * 128).all()
    union = torch.ones((1, 2), dtype=torch.int32)
    out = block_dots.group_block_dots(blocks, queries, union)
    assert (out == 128 * 128 * 128).all()


def test_cpu_tensors_use_the_plain_version_and_never_count():
    block_dots.reset_launch_counts()
    blocks = torch.randn(3, 8, 16)
    queries = torch.randn(4, 16)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    torch.testing.assert_close(
        block_dots.probe_block_dots(blocks, queries, ids),
        block_dots.probe_block_dots_reference(blocks, queries, ids))
    union = torch.zeros((2, 2), dtype=torch.int32)
    torch.testing.assert_close(
        block_dots.group_block_dots(blocks, queries, union),
        block_dots.group_block_dots_reference(blocks, queries, union))
    assert set(block_dots.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["dtype_mix", "int64_ids", "dim", "groups",
                                 "float64"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    blocks = torch.randn(3, 8, 16)
    queries = torch.randn(4, 16)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    if bad == "dtype_mix":
        queries = queries.to(torch.int8)
    elif bad == "int64_ids":
        ids = ids.long()
    elif bad == "dim":
        queries = torch.randn(4, 15)
    elif bad == "float64":
        blocks, queries = blocks.double(), queries.double()
    if bad == "groups":
        with pytest.raises(ValueError):
            block_dots.group_block_dots(blocks, queries,
                                        torch.zeros((3, 2),
                                                    dtype=torch.int32))
        return
    with pytest.raises((TypeError, ValueError)):
        block_dots.probe_block_dots(blocks, queries, ids)


# ---- block-major: the prep and the entry map -------------------------------

NT = block_dots.TILE_ENTRIES


def _prep_ids(case, rng):
    """(ids (rows, cols) int32, G, C) for one prep case."""
    if case == "probe":
        return rng.integers(0, 40, (96, 8)).astype(np.int32), 1, 40
    if case == "group":
        return rng.integers(0, 30, (16, 12)).astype(np.int32), 8, 30
    if case == "hot":                       # one block past NT entries
        ids = rng.integers(0, 9, (200, 3)).astype(np.int32)
        ids[:, 0] = 4
        return ids, 1, 9
    if case == "one_block":
        return np.full((70, 4), 2, np.int32), 1, 5
    if case == "out_of_range":
        return rng.integers(-4, 14, (50, 6)).astype(np.int32), 2, 10
    if case == "wide_c":                    # C far above the blocks used
        ids = rng.integers(0, 6, (40, 4)).astype(np.int32)
        ids[0, 0] = 19_999
        return ids, 3, 20_000
    raise AssertionError(case)


def _numpy_prep(ids, G, C):
    """Per-bucket entry sets and entry counts, straight from the ids."""
    b = ids.reshape(-1).astype(np.int64)
    b = np.where((b >= 0) & (b < C), b, C)
    bucket = np.repeat(b, G)
    sets = {int(k): set(np.flatnonzero(bucket == k).tolist())
            for k in np.unique(bucket)}
    return sets, len(bucket)


@pytest.mark.parametrize("case", ["probe", "group", "hot", "one_block",
                                  "out_of_range", "wide_c"])
def test_block_major_prep_reference_matches_numpy(case):
    rng = np.random.default_rng(len(case))
    ids, G, C = _prep_ids(case, rng)
    sets, E = _numpy_prep(ids, G, C)
    order, tiles = block_dots.block_major_prep_reference(
        torch.from_numpy(ids), G, C)
    order, tiles = order.numpy(), tiles.numpy()
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(E))
    got = {}
    pos = 0
    for b, first, count in tiles.tolist():
        assert first == pos and 1 <= count <= NT     # tiles tile the order
        got.setdefault(b, set()).update(order[first:first + count].tolist())
        pos += count
    assert pos == E and got == sets
    want_tiles = sum(-(-len(v) // NT) for v in sets.values())
    assert len(tiles) == want_tiles
    assert list(tiles[:, 0]) == sorted(tiles[:, 0])
    assert len(tiles) <= block_dots.tile_bound(E, C) \
        == min(E, -(-E // NT) + C)
    valid = [len(v) for k, v in sets.items() if k < C]
    assert (tiles[:, 0] < C).sum() <= len(valid) + E / NT


@pytest.mark.parametrize("C,counts", [
    (3, [NT + 1, NT + 1, NT + 1, NT + 1]),   # every bucket just past a tile
    (5, [1, 1, 1, 1, 1, 1]),                 # one entry per bucket
    (2, [3 * NT, 0, 5]),                     # one hot block, out of range
    (7, [0] * 7 + [NT]),                     # everything out of range
])
def test_tile_bound_holds_at_its_worst(C, counts):
    ids = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    ids = np.where(ids < C, ids, -1).astype(np.int32)[:, None]
    _, tiles = block_dots.block_major_prep_reference(
        torch.from_numpy(ids), 1, C)
    assert len(tiles) == sum(-(-c // NT) for c in counts)
    assert len(tiles) <= block_dots.tile_bound(len(ids), C)


def _block_major_emulation(blocks, queries, ids, U, G):
    """The block-major kernels' work order in plain torch: tile by tile,
    entry e scores query row (e // G // U) * G + e % G against its tile's
    block and lands in output row e.  int8 dots are exact int64 products,
    returned as int32."""
    C, P, D = blocks.shape
    E = ids.numel() * G
    int8 = blocks.dtype == torch.int8
    order, tiles = block_dots.block_major_prep_reference(ids, G, C)
    if int8:
        blocks, queries = blocks.long(), queries.long()
        out = torch.full((E, P), -2 ** 40, dtype=torch.int64)
    else:
        out = torch.full((E, P), float("nan"))
    for b, first, count in tiles.tolist():
        e = order[first:first + count].long()
        if b >= C:
            out[e] = 0
            continue
        q = queries[(e // G // U) * G + e % G]
        out[e] = q @ blocks[b].T
    return out.to(torch.int32) if int8 else out


def _entry_map_case(rng, kind, int8, C, P, D):
    """(blocks, queries, ids, U, G) drawn for the probe or group map, ids
    one past [0, C) on either side."""
    if int8:
        blocks = rng.integers(-128, 128, (C, P, D)).astype(np.int8)
    else:
        blocks = rng.standard_normal((C, P, D)).astype(np.float32)
    rows, U, G = (70, 3, 1) if kind == "probe" else (4, 5, 9)
    ids = rng.integers(-1, C + 1, (rows, U)).astype(np.int32)
    Q = rows if kind == "probe" else rows * G
    if int8:
        queries = rng.integers(-128, 128, (Q, D)).astype(np.int8)
    else:
        queries = rng.standard_normal((Q, D)).astype(np.float32)
    return (torch.from_numpy(blocks), torch.from_numpy(queries),
            torch.from_numpy(ids), U, G)


def _plain_with_dead_ids(kind, blocks, queries, ids):
    """The plain version, with ids outside [0, C) scoring zero."""
    C = blocks.shape[0]
    ref = getattr(block_dots, f"{kind}_block_dots_reference")
    want = ref(blocks, queries, ids.clamp(0, C - 1))
    dead = (ids < 0) | (ids >= C)
    dead = dead.reshape(dead.shape + (1,) * (want.dim() - dead.dim()))
    return torch.where(dead, torch.zeros_like(want), want)


@pytest.mark.parametrize("kind,int8", [("probe", False), ("group", False),
                                       ("probe", True), ("group", True)],
                         ids=["probe", "group", "probe-int8", "group-int8"])
def test_block_major_entry_map_reproduces_the_plain_versions(kind, int8):
    rng = np.random.default_rng(5)
    blocks, queries, ids, U, G = _entry_map_case(rng, kind, int8, 6, 12, 20)
    got = _block_major_emulation(blocks, queries, ids, U, G)
    want = _plain_with_dead_ids(kind, blocks, queries, ids)
    if int8:
        assert torch.equal(got.reshape(want.shape), want)
    else:
        torch.testing.assert_close(got.reshape(want.shape), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["probe", "group"])
def test_block_major_int8_extremes_are_exact(kind):
    """-128 everywhere at D = 128: every dot is 128^3 = 2^21, past float16
    and bfloat16's exact integers, through the int8 kernel's work order."""
    rng = np.random.default_rng(6)
    blocks, queries, ids, U, G = _entry_map_case(rng, kind, True, 4, 8, 128)
    blocks.fill_(-128)
    queries.fill_(-128)
    got = _block_major_emulation(blocks, queries, ids, U, G)
    want = _plain_with_dead_ids(kind, blocks, queries, ids)
    assert torch.equal(got.reshape(want.shape), want)
    live = ((ids >= 0) & (ids < 4)).repeat_interleave(G).reshape(-1)
    assert (got[live] == 128 ** 3).all() and (got[~live] == 0).all()


def test_block_major_prep_on_the_cpu_is_the_plain_version():
    ids = torch.tensor([[3, 1], [1, 7], [0, 1]], dtype=torch.int32)
    order, tiles, ntiles = block_dots.block_major_prep(ids, 2, 4)
    ref_order, ref_tiles = block_dots.block_major_prep_reference(ids, 2, 4)
    assert torch.equal(order, ref_order) and torch.equal(tiles, ref_tiles)
    assert int(ntiles[0]) == len(tiles) == 4         # buckets 0, 1, 3, C
    with pytest.raises(TypeError):
        block_dots.block_major_prep(ids.long(), 2, 4)


def test_library_key_follows_the_source(tmp_path, monkeypatch):
    """Editing a kernel source, or a header of csrc/ it may include, must
    not reuse a stale library."""
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text("#define X 1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "k.cu").write_text("#define X 2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "h.cuh").write_text("#define Y 1\n")
    third = _build.library_path("k")
    assert third != second
    (tmp_path / "h.cuh").write_text("#define Y 2\n")
    assert _build.library_path("k") != third


# ---- the cascade's dense scans: float32 queries q / scale against the
# int8 quantization of a float corpus, through the JAX package's XLA branch
# (sptag_tpu/algo/dense.py:321, :433; use_pallas=False) and the port's
# counterparts on the CPU (the f32i8 block dots' plain versions).  Ids
# equal at every rank whose exact distance is separated from its
# neighbours' by more than their two float32 bounds; every distance within
# 1e-5 * (|q|^2 + |x|^2 + 2 sum |q_d x_d|) (L2) or 1e-5 * sum |q_d x_d|
# (cosine, 1 - q.x) of its id's exact distance in float64.

def _cascade_scan_inputs(metric):
    from sptag_tpu_torch.ops.cascade import quantize_int8

    rng = np.random.default_rng(41 + metric)
    C, P, D, Q = 16, 32, 64, 64
    cent = rng.standard_normal((C, D)).astype(np.float32) * 4
    data = np.repeat(cent, P, 0) + rng.standard_normal((C * P, D))
    q = cent[rng.integers(0, C, Q)] + rng.standard_normal((Q, D))
    if metric == 1:                           # cosine: unit rows, base 1
        data /= np.linalg.norm(data, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    x8, scale = quantize_int8(data.astype(np.float32))
    perm = x8.reshape(C, P, D)
    xf = perm.astype(np.float32)
    cents = xf.mean(1)
    return {"data_perm": perm,
            "member_ids": np.arange(C * P, dtype=np.int32).reshape(C, P),
            "member_sq": (xf * xf).sum(-1),
            "centroids": cents, "cent_sq": (cents * cents).sum(1),
            "deleted": np.zeros(C * P, bool),
            "queries": (q.astype(np.float32) / np.float32(scale))}


def _exact_and_bound(inp, metric, ids):
    x = inp["data_perm"].reshape(-1, inp["data_perm"].shape[-1]) \
        .astype(np.float64)[ids]                       # (Q, k, D)
    q = inp["queries"].astype(np.float64)[:, None, :]
    dot, mag = (q * x).sum(-1), np.abs(q * x).sum(-1)
    if metric == 1:
        return 1.0 - dot, 1e-5 * mag + 1e-6
    qn, xn = (q * q).sum(-1), (x * x).sum(-1)
    return qn + xn - 2 * dot, 1e-5 * (qn + xn + 2 * mag)


@pytest.mark.parametrize("metric", [0, 1], ids=["l2", "cosine"])
@pytest.mark.parametrize("grouped", [False, True],
                         ids=["probe", "grouped"])
def test_cascade_dense_scan_matches_jax_xla_branch(grouped, metric):
    import jax.numpy as jnp

    from sptag_tpu.algo import dense as jdense
    from sptag_tpu_torch.algo import dense as tdense

    inp = _cascade_scan_inputs(metric)
    keys = ("data_perm", "member_ids", "member_sq", "centroids", "cent_sq",
            "deleted", "queries")
    Q, k, nprobe = inp["queries"].shape[0], 10, 2
    if grouped:
        U, G = 8, 8
        d_ref, i_ref = jdense._dense_search_grouped_kernel(
            *(jnp.asarray(inp[n]) for n in keys), jnp.int32(Q), k, nprobe,
            U, G, metric, 1, use_pallas=False)
        d_got, i_got = tdense._dense_search_grouped_kernel(
            *(torch.from_numpy(inp[n]) for n in keys), Q, k, nprobe, U, G,
            metric, 1)
    else:
        d_ref, i_ref = jdense._dense_search_kernel(
            *(jnp.asarray(inp[n]) for n in keys), k, nprobe, metric, 1,
            use_pallas=False)
        d_got, i_got = tdense._dense_search_kernel(
            *(torch.from_numpy(inp[n]) for n in keys), k, nprobe, metric, 1)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d_got, i_got = d_got.numpy(), i_got.numpy()
    assert i_ref.shape == i_got.shape == (Q, k) and (i_ref >= 0).all()
    for d, i in ((d_ref, i_ref), (d_got, i_got)):
        exact, bound = _exact_and_bound(inp, metric, i)
        assert (np.abs(d - exact) <= bound).all()
    exact, bound = _exact_and_bound(inp, metric, i_ref)
    gap = np.abs(np.diff(exact, axis=1)) > bound[:, 1:] + bound[:, :-1]
    sep = np.ones_like(exact, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert sep.mean() > 0.5, "too few separated ranks to compare"
    np.testing.assert_array_equal(i_got[sep], i_ref[sep])
