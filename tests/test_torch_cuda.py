"""Tests of the PyTorch port that need a CUDA card.

They carry the ``cuda`` marker and skip without a card.  This file imports
neither jax nor sptag_tpu, so it also runs where only the port is
installed; on the card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures jax for the JAX package's
suite.)  Tolerances: float32 kernel dots against the plain versions within
rtol 1e-5, atol 1e-4 on unit-normal data; int8 exactly equal; searches on
the card against the same index on the CPU: int8 exact; float32 distances
of both within 1e-5 * (|q|^2 + |x|^2 + 2 sum |q_d x_d|) of the exact
distance (float64), and ids equal wherever a rank's exact distance is
separated from its neighbours' by more than their two bounds.  The graph
slice's tests (the walk, FLAT, the graph functions, a graph build) run
integer-valued data, so the card must give the CPU's ids and distances
exactly.
"""

import os
import time

import numpy as np
import pytest
import torch

import sptag_tpu_torch as tsp
from sptag_tpu_torch.ops import block_dots


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _tensors(gen, C, P, D, Q, int8, dev):
    if int8:
        blocks = torch.randint(-128, 128, (C, P, D), generator=gen)
        queries = torch.randint(-128, 128, (Q, D), generator=gen)
        blocks, queries = blocks.to(torch.int8), queries.to(torch.int8)
    else:
        blocks = torch.randn((C, P, D), generator=gen)
        queries = torch.randn((Q, D), generator=gen)
    return blocks.to(dev), queries.to(dev)


def _same(got, want, int8):
    if int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# (C, P, D, Q, nprobe): 16-byte copies and the narrow loads (D % 16, ragged
# P)
PROBE = [(7, 32, 128, 4, 3), (5, 13, 128, 6, 2), (9, 40, 16, 5, 4),
         (4, 33, 130, 3, 2), (3, 7, 20, 9, 3)]
# (C, P, D, NG, U, G): groups of 1 to 64 entries (one m16 tile, two, a slot
# split over tiles), ragged P and D
GROUP = [(9, 32, 128, 4, 5, 8), (5, 13, 128, 2, 3, 32), (6, 40, 16, 3, 4, 4),
         (6, 300, 130, 2, 3, 40), (4, 70, 18, 5, 2, 16), (3, 64, 128, 1, 2, 64),
         (4, 9, 12, 3, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_kernels_match_plain_versions(cuda, int8):
    gen = torch.Generator().manual_seed(0)
    block_dots.reset_launch_counts()
    for C, P, D, Q, nprobe in PROBE:
        blocks, queries = _tensors(gen, C, P, D, Q, int8, cuda)
        topc = torch.randint(0, C, (Q, nprobe), generator=gen).to(
            torch.int32).to(cuda)
        _same(block_dots.probe_block_dots(blocks, queries, topc),
              block_dots.probe_block_dots_reference(blocks, queries, topc),
              int8)
    for C, P, D, NG, U, G in GROUP:
        blocks, queries = _tensors(gen, C, P, D, NG * G, int8, cuda)
        union = torch.randint(0, C, (NG, U), generator=gen).to(
            torch.int32).to(cuda)
        _same(block_dots.group_block_dots(blocks, queries, union),
              block_dots.group_block_dots_reference(blocks, queries, union),
              int8)
    torch.cuda.synchronize()
    t = "i8" if int8 else "f32"
    counts = block_dots.launch_counts()
    assert counts[f"probe_block_dots_{t}"] == len(PROBE)
    assert counts[f"group_block_dots_{t}"] == len(GROUP)


# block-major cases: (kind, C, P, D, rows, cols, G, ids), where rows x cols
# are the id matrix (Q x nprobe, or NG x U) and `ids` says how they are
# drawn
BLOCK_MAJOR_CASES = [
    ("probe", 5, 32, 128, 150, 2, 1, "hot"),      # > TILE_ENTRIES on a block
    ("group", 6, 40, 64, 12, 4, 8, "hot"),
    ("probe", 4, 24, 32, 70, 3, 1, "one_block"),  # every entry on one block
    ("group", 4, 24, 32, 3, 4, 8, "one_block"),
    ("probe", 6, 16, 64, 40, 4, 1, "out_of_range"),
    ("group", 6, 16, 64, 5, 4, 8, "out_of_range"),
    ("probe", 3000, 8, 16, 64, 4, 1, "wide_c"),   # C far above blocks used
    ("group", 12_000, 2, 8, 8, 3, 4, "wide_c"),   # counters past smem
    ("group", 6, 40, 32, 5, 3, 1, "uniform"),     # G = 1
    ("group", 5, 64, 128, 2, 3, 64, "uniform"),   # G = 64
    ("probe", 4, 300, 130, 6, 2, 1, "uniform"),   # ragged P and D
    ("group", 4, 300, 130, 2, 3, 8, "uniform"),
    ("probe", 5, 33, 20, 9, 3, 1, "uniform"),     # D = 20
    ("group", 5, 33, 20, 3, 2, 16, "uniform"),
    ("group", 3, 600, 48, 2, 2, 12, "uniform"),   # three 256-row passes
    ("probe", 4, 256, 128, 33, 8, 1, "uniform"),  # the main path's P and D
]
_CASE_IDS = [f"{c[0]}-{c[-1]}-C{c[1]}-P{c[2]}-D{c[3]}-G{c[6]}"
             for c in BLOCK_MAJOR_CASES]


def _case_ids(gen, C, rows, cols, draw):
    ids = torch.randint(0, min(C, 6), (rows, cols), generator=gen)
    if draw == "hot":
        ids[:, 0] = 1
    elif draw == "one_block":
        ids[:] = C - 1
    elif draw == "out_of_range":
        ids = torch.randint(-3, C + 3, (rows, cols), generator=gen)
    elif draw == "wide_c":
        ids[0, 0] = C - 1
    elif draw == "uniform":
        ids = torch.randint(0, C, (rows, cols), generator=gen)
    return ids.to(torch.int32)


def _case(gen, case, int8, dev):
    kind, C, P, D, rows, cols, G, draw = case
    ids = _case_ids(gen, C, rows, cols, draw).to(dev)
    blocks, queries = _tensors(gen, C, P, D, rows * G, int8, dev)
    return kind, blocks, queries, ids


def _plain(kind, blocks, queries, ids):
    """The plain version, with out-of-range ids scoring zero."""
    C = blocks.shape[0]
    ref = getattr(block_dots, f"{kind}_block_dots_reference")
    want = ref(blocks, queries, ids.clamp(0, C - 1))
    dead = (ids < 0) | (ids >= C)
    dead = dead.reshape(dead.shape + (1,) * (want.dim() - dead.dim()))
    return torch.where(dead, torch.zeros_like(want), want)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", BLOCK_MAJOR_CASES, ids=_CASE_IDS)
def test_block_major_kernel_matches_plain_version(cuda, case, int8):
    gen = torch.Generator().manual_seed(1)
    kind, blocks, queries, ids = _case(gen, case, int8, cuda)
    fn = getattr(block_dots, f"{kind}_block_dots")
    t = "i8" if int8 else "f32"
    before = block_dots.launch_counts()[f"{kind}_block_dots_{t}"]
    _same(fn(blocks, queries, ids), _plain(kind, blocks, queries, ids), int8)
    # a query matrix one element off 16-byte alignment (4 bytes for f32,
    # 1 byte for int8) takes the narrow loads
    flat = torch.empty(queries.numel() + 1, dtype=queries.dtype, device=cuda)
    skew = flat[1:].view(queries.shape)
    skew.copy_(queries)
    _same(fn(blocks, skew, ids), _plain(kind, blocks, queries, ids), int8)
    assert block_dots.launch_counts()[f"{kind}_block_dots_{t}"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", BLOCK_MAJOR_CASES[:8],
                         ids=[f"{c[0]}-{c[-1]}" for c in BLOCK_MAJOR_CASES[:8]])
def test_cuda_prep_matches_plain_prep_per_block(cuda, case, int8):
    """The CUDA prep against the plain one: the same tile table and, per
    block, the same set of entries (the order inside a block is free).  The
    prep reads only the ids; both types' inputs are drawn as their wrappers
    get them."""
    gen = torch.Generator().manual_seed(2)
    kind, blocks, queries, ids = _case(gen, case, int8, cuda)
    C = blocks.shape[0]
    G = queries.shape[0] // ids.shape[0] if kind == "group" else 1
    order, tiles, ntiles = block_dots.block_major_prep(ids, G, C)
    n = int(ntiles.item())
    assert n <= tiles.shape[0] == block_dots.tile_bound(ids.numel() * G, C)
    tiles, order = tiles[:n].cpu(), order.cpu()
    ref_order, ref_tiles = block_dots.block_major_prep_reference(
        ids.cpu(), G, C)
    assert torch.equal(tiles, ref_tiles)
    got, want = {}, {}
    for b, first, count in tiles.tolist():
        got.setdefault(b, set()).update(order[first:first + count].tolist())
        want.setdefault(b, set()).update(
            ref_order[first:first + count].tolist())
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_wrappers_never_wait_for_the_card(cuda, int8):
    gen = torch.Generator().manual_seed(3)
    blocks, queries = _tensors(gen, 9, 64, 128, 32, int8, cuda)
    topc = torch.randint(0, 9, (32, 4), generator=gen).to(torch.int32).to(
        cuda)
    union = torch.randint(0, 9, (4, 5), generator=gen).to(torch.int32).to(
        cuda)
    block_dots.library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = block_dots.probe_block_dots(blocks, queries, topc)
        b = block_dots.group_block_dots(blocks, queries, union)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same(a, block_dots.probe_block_dots_reference(blocks, queries, topc),
          int8)
    _same(b, block_dots.group_block_dots_reference(blocks, queries, union),
          int8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_out_of_range_block_ids_score_zero(cuda, dtype):
    blocks = torch.ones((2, 8, 32), dtype=dtype, device=cuda)
    queries = torch.ones((4, 32), dtype=dtype, device=cuda)
    ids = torch.tensor([[0, 5], [-1, 1], [1, 2], [0, 0]], dtype=torch.int32,
                       device=cuda)
    out = block_dots.probe_block_dots(blocks, queries, ids).cpu()
    assert out[0, 0].eq(32).all() and out[0, 1].eq(0).all()
    assert out[1, 0].eq(0).all() and out[2, 1].eq(0).all()


@pytest.mark.cuda
def test_wrapper_rejects_non_contiguous_cuda_tensors(cuda):
    blocks = torch.randn((3, 8, 32), device=cuda)
    queries = torch.randn((32, 4), device=cuda).T
    ids = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        block_dots.probe_block_dots(blocks, queries, ids)


def _corpus(n, d, nq, seed, int8=False):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((24, d)).astype(np.float32) * 4.0
    data = (cent[rng.integers(0, 24, n)]
            + rng.standard_normal((n, d)).astype(np.float32))
    q = (cent[rng.integers(0, 24, nq)]
         + rng.standard_normal((nq, d)).astype(np.float32))
    if int8:
        def toi8(x):
            x = x / np.linalg.norm(x, axis=1, keepdims=True)
            return np.clip(np.round(x * 127), -128, 127).astype(np.int8)
        return toi8(data), toi8(q)
    return data, q


def _l2_exact_and_bound(data, q, ids):
    """Each returned id's L2 distance in float64, and the float32 error
    bound 1e-5 * (|q|^2 + |x|^2 + 2 sum_d |q_d x_d|): the magnitudes of the
    terms any summation order adds."""
    x = data.astype(np.float64)[ids]                     # (Q, k, D)
    qd = q.astype(np.float64)[:, None, :]
    exact = ((qd - x) ** 2).sum(-1)
    scale = (qd * qd).sum(-1) + (x * x).sum(-1) + 2 * np.abs(qd * x).sum(-1)
    return exact, 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("vt,group", [("Float", 0), ("Float", 8),
                                      ("Int8", 0), ("Int8", 32)])
def test_card_search_matches_cpu_search(cuda, tmp_path, vt, group):
    """Build on the card, save, load on the CPU: both searches agree, and
    the card's search went through the kernels.  int8 exactly; float32
    distances each within its error bound of the exact distance, and ids
    equal wherever a rank's exact distance is farther from its neighbours'
    than their bounds."""
    data, q = _corpus(4000, 128, 1024, seed=8, int8=vt == "Int8")
    idx = tsp.create_instance("BKT", vt)
    for name, value in [("DistCalcMethod", "L2" if vt == "Float"
                         else "Cosine"), ("BuildGraph", "0"),
                        ("DenseClusterSize", "64"), ("MaxCheck", "512"),
                        ("DenseQueryGroup", str(group)),
                        ("DenseUnionFactor", "4")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    block_dots.reset_launch_counts()
    d_gpu, i_gpu = idx.search_batch(q, 10)
    assert idx.last_effective_group == group
    kind = "group" if group else "probe"
    t = "i8" if vt == "Int8" else "f32"
    assert block_dots.launch_counts()[f"{kind}_block_dots_{t}"] >= 1
    folder = str(tmp_path / vt)
    idx.save_index(folder)
    d_cpu, i_cpu = tsp.load_index(folder, device="cpu").search_batch(q, 10)
    if vt == "Int8":
        np.testing.assert_array_equal(i_gpu, i_cpu)
        np.testing.assert_array_equal(d_gpu, d_cpu)
        return
    assert (i_gpu >= 0).all() and (i_cpu >= 0).all()
    for d, i in ((d_gpu, i_gpu), (d_cpu, i_cpu)):
        exact, bound = _l2_exact_and_bound(data, q, i)
        assert (np.abs(d - exact) <= bound).all()
    exact, bound = _l2_exact_and_bound(data, q, i_cpu)
    gap = np.diff(exact, axis=1) > bound[:, 1:] + bound[:, :-1]
    sep = np.ones_like(exact, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    np.testing.assert_array_equal(i_gpu[sep], i_cpu[sep])


# ---- the graph slice: the walk, FLAT and the graph build on the card -------
#
# Integer-valued float32 rows (and int8 rows) make every distance exact on
# both devices whatever the summation order, so the card must return the
# CPU's ids and distances exactly.

def _int_rows(n, d, seed, lo=-4, hi=5):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)).astype(
        np.float32)


def _weak_graph(n, m, seed):
    g = np.random.default_rng(seed).integers(-1, n, (n, m)).astype(np.int32)
    g[:, 0] = (np.arange(n) + 1) % n
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("binned", ["off", "on"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_walk_on_card_matches_cpu(cuda, monkeypatch, binned, int8):
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod
    from sptag_tpu_torch.ops.distance import normalize

    n = 3000
    data = _int_rows(n, 32, seed=1)
    q = _int_rows(300, 32, seed=2)
    metric, base = DistCalcMethod.L2, 1
    if int8:
        data = normalize(data.astype(np.int8) * 20, 127)
        q = normalize(q.astype(np.int8) * 20, 127)
        metric, base = DistCalcMethod.Cosine, 127
    graph = _weak_graph(n, 16, seed=3)
    rng = np.random.default_rng(4)
    pivots = rng.choice(n, 400, replace=False)
    deleted = rng.random(n) < 0.05
    on_card = []
    run = teng._Walk.run

    def checked_run(self, *args):
        out = run(self, *args)
        on_card.append(all(t.is_cuda for t in (
            self.queries, self.cand_ids, self.cand_d, self.visited,
            self.expanded, self.no_better)))
        return out
    monkeypatch.setattr(teng._Walk, "run", checked_run)
    res = []
    for dev in (cuda, "cpu"):
        eng = teng.GraphSearchEngine(data, graph, pivots, deleted, metric,
                                     base, binned_topk=binned, device=dev)
        res.append(eng.search(q, 10, max_check=512, dynamic_pivots=4))
    assert on_card[0] and not on_card[1]
    np.testing.assert_array_equal(res[0][1], res[1][1])
    np.testing.assert_array_equal(res[0][0], res[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("knob", [None, ("BinnedTopK", "on"),
                                  ("ApproxTopK", "true")])
def test_flat_on_card_matches_cpu(cuda, knob):
    data = _int_rows(5000, 64, seed=5)
    q = _int_rows(200, 64, seed=6)
    res = []
    for dev in (None, "cpu"):
        idx = tsp.create_instance("FLAT", "Float", device=dev)
        idx.set_parameter("DistCalcMethod", "L2")
        if knob:
            idx.set_parameter(*knob)
        idx.build(data)
        res.append(idx.search_batch(q, 10))
        if dev is None:
            assert idx._snapshot()[0].is_cuda
    np.testing.assert_array_equal(res[0][1], res[1][1])
    np.testing.assert_array_equal(res[0][0], res[1][0])
    # Gaussian float32: each distance within its error bound of the exact
    data, q = _corpus(5000, 128, 100, seed=7)
    idx = tsp.create_instance("FLAT", "Float")
    idx.set_parameter("DistCalcMethod", "L2")
    idx.build(data)
    d, ids = idx.search_batch(q, 10)
    exact, bound = _l2_exact_and_bound(data, q, ids)
    assert (np.abs(d - exact) <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric,base", [(0, 1), (1, 127)])
def test_graph_ops_on_card_match_cpu(cuda, metric, base):
    from sptag_tpu_torch.ops import graph as tgraph

    rng = np.random.default_rng(8)
    vecs = torch.from_numpy(_int_rows(6 * 80, 16, seed=9).reshape(6, 80, 16))
    valid = torch.from_numpy(rng.random((6, 80)) < 0.9)
    ids = torch.from_numpy(rng.integers(-1, 50, (40, 12)).astype(np.int32))
    dd = torch.from_numpy(rng.integers(0, 5, (40, 12)).astype(np.float32))
    cand = vecs[:, :40]
    cd = tgraph.node_candidate_dists(vecs[:, 40], cand, metric, base)
    order = torch.argsort(cd, dim=1, stable=True)
    cand = torch.gather(cand, 1, order[..., None].expand_as(cand))
    cd = torch.gather(cd, 1, order)
    out = []
    for dev in (cuda, torch.device("cpu")):
        out.append([
            *tgraph.leaf_allpairs_topk(vecs.to(dev), valid.to(dev), 24,
                                       metric, base),
            *tgraph.merge_candidates(ids.to(dev), dd.to(dev),
                                     ids.flip(1).to(dev), dd.to(dev)),
            tgraph.rng_select(cand.to(dev), cd.to(dev), valid[:, :40].to(dev),
                              8, metric, base)])
    for a, b in zip(*out):
        assert a.is_cuda
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_graph_build_on_card_uses_kernels_and_serves_like_cpu(cuda,
                                                              tmp_path):
    """BuildGraph=1 on the card: the dense refine passes launch the
    block-dot kernels and the final pass walks on the card; the saved
    folder beam-searches alike on the card and on the CPU."""
    data = _int_rows(4000, 32, seed=10)
    q = _int_rows(256, 32, seed=11)
    idx = tsp.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "256"),
                        ("RefineQueryGroup", "32"), ("MaxCheck", "512"),
                        ("SearchMode", "beam"), ("DenseClusterSize", "64")]:
        assert idx.set_parameter(name, value)
    block_dots.reset_launch_counts()
    idx.build(data)
    counts = block_dots.launch_counts()
    assert counts["group_block_dots_f32"] + counts["probe_block_dots_f32"] \
        >= 1, counts
    assert idx.get_parameter("FinalRefineSearchMode") == "beam"
    d_gpu, i_gpu = idx.search_batch(q, 10)
    assert idx._get_engine().data.is_cuda
    folder = str(tmp_path / "g")
    idx.save_index(folder)
    d_cpu, i_cpu = tsp.load_index(folder, device="cpu").search_batch(q, 10)
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_array_equal(d_gpu, d_cpu)
    truth = np.argsort(((q[:, None, :] - data[None]) ** 2).sum(-1), axis=1,
                       kind="stable")[:, :10]
    d_ex, i_ex = idx.exact_search_batch(q, 10)
    exact = ((q[:, None, :] - data[i_ex]) ** 2).sum(-1)
    np.testing.assert_array_equal(d_ex, exact)
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(i_gpu, truth)]) >= 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(np.int8, 1023), (np.int8, 1024),
                                     (np.uint8, 258), (np.uint8, 259)])
def test_int_contract_on_card_at_float32_edge(cuda, dtype, d):
    """On the card int_contract runs float32 up to the edge and float64
    past it: both equal the int64 product, extreme rows included."""
    from sptag_tpu_torch.ops import distance as dist_ops

    info = np.iinfo(dtype)
    extreme = info.min if dtype == np.int8 else info.max
    rng = np.random.default_rng(d)
    a = rng.integers(info.min, info.max + 1, (5, d), dtype=dtype)
    b = rng.integers(info.min, info.max + 1, (7, d), dtype=dtype)
    a[-1], b[-1] = extreme, extreme
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = dist_ops.int_contract("qd,nd->qn", torch.from_numpy(a).to(cuda),
                                torch.from_numpy(b).to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.cpu().numpy(), want)


# ---- mutation and KDT (integer-valued rows: the card gives the CPU's
# results exactly) -----------------------------------------------------------

def _clustered_ints(n, d, seed):
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(55).standard_normal((16, d)) * 4.0
    return np.round((cent[rng.integers(0, 16, n)]
                     + rng.standard_normal((n, d))) * 2).astype(np.float32)


_MUT_SETTINGS = [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                 ("TPTLeafSize", "500"), ("CEF", "64"),
                 ("MaxCheckForRefineGraph", "128"),
                 ("NeighborhoodSize", "16"), ("MaxCheck", "512"),
                 ("RefineQueryGroup", "32"), ("AddCEF", "32"),
                 ("FinalRefineSearchMode", "same"),
                 ("DenseClusterSize", "128"),
                 ("AddCountForRebuild", "100000")]


def _cpu_built_folder(tmp_path, algo, data):
    idx = tsp.create_instance(algo, "Float", device="cpu")
    for name, value in _MUT_SETTINGS:
        assert idx.set_parameter(name, value)
    idx.build(data)
    folder = str(tmp_path / algo)
    idx.save_index(folder)
    idx.close()
    return folder


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [0, 1])
def test_delta_scan_on_card_matches_cpu(cuda, metric):
    from sptag_tpu_torch.core.delta import DeltaShard

    rows = _clustered_ints(300, 32, seed=1)
    if metric == 1:
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    deleted = np.zeros(1300, bool)
    deleted[[1003, 1100, 1250]] = True
    out = []
    for dev in (cuda, "cpu"):
        shard = DeltaShard(1000, 32, np.float32, 512, metric, 1, device=dev)
        shard.append(rows[:200], 1000)
        shard.append(rows[200:], 1200)
        assert shard._snapshot()[1].device.type == torch.device(dev).type
        out.append(shard.search(rows[::7], 10, deleted))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    if metric == 0:
        np.testing.assert_array_equal(out[0][0], out[1][0])
    else:
        np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-6)


@pytest.mark.cuda
def test_linked_add_and_swap_on_card_match_cpu(cuda, tmp_path):
    """An inline add's linked graph, a delta-shard add, its background
    link and swap, and a delete: the card's graph and ids equal the
    CPU's."""
    data = _clustered_ints(1600, 32, seed=2)
    q = _clustered_ints(64, 32, seed=3)
    folder = _cpu_built_folder(tmp_path, "BKT", data[:1200])
    pair = [tsp.load_index(folder), tsp.load_index(folder, device="cpu")]
    assert pair[0]._get_engine().data.is_cuda
    for idx in pair:
        idx.add(data[1200:1300])
    np.testing.assert_array_equal(pair[0]._graph, pair[1]._graph)
    for idx in pair:
        idx.set_parameter("DeltaShardCapacity", "128")
        idx.set_parameter("AutoRefineThreshold", "32")
        idx.add(data[1300:1340])
        deadline = time.time() + 60
        while idx.mutation_state()["swap_count"] < 1 \
                or idx.mutation_state()["refine_in_flight"]:
            assert time.time() < deadline
            time.sleep(0.05)
        idx.delete(data[1305:1306])
    np.testing.assert_array_equal(pair[0]._graph, pair[1]._graph)
    for mode in ("beam", "dense"):
        got = [idx.search_batch(q, 10, search_mode=mode) for idx in pair]
        np.testing.assert_array_equal(got[0][1], got[1][1])
        np.testing.assert_array_equal(got[0][0], got[1][0])
    for idx in pair:
        idx.close()


@pytest.mark.cuda
def test_kdt_seeded_walk_and_refine_on_card_match_cpu(cuda, tmp_path):
    """KDT: the kd-seeded walk and the kd-cell dense scan on the card
    return the CPU's ids and distances; refine_index (host kd-forest
    rebuild, the refine pass through the block-dot kernels) gives the same
    graph on both."""
    data = _clustered_ints(1500, 32, seed=4)
    q = _clustered_ints(64, 32, seed=5)
    folder = _cpu_built_folder(tmp_path, "KDT", data)
    pair = [tsp.load_index(folder), tsp.load_index(folder, device="cpu")]
    for mode in ("beam", "dense"):
        got = [idx.search_batch(q, 10, search_mode=mode) for idx in pair]
        np.testing.assert_array_equal(got[0][1], got[1][1])
        np.testing.assert_array_equal(got[0][0], got[1][0])
    block_dots.reset_launch_counts()
    for idx in pair:
        idx.delete(data[:600:3])
        idx.refine_index()
    counts = block_dots.launch_counts()
    assert counts["group_block_dots_f32"] + counts["probe_block_dots_f32"] \
        >= 1, counts
    assert pair[0].num_samples == pair[1].num_samples
    np.testing.assert_array_equal(pair[0]._graph, pair[1]._graph)
    got = [idx.search_batch(q, 10) for idx in pair]
    np.testing.assert_array_equal(got[0][1], got[1][1])


@pytest.mark.cuda
def test_bkt_refine_index_on_card(cuda):
    """BKT compaction on the card: the forest is rebuilt on the card (its
    k-means need not match the CPU's), the corpus remap is exact and the
    walk's recall against the exact truth holds."""
    data = _clustered_ints(2000, 32, seed=6)
    q = _clustered_ints(64, 32, seed=7)
    idx = tsp.create_instance("BKT", "Float")
    for name, value in _MUT_SETTINGS:
        assert idx.set_parameter(name, value)
    idx.build(data)
    idx.delete(data[::5])
    kept = np.flatnonzero(~idx._deleted[:idx._n])
    block_dots.reset_launch_counts()
    assert idx.refine_index() == tsp.ErrorCode.Success
    assert sum(block_dots.launch_counts().values()) >= 1
    np.testing.assert_array_equal(idx._host[:idx._n], data[kept])
    _, ids = idx.search_batch(q, 10, search_mode="beam")
    _, truth = idx.exact_search_batch(q, 10)
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(ids, truth)]) >= 0.9
    idx.close()


@pytest.mark.cuda
@pytest.mark.parametrize("binned", ["off", "on"])
def test_small_chunk_graph_replay_matches_cpu(cuda, binned):
    """Chunks of at most _GRAPH_MAX_Q queries replay one CUDA graph of the
    whole walk (no alive checks, all T iterations): the same ids and
    distances as the CPU walk, before and after an in-place tombstone
    swap, seeded or not, from several threads at once."""
    import threading

    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod

    n = 3000
    data = _int_rows(n, 32, seed=12)
    q = _int_rows(40, 32, seed=13)
    graph = _weak_graph(n, 16, seed=14)
    pivots = np.random.default_rng(15).choice(n, 400, replace=False)
    deleted = np.zeros(n, bool)
    engines = [teng.GraphSearchEngine(data, graph, pivots, deleted,
                                      DistCalcMethod.L2, 1,
                                      binned_topk=binned, device=dev)
               for dev in (cuda, "cpu")]
    seeds = np.random.default_rng(16).integers(-1, n, (40, 12))

    def both(qq, **kw):
        out = [e.search(qq, 10, max_check=512, **kw) for e in engines]
        np.testing.assert_array_equal(out[0][1], out[1][1])
        np.testing.assert_array_equal(out[0][0], out[1][0])
        return out[0]
    both(q[:4])                        # eager: a key's first call
    both(q[4:8])                       # captured, other queries
    both(q[8:12])                      # replayed
    assert len(engines[0]._graphs) == 1
    both(q[:5], seeds=seeds[:5])
    both(q[5:10], seeds=seeds[5:10])   # the seeded walk's graph
    assert len(engines[0]._graphs) == 2
    deleted[np.random.default_rng(17).random(n) < 0.1] = True
    for e in engines:
        e.set_deleted(deleted)
    _, ids = both(q[:4])
    assert not deleted[ids[ids >= 0]].any()
    want = [engines[1].search(q[i:i + 4], 10, max_check=512)[1]
            for i in range(0, 40, 4)]
    got, errors = {}, []

    def reader(i):
        try:
            for _ in range(5):
                got[i] = engines[0].search(q[i:i + 4], 10, max_check=512)[1]
        except Exception as e:                           # noqa: BLE001
            errors.append(repr(e))
    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(0, 40, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, w in zip(range(0, 40, 4), want):
        np.testing.assert_array_equal(got[i], w)


@pytest.mark.cuda
def test_graph_replay_pads_to_buckets_and_bounds_its_cache(cuda):
    """Chunks of every size up to the cutoff are padded to their bucket
    (one graph per bucket and plan, captured when a bucket is asked for
    the second time; the CPU walk's ids), and many plans keep at most
    _GRAPH_CACHE graphs, the newest ones."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod

    n = 3000
    data = _int_rows(n, 32, seed=22)
    q = _int_rows(teng._GRAPH_MAX_Q + 8, 32, seed=23)
    graph = _weak_graph(n, 16, seed=24)
    pivots = np.random.default_rng(25).choice(n, 400, replace=False)
    engines = [teng.GraphSearchEngine(data, graph, pivots, None,
                                      DistCalcMethod.L2, 1, device=dev)
               for dev in (cuda, "cpu")]
    for nq in (1, 3, 4, 5, 16, 17, 63, 64, 65, teng._GRAPH_MAX_Q):
        out = [e.search(q[:nq], 10, max_check=256) for e in engines]
        np.testing.assert_array_equal(out[0][1], out[1][1])
        np.testing.assert_array_equal(out[0][0], out[1][0])
    assert len(engines[0]._graphs) == len(teng._GRAPH_BUCKETS)
    engines[0].search(q[:teng._GRAPH_MAX_Q + 1], 10, max_check=256)
    assert len(engines[0]._graphs) == len(teng._GRAPH_BUCKETS)  # eager
    for k in range(1, teng._GRAPH_CACHE + 4):
        for _ in range(2):                 # captured at the second call
            out = [e.search(q[:4], k, max_check=256) for e in engines]
            np.testing.assert_array_equal(out[0][1], out[1][1])
    assert len(engines[0]._graphs) == teng._GRAPH_CACHE
    assert [key[3][0] for key in engines[0]._graphs] == \
        list(range(4, teng._GRAPH_CACHE + 4))


@pytest.mark.cuda
def test_walk_captures_no_graph_while_a_trace_runs(cuda, tmp_path):
    """While a torch.profiler trace runs, a walk key asked for again runs
    eagerly (the CPU walk's ids, nothing captured) and the trace holds
    its kernels; after the trace the same key is captured and replayed."""
    import json

    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod
    from sptag_tpu_torch.utils import trace as ttrace

    n = 3000
    data = _int_rows(n, 32, seed=32)
    q = _int_rows(16, 32, seed=33)
    graph = _weak_graph(n, 16, seed=34)
    pivots = np.random.default_rng(35).choice(n, 400, replace=False)
    engines = [teng.GraphSearchEngine(data, graph, pivots, None,
                                      DistCalcMethod.L2, 1, device=dev)
               for dev in (cuda, "cpu")]

    def both(qq):
        out = [e.search(qq, 10, max_check=256) for e in engines]
        np.testing.assert_array_equal(out[0][1], out[1][1])
        np.testing.assert_array_equal(out[0][0], out[1][0])
    both(q[:4])                        # a key's first call: eager
    ttrace.start_trace(str(tmp_path))
    try:
        for i in range(3):
            both(q[4 * i:4 * i + 4])
    finally:
        path = ttrace.stop_trace()
    assert len(engines[0]._graphs) == 0
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any("walk_score_kernel" in nm for nm in names)
    both(q[:4])
    both(q[4:8])
    assert len(engines[0]._graphs) == 1


# ---- the walk's bf16 shadow, packed neighbours, segments, the scheduler ----

@pytest.mark.cuda
@pytest.mark.parametrize("Q,C,D", [(64, 512, 128), (7, 33, 100)])
def test_bf16_card_contraction_matches_plain(cuda, Q, C, D):
    """The card's bf16 dots (one bf16 tensor-core product, float32 out)
    against the plain form (exact upcasts, a float32 contraction): every
    product of two bf16 values is exact in float32, so only the summation
    order differs, within 1e-5 * sum |q_d x_d|.  Both are float32, far
    closer to the float64 dot of the bf16 values than a bf16 result."""
    from sptag_tpu_torch.ops import distance as dist_ops

    gen = torch.Generator().manual_seed(Q + C)
    q = torch.randn((Q, D), generator=gen).to(torch.bfloat16).to(cuda)
    cand = torch.randn((Q, C, D), generator=gen).to(torch.bfloat16) \
        .to(cuda)
    got = dist_ops.bf16_gathered_dot(q, cand)
    want = dist_ops.bf16_gathered_dot_plain(q, cand)
    assert got.dtype == want.dtype == torch.float32
    exact = torch.einsum("qd,qcd->qc", q.double(), cand.double())
    scale = torch.einsum("qd,qcd->qc", q.double().abs(),
                         cand.double().abs())
    assert ((got.double() - want.double()).abs() <= 1e-5 * scale).all()
    assert ((got.double() - exact).abs() <= 1e-5 * scale).all()
    assert (exact - exact.to(torch.bfloat16).double()).abs().max() > \
        (got.double() - exact).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("score,packed,seg", [("bf16", False, 0),
                                              ("f32", True, 0),
                                              ("bf16", True, 3),
                                              ("f32", False, 2)])
def test_walk_options_on_card_match_cpu(cuda, score, packed, seg):
    """bf16 shadow, packed neighbours and segments on integer rows
    (|x| <= 4, every bf16 value and distance exact): the card's ids and
    distances are the CPU's, and the segmented walk's are the monolithic
    walk's."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod

    n = 3000
    data = _int_rows(n, 32, seed=31)
    q = _int_rows(300, 32, seed=32)
    graph = _weak_graph(n, 16, seed=33)
    pivots = np.random.default_rng(34).choice(n, 400, replace=False)
    deleted = np.random.default_rng(35).random(n) < 0.05
    res = []
    for dev in (cuda, "cpu"):
        eng = teng.GraphSearchEngine(data, graph, pivots, deleted,
                                     DistCalcMethod.L2, 1,
                                     score_dtype=score,
                                     packed_neighbors=packed, device=dev)
        assert (eng.data_score is not None) == (score == "bf16")
        res.append(eng.search(q, 10, max_check=512, segment_iters=seg))
        if seg:
            mono = eng.search(q, 10, max_check=512)
            np.testing.assert_array_equal(res[-1][1], mono[1])
            np.testing.assert_array_equal(res[-1][0], mono[0])
    np.testing.assert_array_equal(res[0][1], res[1][1])
    np.testing.assert_array_equal(res[0][0], res[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("graph_max_slots", [256, 0])
def test_scheduler_on_card_replays_segments_and_matches_cpu(
        cuda, seeded, graph_max_slots):
    """The slot scheduler on the card: at a capacity up to
    `graph_max_slots` its segments are captured as CUDA graphs (the
    second cycle of a capacity) and replayed, from its worker thread;
    with 0 every segment runs eagerly.  Every query gets the monolithic
    walk's ids and distances (the CPU scheduler's too); no slot stays
    occupied."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.algo.scheduler import BeamSlotScheduler
    from sptag_tpu_torch.core.types import DistCalcMethod

    n = 3000
    data = _int_rows(n, 32, seed=41)
    q = _int_rows(300, 32, seed=42)
    graph = _weak_graph(n, 16, seed=43)
    pivots = np.random.default_rng(44).choice(n, 400, replace=False)
    seeds = (np.random.default_rng(45).integers(-1, n, (300, 12))
             if seeded else None)
    out = []
    for dev in (cuda, "cpu"):
        eng = teng.GraphSearchEngine(data, graph, pivots, None,
                                     DistCalcMethod.L2, 1, device=dev)
        want = eng.search(q, 10, max_check=1024, seeds=seeds)
        sched = BeamSlotScheduler(eng, slots=32, segment_iters=2,
                                  graph_max_slots=graph_max_slots)
        try:
            got = sched.search_batch(q, 10, 1024, seeds=seeds)
            stats = sched.stats()
        finally:
            sched.stop()
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert stats["live"] == 0 and stats["pending"] == 0
        out.append((got, stats))
    np.testing.assert_array_equal(out[0][0][1], out[1][0][1])
    replayed = [st["segments_replayed"] for _, st in out]
    if graph_max_slots:
        assert out[0][1]["graphs_captured"] >= 1 and replayed[0] > 0
    else:
        assert out[0][1]["graphs_captured"] == 0 and replayed[0] == 0
    assert replayed[1] == 0


class _LoopThread:
    """A port SearchServer on its own asyncio loop in a daemon thread."""

    def __init__(self, server):
        import asyncio
        import threading

        self.server = server
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self._ready.wait(60)

    def _run(self):
        import asyncio

        asyncio.set_event_loop(self.loop)

        async def boot():
            self.addr = await self.server.start("127.0.0.1", 0)
            self._ready.set()

        self._boot = self.loop.create_task(boot())
        self.loop.run_forever()

    def stop(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.server.stop(),
                                         self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _exchange(addr, frames):
    import socket

    from sptag_tpu_torch.serve import wire

    sock = socket.create_connection(addr, timeout=120)

    def read_exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "server closed early"
            buf += chunk
        return buf

    out = []
    try:
        for f in frames:
            sock.sendall(f)
            head = read_exact(wire.HEADER_SIZE)
            h = wire.PacketHeader.unpack(head)
            out.append(head + (read_exact(h.body_length)
                               if h.body_length else b""))
    finally:
        sock.close()
    return out


@pytest.mark.cuda
def test_server_on_card_answers_like_cpu_server(cuda, tmp_path):
    """The port's SearchServer over a graph index on the card answers
    beam and dense requests with the same response bytes as the same
    server over the folder on the CPU (integer rows: exact distances),
    and its dense requests launch probe_block_dots f32."""
    from sptag_tpu_torch.serve import server as tserver
    from sptag_tpu_torch.serve import service as tservice
    from sptag_tpu_torch.serve import wire

    # a wide integer range: exact distances with few ties
    data = _int_rows(4000, 32, seed=60, lo=-40, hi=41)
    q = _int_rows(24, 32, seed=61, lo=-40, hi=41)
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "256"),
                        ("RefineQueryGroup", "32"), ("MaxCheck", "512"),
                        ("DenseClusterSize", "64"),
                        ("FinalRefineSearchMode", "same")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    folder = str(tmp_path / "g")
    idx.save_index(folder)
    frames = []
    for i, v in enumerate(q):
        text = "|".join(str(int(x)) for x in v)
        for mode in ("beam", "dense"):
            body = wire.RemoteQuery(f"$searchmode:{mode} $resultnum:10 "
                                    f"{text}").pack()
            frames.append(wire.PacketHeader(
                wire.PacketType.SearchRequest, 0, len(body), 0,
                i + 1).pack() + body)
    out = {}
    for dev in (cuda, "cpu"):
        settings = tservice.ServiceSettings(allow_search_mode_override="on")
        ctx = tservice.ServiceContext(settings, device=dev)
        ctx.add_index("main", tsp.load_index(folder, device=dev))
        srv = _LoopThread(tserver.SearchServer(ctx, batch_window_ms=2.0))
        try:
            block_dots.reset_launch_counts()
            out[str(dev)] = _exchange(srv.addr, frames)
            launches = block_dots.launch_counts()["probe_block_dots_f32"]
        finally:
            srv.stop()
            ctx.indexes["main"].close()
        if dev == cuda:
            assert launches >= len(q), launches
    assert out[str(cuda)] == out["cpu"]
    res = wire.RemoteSearchResult.unpack(out["cpu"][0][16:])
    assert res.status == wire.ResultStatus.Success
    assert len(res.results[0].ids) == 10


def _walk_inputs(gen, Q, N, C, D, dev):
    """Unit-normal queries and rows, (Q, C) int64 ids about 30% -1."""
    q = torch.randn((Q, D), generator=gen)
    x = torch.randn((N, D), generator=gen)
    idx = torch.randint(0, N, (Q, C), generator=gen)
    idx[torch.rand((Q, C), generator=gen) < 0.3] = -1
    return q.to(dev), x.to(dev), idx.to(dev)


def _misaligned(x):
    """A contiguous copy of `x` whose data pointer is 4 bytes past a
    16-byte boundary (the kernels' scalar-load branch)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


# (Q, C or P): ragged against every tile and slot group
WALK_SHAPES = [(1, 8333), (7, 129), (129, 7), (130, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 100, 128, 200, 33])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("mode", ["gather", "rows", "shared"])
def test_walk_dots_kernel_matches_plain_version(cuda, mode, metric, D):
    """The walk's two fixed-order distance kernels (and the norm helper)
    against their plain versions, in each row mode and metric, at ragged
    Q, C and P: within 1e-5 * (qn + xn + 2 sum |q_d x_d|) a distance,
    the bare dots within rtol 1e-5, atol 1e-4; -1 slots MAX_DIST."""
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(D)
    m = {"gather": wd.GATHER, "rows": wd.ROWS, "shared": wd.SHARED}[mode]
    epi = wd.L2 if metric == "l2" else wd.COSINE
    for Q, C in WALK_SHAPES:
        q, x, idx = _walk_inputs(gen, Q, C if m == wd.SHARED else 500, C,
                                 D, cuda)
        sq = wd.row_sqnorms(x)
        torch.testing.assert_close(sq, (x * x).sum(1), rtol=1e-5, atol=0)
        if m == wd.SHARED:
            name = "walk_seed_f32"
            torch.testing.assert_close(
                wd.walk_seed(q, x, None, wd.DOT),
                wd.walk_seed_reference(q, x, None, wd.DOT),
                rtol=1e-5, atol=1e-4)
            before = wd.launch_counts()
            got = wd.walk_seed(q, x, sq, epi)
            want = wd.walk_seed_reference(q, x, sq, epi)
            absdot = q.abs() @ x.abs().T
            xn = sq[None, :]
        else:
            name = "walk_score_f32"
            safe = idx.clamp_min(0)
            rows, table = ((x, sq) if m == wd.GATHER else
                           (x[safe].reshape(-1, D).contiguous(),
                            sq[safe].reshape(-1).contiguous()))
            torch.testing.assert_close(
                wd.walk_score(q, rows, idx, None, wd.DOT, m, C),
                wd.walk_score_reference(q, rows, idx, None, wd.DOT, m, C),
                rtol=1e-5, atol=1e-4)
            before = wd.launch_counts()
            got = wd.walk_score(q, rows, idx, table, epi, m, C)
            want = wd.walk_score_reference(q, rows, idx, table, epi, m, C)
            absdot = torch.einsum("qd,qcd->qc", q.abs(), x[safe].abs())
            xn = sq[safe]
            masked = idx < 0
            assert bool((got[masked] == wd.MAX_DIST).all())
        assert wd.launch_counts()[name] == before[name] + 1
        torch.cuda.synchronize()
        tol = 1e-5 * ((q * q).sum(1)[:, None] + xn + 2 * absdot)
        err = (got.double() - want.double()).abs()
        assert bool((err <= tol.double()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
def test_walk_fused_epilogue_equals_the_unfused_formula(cuda, aligned):
    """Each kernel's L2 and cosine outputs equal the unfused formula over
    the kernel's own dots (its bare-dot epilogue) and norms (the norm
    helper, the kernels' one norm function) bit for bit: the epilogue is
    not contracted into an FMA.  A -1 slot gives MAX_DIST; ROWS gives
    GATHER's bits.  Misaligned rows take the scalar-load branch and give
    the same bits."""
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(11)
    for D in (128, 100, 33):
        q, x, idx = _walk_inputs(gen, 37, 600, 300, D, cuda)
        if not aligned:
            q, x = _misaligned(q), _misaligned(x)
        qn, xn = wd.row_sqnorms(q), wd.row_sqnorms(x)
        dot = wd.walk_seed(q, x, None, wd.DOT)
        assert torch.equal(wd.walk_seed(q, x, xn, wd.L2), torch.clamp_min(
            qn[:, None] + xn[None, :] - 2.0 * dot, 0.0))
        assert torch.equal(wd.walk_seed(q, x, None, wd.COSINE), 1.0 - dot)
        C = idx.shape[1]
        safe = idx.clamp_min(0)
        masked = idx < 0
        dot = wd.walk_score(q, x, idx, None, wd.DOT, wd.GATHER, C)
        assert bool((dot[masked] == wd.MAX_DIST).all())
        l2 = torch.where(masked, wd.MAX_DIST, torch.clamp_min(
            qn[:, None] + xn[safe] - 2.0 * dot, 0.0))
        cos = torch.where(masked, wd.MAX_DIST, 1.0 - dot)
        assert torch.equal(wd.walk_score(q, x, idx, xn, wd.L2, wd.GATHER, C),
                           l2)
        assert torch.equal(
            wd.walk_score(q, x, idx, None, wd.COSINE, wd.GATHER, C), cos)
        rows = x[safe].reshape(-1, D)
        rows = _misaligned(rows) if not aligned else rows.contiguous()
        table = xn[safe].reshape(-1).contiguous()
        assert torch.equal(wd.walk_score(q, rows, idx, table, wd.L2,
                                         wd.ROWS, C), l2)
        bare = wd.walk_score(q, rows, None, None, wd.DOT, wd.ROWS, C)
        assert torch.equal(bare[~masked], dot[~masked])
        # a row against itself: the norm helper's bits are the kernel's
        # own dot of the row with itself, so (qn + qn) - 2 qn is 0
        assert torch.equal(wd.walk_score(q, q, None, qn, wd.L2, wd.ROWS, 1),
                           torch.zeros_like(qn)[:, None])


@pytest.mark.cuda
def test_walk_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """On the card a wrapper launches its kernel or raises: int32 or
    non-contiguous ids, rows or norms on another device, another dtype
    or a ROWS table of the wrong length are refused before any launch."""
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(5)
    q, x, idx = _walk_inputs(gen, 7, 300, 40, 64, cuda)
    sq = wd.row_sqnorms(x)
    before = wd.launch_counts()
    bad = [
        lambda: wd.walk_score(q, x, idx.int(), sq, wd.L2, wd.GATHER, 40),
        lambda: wd.walk_score(q, x, idx.t().contiguous().t(), sq, wd.L2,
                              wd.GATHER, 40),
        lambda: wd.walk_score(q, x, idx, sq.cpu(), wd.L2, wd.GATHER, 40),
        lambda: wd.walk_score(q, x.double(), idx, sq, wd.L2, wd.GATHER, 40),
        lambda: wd.walk_score(q, x[:279], idx, sq[:279], wd.L2, wd.ROWS,
                              40),
        lambda: wd.walk_seed(q, x.cpu(), sq, wd.L2),
        lambda: wd.walk_seed(q, x, sq[:-1], wd.L2),
        lambda: wd.walk_seed(q[:, :32], x, sq, wd.L2)]
    for call in bad:
        with pytest.raises((TypeError, ValueError)):
            call()
    assert wd.launch_counts() == before


@pytest.mark.cuda
def test_walk_dots_bits_do_not_depend_on_the_batch(cuda):
    """A query's distances in each row mode (seeding against shared rows,
    gathered rows, rows in output order), and its whole walk on a float32
    corpus, come out bit for bit alike alone, in small batches and in a
    batch of 1,024, eager and replayed."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(3)
    q, x, idx = _walk_inputs(gen, 1024, 4000, 300, 64, cuda)
    sq = wd.row_sqnorms(x)
    pivots = x[:3001].contiguous()
    piv_sq = wd.row_sqnorms(pivots)
    rows = x[idx.clamp_min(0)].reshape(-1, 64).contiguous()
    rows_sq = sq[idx.clamp_min(0)].reshape(-1).contiguous()
    full = {
        "gather": wd.walk_score(q, x, idx, sq, wd.L2, wd.GATHER, 300),
        "rows": wd.walk_score(q, rows, idx, rows_sq, wd.L2, wd.ROWS, 300),
        "shared": wd.walk_seed(q, pivots, piv_sq, wd.L2)}
    for lo, hi in ((0, 1), (5, 12), (100, 116), (300, 429)):
        qs, ids = q[lo:hi].contiguous(), idx[lo:hi].contiguous()
        part = {
            "gather": wd.walk_score(qs, x, ids, sq, wd.L2, wd.GATHER, 300),
            "rows": wd.walk_score(
                qs, rows[lo * 300:hi * 300].contiguous(), ids,
                rows_sq[lo * 300:hi * 300].contiguous(), wd.L2, wd.ROWS,
                300),
            "shared": wd.walk_seed(qs, pivots, piv_sq, wd.L2)}
        for mode, d in part.items():
            assert torch.equal(d, full[mode][lo:hi]), (mode, lo, hi)
    data = np.random.default_rng(4).standard_normal((6000, 64)).astype(
        np.float32)
    queries = np.random.default_rng(5).standard_normal((1024, 64)).astype(
        np.float32)
    graph = _weak_graph(6000, 16, seed=6)
    pivots = np.random.default_rng(7).choice(6000, 500, replace=False)
    eng = teng.GraphSearchEngine(data, graph, pivots, None,
                                 DistCalcMethod.L2, 1, device=cuda)
    d_all, i_all = eng.search(queries, 10, max_check=1024)
    for lo, hi in ((0, 1), (1, 17), (17, 81), (81, 337)):
        for _ in range(2):                    # eager, then a graph replay
            d, i = eng.search(queries[lo:hi], 10, max_check=1024)
            np.testing.assert_array_equal(i, i_all[lo:hi])
            np.testing.assert_array_equal(d, d_all[lo:hi])


# ---- card-memory ledger, resumable builds, the device trace ------------------

@pytest.mark.cuda
def test_ledger_device_bytes_within_the_allocator(cuda, tmp_path):
    """Every component the ledger holds for an index on the card is
    bounded by torch.cuda.memory_allocated, through build, searches (beam
    through captured walk graphs, dense), an add and a reload."""
    from sptag_tpu_torch.utils import devmem

    devmem.reset()
    data = _int_rows(4000, 32, seed=70)
    idx = tsp.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "256"),
                        ("MaxCheck", "512"), ("DenseClusterSize", "64"),
                        ("FinalRefineSearchMode", "same")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    for mode in ("beam", "dense", "beam"):
        idx.search_batch(data[:64], 10, search_mode=mode)
    snap = devmem.snapshot()
    assert {"corpus", "graph", "tree", "dense_blocks"} <= \
        set(snap["components"])
    torch.cuda.synchronize()
    assert 0 < snap["ledger_device_bytes"] <= snap["live_arrays_bytes"]
    assert snap["untracked_bytes"] >= 0
    eng = idx._get_engine()
    assert snap["components"]["graph"] == eng.graph.nbytes
    folder = str(tmp_path / "g")
    idx.save_index(folder)
    idx.close()
    del idx, eng
    import gc
    gc.collect()
    again = tsp.load_index(folder)
    again.search_batch(data[:8], 10, search_mode="beam")
    snap = devmem.snapshot()
    assert snap["ledger_device_bytes"] <= snap["live_arrays_bytes"]
    assert snap["components"]["corpus"] >= data.nbytes
    again.close()


@pytest.mark.cuda
def test_checkpointed_build_on_card_equals_plain_build(cuda, tmp_path,
                                                       monkeypatch):
    """A build on the card with checkpoint_dir, interrupted in its first
    refine pass and resumed, equals the uninterrupted card build row for
    row (the stages go to the host and come back)."""
    from sptag_tpu_torch.graph.rng import RelativeNeighborhoodGraph as RNG

    data = _int_rows(3000, 32, seed=71)

    def make():
        idx = tsp.create_instance("BKT", "Float")
        for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                            ("CEF", "64"), ("MaxCheckForRefineGraph", "256"),
                            ("RefineIterations", "2"),
                            ("DenseClusterSize", "64")]:
            assert idx.set_parameter(name, value)
        return idx

    plain = make()
    plain.build(data)
    ck = str(tmp_path / "ck")
    calls = {"n": 0}
    real = RNG.refine_once

    def dying(self, *a, **kw):
        calls["n"] += 1
        raise RuntimeError("build process died")

    monkeypatch.setattr(RNG, "refine_once", dying)
    with pytest.raises(RuntimeError):
        make().build(data, checkpoint_dir=ck)
    monkeypatch.setattr(RNG, "refine_once", real)
    resumed = make()
    resumed.build(data, checkpoint_dir=ck)
    assert resumed.build_resumed and calls["n"] == 1
    np.testing.assert_array_equal(resumed._graph, plain._graph)
    assert not [p for p in (tmp_path / "ck").iterdir() if p.is_dir()]
    d1, i1 = plain.search_batch(data[:32], 10)
    d2, i2 = resumed.search_batch(data[:32], 10)
    np.testing.assert_array_equal(i1, i2)


def _profiled_kernel_events(cuda):
    """CUDA events of a torch.profiler session around one kernel launch
    (a walk scoring call)."""
    from torch.profiler import ProfilerActivity, profile

    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(5)
    q, x, idx = _walk_inputs(gen, 16, 500, 64, 32, cuda)
    sq = wd.row_sqnorms(x)
    wd.walk_score(q, x, idx, sq, wd.L2, wd.GATHER, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wd.walk_score(q, x, idx, sq, wd.L2, wd.GATHER, 64)
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_profiler_sees_the_card_after_a_trace_from_another_thread(
        cuda, tmp_path):
    """A device trace started and stopped in a thread that is not the main
    one (a metrics listener's scrape thread) leaves the process's next
    torch.profiler session seeing the card: at least one device event
    around one kernel launch."""
    import threading

    from sptag_tpu_torch.utils import trace as ttrace

    def scrape():
        ttrace.start_trace(str(tmp_path))
        x = torch.ones(1024, device=cuda) * 2
        torch.cuda.synchronize()
        paths.append(ttrace.stop_trace())

    paths = []
    t = threading.Thread(target=scrape, name="trace-scrape")
    t.start()
    t.join()
    assert paths and paths[0] is not None and not ttrace.tracing()
    events = _profiled_kernel_events(cuda)
    assert any("walk_score_kernel" in e.name for e in events), \
        [e.name for e in events]


# One process: a torch.profiler session around three kernel launches every
# 14 s while the card runs other work, six sessions; prints each session's
# device events.  "port" first takes one device trace through the port
# (start_trace / stop_trace from another thread, as a metrics listener's
# scrape does) into the folder argv[2]; "bare" does not.
_SESSIONS = """
import sys, threading, time
import torch
from torch.profiler import ProfilerActivity, profile
if sys.argv[1] == "port":
    from sptag_tpu_torch.utils import trace
    def scrape():
        trace.start_trace(sys.argv[2])
        torch.ones(1024, device="cuda").mul_(2)
        torch.cuda.synchronize()
        trace.stop_trace()
    t = threading.Thread(target=scrape)
    t.start()
    t.join()
def session():
    x = torch.randn(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            x = x * 2
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())
seen = []
for i in range(6):
    seen.append(session())
    y = torch.randn(1 << 22, device="cuda")
    t_end = time.time() + 14
    while time.time() < t_end:
        y = y * 1.0000001
    torch.cuda.synchronize()
print(*seen, flush=True)
"""


@pytest.mark.cuda
def test_profiler_sees_the_card_a_minute_after_its_first_session(cuda,
                                                                 tmp_path):
    """Kineto left CUPTI initialised between sessions, and with the card
    busy in between a session recorded fewer kernels the later it came,
    none about a minute after the process's first (the blind profiler
    phase 13 of chip_smoke.py met): reproduced here in a process with
    TEARDOWN_CUPTI=0.  A process that took a device trace through the
    port (which sets TEARDOWN_CUPTI=1 where the environment names no
    value) sees every kernel in every later session, and both exit."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SESSIONS, kind, str(tmp_path)], cwd=root,
        env=env, stdout=subprocess.PIPE, text=True)
        for kind, env in (("bare", dict(base, TEARDOWN_CUPTI="0")),
                          ("port", base))]
    try:
        bare, port = ([int(v) for v in p.communicate(timeout=300)[0].split()]
                      for p in procs)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0]
    assert bare[0] == 3 and bare[-1] == 0, bare
    assert port == [3] * 6, port


@pytest.mark.cuda
def test_device_trace_route_catches_a_kernel_event(cuda, tmp_path):
    """/debug/devicetrace under load writes a torch.profiler trace that
    holds the walk's or the dense search's kernel; an overlapping trace
    answers 409."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from sptag_tpu_torch.serve.metrics_http import MetricsHttpServer
    from sptag_tpu_torch.utils import trace as ttrace

    data = _int_rows(4000, 32, seed=72)
    idx = tsp.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "256"),
                        ("MaxCheck", "512"), ("DenseClusterSize", "64"),
                        ("FinalRefineSearchMode", "same")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    stop, warm = threading.Event(), threading.Event()

    def load():
        while not stop.is_set():
            for mode in ("beam", "dense"):
                idx.search_batch(data[:512], 10, search_mode=mode)
            warm.set()

    srv = MetricsHttpServer(-1)
    port = srv.start()
    worker = threading.Thread(target=load, name="test-card-load")
    worker.start()
    try:
        # trace under load: after the first searches have set the index
        # up (snapshot uploads, the dense layout), not during that
        assert warm.wait(120)
        out = {}

        def trace():
            url = (f"http://127.0.0.1:{port}/debug/devicetrace?"
                   f"duration_ms=400&dir={tmp_path / 't'}")
            with urllib.request.urlopen(url, timeout=120) as r:
                out["body"] = json.loads(r.read())

        t = threading.Thread(target=trace, name="test-card-trace")
        t.start()
        deadline = time.time() + 30
        while not ttrace.tracing() and time.time() < deadline:
            time.sleep(0.005)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/devicetrace?duration_ms=5",
                timeout=60)
        assert e.value.code == 409
        t.join(120)
    finally:
        stop.set()
        worker.join(120)
        srv.shutdown()
        idx.close()
    with open(tmp_path / "t" / "trace.json") as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any("walk_score_kernel" in n or "block_major_f32_kernel" in n
               for n in names), sorted(names)[:50]


# ---- the cascade's kernels (sketch Hamming, gathered int8, the int8 walk
# scoring, float32 queries against int8 blocks) ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 4, 5, 9])
def test_sketch_hamming_matches_plain_version(cuda, W):
    """Exact: the kernel's Hamming matrix equals the plain SWAR count bit
    for bit, bit-31 words and invalid rows included, at ragged Q and N."""
    from sptag_tpu_torch.ops import sketch_dots

    gen = torch.Generator().manual_seed(W)
    for Q, N in ((1, 3000), (33, 257), (70, 1000)):
        qb = torch.randint(-2 ** 31, 2 ** 31, (Q, W), generator=gen,
                           dtype=torch.int64).to(torch.int32).to(cuda)
        sk = torch.randint(-2 ** 31, 2 ** 31, (N, W), generator=gen,
                           dtype=torch.int64).to(torch.int32).to(cuda)
        inv = (torch.rand(N, generator=gen) < 0.1).to(cuda)
        before = sketch_dots.launch_counts()["sketch_hamming"]
        got = sketch_dots.hamming(qb, sk, inv)
        want = sketch_dots.hamming_reference(qb, sk, inv)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert sketch_dots.launch_counts()["sketch_hamming"] == before + 1
        assert bool((got[:, inv] == sketch_dots.INVALID).all())


# the int8 kernels' widths: several 128-byte chunks, ragged, 16-byte loads,
# 4-byte words and bytes
I8_WIDTHS = [16, 33, 48, 100, 128, 256, 384]


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "sliced"])
@pytest.mark.parametrize("D", I8_WIDTHS)
@pytest.mark.parametrize("metric", [0, 1])
def test_int8_gather_dots_matches_plain_version(cuda, metric, D, aligned):
    """Exact: the fused-gather int8 tier equals the plain version bit for
    bit in GATHER mode (with and without a tombstone mask) and in ROWS
    mode (masked ids and all ids live), at C not a multiple of 32 or of a
    CTA's slots, on a query whose slots are all dead and on a source whose
    rows are not 16-byte aligned; -1 ids and tombstones give MAX_DIST."""
    from sptag_tpu_torch.ops import cascade as tc
    from sptag_tpu_torch.ops import int8_dots

    gen = torch.Generator().manual_seed(D + metric)
    R, scale = 3000, 0.0371
    x = torch.randint(-127, 128, (R, D), generator=gen).to(torch.int8)
    inv = (torch.rand(R, generator=gen) < 0.05).to(cuda)
    x = x.to(cuda)
    if not aligned:
        x = _misaligned(x)
    for Q, C in ((37, 700), (3, 1025), (1, 31)):
        q = torch.randn((Q, D), generator=gen).to(cuda)
        ids = torch.randint(-1, R, (Q, C), generator=gen).to(torch.int32)
        ids[0] = -1                                   # a query all dead
        ids = ids.to(cuda)
        qq, qs = tc.quantize_queries(q)
        qn = (q * q).sum(1)
        before = int8_dots.launch_counts()["int8_gather_dots"]
        want = int8_dots.int8_gather_dots_reference(qq, qs, qn, x, ids, inv,
                                                    scale, metric, 1)
        got = int8_dots.int8_gather_dots(qq, qs, qn, x, ids, inv, scale,
                                         metric, 1)
        got_open = int8_dots.int8_gather_dots(qq, qs, qn, x, ids, None,
                                              scale, metric, 1)
        rows = x[ids.clamp_min(0).long()].reshape(-1, D).contiguous()
        masked = torch.where(inv[ids.clamp_min(0).long()], -1,
                             ids).contiguous()
        got_rows = int8_dots.int8_gather_dots(qq, qs, qn, rows, masked, None,
                                              scale, metric, 1,
                                              int8_dots.ROWS)
        live = ids.clamp_min(0)
        got_live = int8_dots.int8_gather_dots(
            qq, qs, qn, x[live.long()].reshape(-1, D).contiguous(), live,
            None, scale, metric, 1, int8_dots.ROWS)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got_rows, want)
        assert torch.equal(got_open, int8_dots.int8_gather_dots_reference(
            qq, qs, qn, x, ids, None, scale, metric, 1))
        assert torch.equal(got_live, int8_dots.int8_gather_dots_reference(
            qq, qs, qn, x, live, None, scale, metric, 1))
        assert int8_dots.launch_counts()["int8_gather_dots"] == before + 4
        dead = (ids < 0) | inv[ids.clamp_min(0).long()]
        assert bool((got[dead] == int8_dots.MAX_DIST).all())
        assert bool((got[0] == int8_dots.MAX_DIST).all())


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "sliced"])
@pytest.mark.parametrize("D", I8_WIDTHS)
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("mode", ["gather", "rows", "rows_unmasked"])
def test_walk_score_i8_equals_f32_kernel_on_dequantized_rows(cuda, mode,
                                                             metric, D,
                                                             aligned):
    """walk_score_i8 equals walk_score_f32 over the dequantized rows bit for
    bit, and the plain version within the walk kernels' float32 bound: in
    GATHER and ROWS mode (with ids that mask, and with no ids), at ragged
    Q and C, with a query whose slots are all dead, on rows whose pointer
    is not 16-byte aligned."""
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(D)
    m = wd.GATHER if mode == "gather" else wd.ROWS
    epi = wd.L2 if metric == "l2" else wd.COSINE
    scale = 0.0213
    for Q, C in WALK_SHAPES:
        q, _, idx = _walk_inputs(gen, Q, 500, C, D, cuda)
        if Q > 1:
            idx[1] = -1                               # a query all dead
        x8 = torch.randint(-127, 128, (500, D), generator=gen).to(
            torch.int8).to(cuda)
        if m == wd.ROWS:
            x8 = x8[idx.clamp_min(0)].reshape(-1, D).contiguous()
        if mode == "rows_unmasked":
            idx = None
        if not aligned:
            x8 = _misaligned(x8)
        xf = wd.dequantize(x8, scale).contiguous()
        sq = wd.row_sqnorms(xf)
        before = wd.launch_counts()
        got = wd.walk_score(q, x8, idx, sq, epi, m, C, scale)
        assert wd.launch_counts()["walk_score_i8"] == \
            before["walk_score_i8"] + 1
        same = wd.walk_score(q, xf, idx, sq, epi, m, C)
        want = wd.walk_score_i8_reference(q, x8, idx, sq, epi, m, C, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, same)
        safe = idx.clamp_min(0) if idx is not None else None
        rows = xf[safe] if m == wd.GATHER else xf.view(Q, C, D)
        absdot = torch.einsum("qd,qcd->qc", q.abs(), rows.abs())
        xn = sq[safe] if m == wd.GATHER else sq.view(Q, C)
        tol = 1e-5 * ((q * q).sum(1)[:, None] + xn + 2 * absdot)
        err = (got.double() - want.double()).abs()
        assert bool((err <= tol.double()).all()), float(err.max())
        if idx is not None and Q > 1:
            assert bool((got[1] == wd.MAX_DIST).all())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["walk_i8_min_blocks_2",
                                     "gather_passes_1",
                                     "gather_no_evict_last",
                                     "f32i8_4x8",
                                     "f32i8_8x8"])
def test_kernel_sweep_variant_builds_and_keeps_the_bits(cuda, tmp_path,
                                                        monkeypatch,
                                                        variant):
    """tools/cuda_kernel_sweep.py builds a kernel source with one of its
    tuning macros set (-D), reports its registers, and the variant's
    library gives the package library's bits."""
    import importlib.util
    import os

    from sptag_tpu_torch.ops import cascade as tc
    from sptag_tpu_torch.ops import int8_dots
    from sptag_tpu_torch.ops import walk_dots as wd

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "cuda_kernel_sweep", os.path.join(root, "tools",
                                          "cuda_kernel_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    lib, regs = sweep.build(variant, str(tmp_path))
    assert regs
    gen = torch.Generator().manual_seed(31)
    N, D, scale = 2000, 128, 0.0213
    x8 = torch.randint(-127, 128, (N, D), generator=gen).to(torch.int8)
    x8 = x8.to(cuda)
    if variant.startswith("f32i8"):
        # both forms, a hot block and ragged P: the float32 x int8 kernels
        blocks = torch.randint(-127, 128, (7, 300, D), generator=gen).to(
            torch.int8).to(cuda)
        q = torch.randn((64, D), generator=gen).to(cuda)
        topc = torch.randint(0, 7, (64, 3), generator=gen)
        topc[:, 0] = 2
        topc = topc.to(torch.int32).to(cuda)
        union = torch.randint(0, 7, (4, 5), generator=gen).to(
            torch.int32).to(cuda)

        def call():
            return (block_dots.probe_block_dots(blocks, q, topc),
                    block_dots.group_block_dots(blocks, q, union))
        want = call()
        monkeypatch.setattr(block_dots, "library", lambda: lib)
        got = call()
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        return
    if variant.startswith("walk"):
        q, _, idx = _walk_inputs(gen, 9, N, 700, D, cuda)
        sq = wd.row_sqnorms(wd.dequantize(x8, scale).contiguous())

        def call():
            return wd.walk_score(q, x8, idx, sq, wd.L2, wd.GATHER, 700,
                                 scale)
        module = wd
    else:
        q = torch.randn((9, D), generator=gen).to(cuda)
        qq, qs = tc.quantize_queries(q)
        qn = (q * q).sum(1)
        ids = torch.randint(-1, N, (9, 1500), generator=gen)
        ids = ids.to(torch.int32).to(cuda)
        inv = (torch.rand(N, generator=gen) < 0.05).to(cuda)

        def call():
            return int8_dots.int8_gather_dots(qq, qs, qn, x8, ids, inv,
                                              scale, 0, 1)
        module = int8_dots
    want = call()
    monkeypatch.setattr(module, "library", lambda: lib)
    got = call()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_walk_score_i8_and_block_variant_bits_do_not_depend_on_the_batch(
        cuda):
    """The int8 walk scoring and the float32 x int8 block kernel give a
    query the same bits alone, in small batches and in a batch of 1,024."""
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(11)
    q, _, idx = _walk_inputs(gen, 1024, 4000, 300, 64, cuda)
    x8 = torch.randint(-127, 128, (4000, 64), generator=gen).to(
        torch.int8).to(cuda)
    sq = wd.row_sqnorms(wd.dequantize(x8, 0.05).contiguous())
    full = wd.walk_score(q, x8, idx, sq, wd.L2, wd.GATHER, 300, 0.05)
    blocks = torch.randint(-127, 128, (40, 96, 64), generator=gen).to(
        torch.int8).to(cuda)
    topc = torch.randint(0, 40, (1024, 6), generator=gen).to(
        torch.int32).to(cuda)
    probe = block_dots.probe_block_dots(blocks, q, topc)
    for lo, hi in ((0, 1), (5, 12), (100, 116), (300, 429)):
        qs, ids = q[lo:hi].contiguous(), idx[lo:hi].contiguous()
        assert torch.equal(
            wd.walk_score(qs, x8, ids, sq, wd.L2, wd.GATHER, 300, 0.05),
            full[lo:hi])
        assert torch.equal(
            block_dots.probe_block_dots(blocks, qs, topc[lo:hi].contiguous()),
            probe[lo:hi])


def _f32i8_edge_ids(gen, case, C):
    """Block ids of one float32 x int8 edge case: (kind, ids, G)."""
    if case == "tiles":
        # one probe each: tiles of 1, 9, 31 and 32 entries, and a hot block
        # of 70 entries over three tiles
        b = torch.cat([torch.full((n,), blk) for blk, n in
                       ((0, 1), (1, 9), (2, 31), (3, 32), (4, 70))])
        return "probe", b[torch.randperm(len(b), generator=gen)][:, None], 1
    if case == "probe_out_of_range":
        return "probe", torch.randint(-3, C + 3, (40, 4), generator=gen), 1
    if case == "group_out_of_range":
        return "group", torch.randint(-3, C + 3, (5, 4), generator=gen), 8
    kind, rows, cols, G = {"probe": ("probe", 37, 3, 1),
                           "group_g1": ("group", 5, 3, 1),
                           "group_g8": ("group", 4, 4, 8),
                           "group_g32": ("group", 2, 3, 32)}[case]
    ids = torch.randint(0, C, (rows, cols), generator=gen)
    if G == 8:
        ids[:, 0] = 1                         # a block shared by every group
    return kind, ids, G


# (case, C, P, D, misaligned): tiles of 1 to 32 entries and a hot block, P
# not a multiple of the 32-row strip, D = 100 and 8 and unaligned rows or
# queries (vec = 0), out-of-range ids, G = 1, 8 and 32
F32I8_EDGES = [("tiles", 6, 100, 128, None), ("probe", 5, 257, 100, None),
               ("probe", 4, 64, 8, None), ("probe", 4, 40, 128, "blocks"),
               ("probe", 4, 40, 128, "queries"),
               ("probe_out_of_range", 6, 33, 64, None),
               ("group_g1", 6, 257, 128, None),
               ("group_g8", 6, 100, 64, "blocks"),
               ("group_g8", 5, 40, 8, None),
               ("group_g32", 5, 257, 100, None),
               ("group_g32", 4, 256, 128, None),
               ("group_out_of_range", 6, 48, 32, None)]


@pytest.mark.cuda
def test_block_dots_float_queries_on_int8_blocks(cuda):
    """The float32 x int8 variant equals the float32 kernel on the widened
    blocks bit for bit (probe and group forms, aligned and narrow D, and
    the edge cases of F32I8_EDGES), the plain version within 1e-5 * sum
    |q_d x_d|, and counts as f32i8."""
    gen = torch.Generator().manual_seed(5)
    block_dots.reset_launch_counts()
    for C, P, D, Q, nprobe in PROBE:
        blocks = torch.randint(-127, 128, (C, P, D), generator=gen).to(
            torch.int8).to(cuda)
        q = torch.randn((Q, D), generator=gen).to(cuda)
        topc = torch.randint(0, C, (Q, nprobe), generator=gen).to(
            torch.int32).to(cuda)
        got = block_dots.probe_block_dots(blocks, q, topc)
        assert got.dtype == torch.float32
        assert torch.equal(got, block_dots.probe_block_dots(
            blocks.float(), q, topc))
        want = block_dots.probe_block_dots_reference(blocks, q, topc)
        bound = block_dots.probe_block_dots_reference(blocks.abs(), q.abs(),
                                                      topc)
        assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all())
    for C, P, D, NG, U, G in GROUP:
        blocks = torch.randint(-127, 128, (C, P, D), generator=gen).to(
            torch.int8).to(cuda)
        q = torch.randn((NG * G, D), generator=gen).to(cuda)
        union = torch.randint(0, C, (NG, U), generator=gen).to(
            torch.int32).to(cuda)
        got = block_dots.group_block_dots(blocks, q, union)
        assert torch.equal(got, block_dots.group_block_dots(
            blocks.float(), q, union))
        want = block_dots.group_block_dots_reference(blocks, q, union)
        bound = block_dots.group_block_dots_reference(blocks.abs(), q.abs(),
                                                      union)
        assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all())
    counts = block_dots.launch_counts()
    assert counts["probe_block_dots_f32i8"] == len(PROBE)
    assert counts["group_block_dots_f32i8"] == len(GROUP)
    calls = {"probe": 0, "group": 0}
    for case, C, P, D, misaligned in F32I8_EDGES:
        kind, ids, G = _f32i8_edge_ids(gen, case, C)
        ids = ids.to(torch.int32).to(cuda)
        blocks = torch.randint(-127, 128, (C, P, D), generator=gen).to(
            torch.int8).to(cuda)
        q = torch.randn((ids.shape[0] * G, D), generator=gen).to(cuda)
        if misaligned == "blocks":
            blocks = _misaligned(blocks)
        elif misaligned == "queries":
            q = _misaligned(q)
        fn = getattr(block_dots, f"{kind}_block_dots")
        got = fn(blocks, q, ids)
        calls[kind] += 1
        assert torch.equal(got, fn(blocks.float(), q.contiguous(), ids)), \
            case
        want = _plain(kind, blocks, q, ids)
        bound = _plain(kind, blocks.abs(), q.abs(), ids)
        assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all()), \
            case
    counts = block_dots.launch_counts()
    assert counts["probe_block_dots_f32i8"] == len(PROBE) + calls["probe"]
    assert counts["group_block_dots_f32i8"] == len(GROUP) + calls["group"]


def _cascade_corpus(n=3000, d=32, nq=64, seed=9):
    """Integer rows with max |x| = 127: the int8 scale is 1, so every
    stage is exact and the card must give the CPU's ids and distances."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-90, 90, (16, d))
    data = centers[rng.integers(0, 16, n)] + rng.integers(-30, 31, (n, d))
    data[0, 0] = 127
    q = centers[rng.integers(0, 16, nq)] + rng.integers(-30, 31, (nq, d))
    return (np.clip(data, -127, 127).astype(np.float32),
            np.clip(q, -127, 127).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["device", "host", "host_all"])
def test_flat_cascade_on_card_matches_cpu(cuda, tier):
    """FLAT's cascade and sketch prefilter on the card: the CPU's ids and
    distances, every cascade kernel launched."""
    from sptag_tpu_torch.ops import int8_dots, sketch_dots
    from sptag_tpu_torch.ops import walk_dots as wd

    data, q = _cascade_corpus()
    out = {}
    for dev in ("cpu", "cuda"):
        idx = tsp.create_instance("FLAT", "Float", device=dev)
        for k, v in (("DistCalcMethod", "L2"), ("CascadeSearch", "1"),
                     ("TierBudgetSketch", "512"), ("TierBudgetInt8", "128"),
                     ("CorpusTier", tier)):
            idx.set_parameter(k, v)
        idx.build(data)
        sketch_dots.reset_launch_counts()
        int8_dots.reset_launch_counts()
        wd.reset_launch_counts()
        out[dev] = idx.search_batch(q, 10)
        if dev == "cuda":
            assert sketch_dots.launch_counts()["sketch_hamming"] >= 1
            assert int8_dots.launch_counts()["int8_gather_dots"] >= 1
            assert wd.launch_counts()["walk_score_f32"] >= 1
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "beam"])
def test_graph_cascade_on_card_matches_cpu(cuda, mode):
    """The dense cascade (float32 x int8 blocks) and the cascade walk
    (walk_score_i8) on the card, both tiers: the CPU's ids and distances;
    the host tier's segmented and scheduled walks equal its monolithic
    one."""
    from sptag_tpu_torch.ops import walk_dots as wd

    data, q = _cascade_corpus()
    built = tsp.create_instance("BKT", "Float", device="cpu")
    for k, v in (("DistCalcMethod", "L2"), ("TPTNumber", "2"),
                 ("CEF", "64"), ("MaxCheckForRefineGraph", "128"),
                 ("FinalRefineSearchMode", "same"), ("BKTKmeansK", "8")):
        built.set_parameter(k, v)
    built.build(data)
    pair = {"cpu": built,
            "cuda": tsp.load_index_blobs(*built.save_index_blobs(),
                                         device="cuda")}
    for tier in ("device", "host"):
        got = {}
        for dev, idx in pair.items():
            for k, v in (("SearchMode", mode), ("CascadeSearch", "1"),
                         ("TierBudgetInt8", "128"), ("CorpusTier", tier)):
                idx.set_parameter(k, v)
            block_dots.reset_launch_counts()
            wd.reset_launch_counts()
            got[dev] = idx.search_batch(q, 10, max_check=512)
            if dev == "cuda" and mode == "dense":
                counts = block_dots.launch_counts()
                assert counts["probe_block_dots_f32i8"] \
                    + counts["group_block_dots_f32i8"] >= 1, counts
            if dev == "cuda" and mode == "beam":
                assert wd.launch_counts()["walk_score_i8"] >= 1
        np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
        np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
        if mode == "beam" and tier == "host":
            idx = pair["cuda"]
            idx.set_parameter("ContinuousBatching", "1")
            d3, i3 = idx.search_batch(q, 10, max_check=512)
            idx.set_parameter("ContinuousBatching", "0")
            np.testing.assert_array_equal(i3, got["cuda"][1])
            assert d3.tobytes() == got["cuda"][0].tobytes()
    for idx in pair.values():
        idx.close()


# ---- the device half of observability and the mesh --------------------------

@pytest.mark.cuda
def test_sentinel_flags_a_card_sync_in_a_hot_section(cuda, monkeypatch):
    """An implicit .item() of a CUDA tensor inside a hot section is a
    violation (strict: it raises); device_get inside the section and any
    sync outside one are not; the shims go with reset_tracesan()."""
    from sptag_tpu_torch.utils import recompile_guard as rg

    monkeypatch.setenv("SPTAG_TRACESAN", "")
    rg.reset_tracesan()
    t = torch.arange(6, device=cuda)
    try:
        rg.enable_tracesan(strict=False)
        with rg.hot_section("scheduler.cycle"):
            t[1].item()
            host = rg.device_get(t)
        assert rg.violation_count() == 1
        assert rg.violations()[0]["kind"] == "item"
        np.testing.assert_array_equal(host, np.arange(6))
        t[2].item()
        float(t[3])
        assert rg.violation_count() == 1
        rg.enable_tracesan(strict=True)
        with rg.hot_section("engine.walk"):
            with pytest.raises(rg.TransferSyncError):
                bool(t[0])
            rg.device_get(t.sum())
    finally:
        rg.reset_tracesan()
    assert not rg.shims_installed()


@pytest.mark.cuda
def test_graph_capture_and_nvcc_build_are_counted(cuda, monkeypatch,
                                                  tmp_path):
    """A whole-walk CUDA graph is captured once per key and counted as a
    compile (then replayed without one); a kernel library's nvcc build is
    counted too."""
    from sptag_tpu_torch import _build
    from sptag_tpu_torch.utils import recompile_guard as rg

    data = _int_rows(2000, 16, seed=70)
    q = _int_rows(8, 16, seed=71)
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "2"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "128"),
                        ("FinalRefineSearchMode", "same"),
                        ("SearchMode", "beam")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    card = tsp.load_index_blobs(*idx.save_index_blobs(), device="cuda")
    card.set_parameter("SearchMode", "beam")
    try:
        want = card.search_batch(q, 5)             # first sighting: eager
        with rg.track_compiles("capture") as log:
            got = card.search_batch(q, 5)          # second: captured
        assert log.kinds.get(rg.CAPTURE, 0) >= 1, log.kinds
        with rg.no_recompiles("replay"):
            again = card.search_batch(q, 5)
        np.testing.assert_array_equal(got[1], want[1])
        assert again[0].tobytes() == got[0].tobytes()
    finally:
        card.close()
        idx.close()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with rg.track_compiles("build") as log:
        so, seconds = _build.build("sketch_dots")
    assert os.path.exists(so) and seconds > 0
    assert log.kinds == {rg.BUILD: 1}


@pytest.mark.cuda
def test_two_shard_mesh_on_one_card_equals_the_plain_merge(cuda, tmp_path):
    """A 2-shard mesh on [cuda:0, cuda:0] returns the merge of its shards'
    own beam searches (concatenated in shard order, stable top-k) and the
    CPU mesh's ids and distances (integer rows); its dense scan launches
    probe_block_dots on the card in each shard."""
    from sptag_tpu_torch.parallel import sharded

    data = _int_rows(3000, 16, seed=72)
    q = _int_rows(32, 16, seed=73)
    params = {"TPTNumber": 2, "CEF": 64, "MaxCheckForRefineGraph": 128,
              "FinalRefineSearchMode": "same", "MaxCheck": 512}
    folder = str(tmp_path / "mesh")
    sharded.ShardedBKTIndex.build(data, 0, mesh=sharded.Mesh(["cpu"] * 2),
                                  params=params, save_to=folder)
    on_cpu = sharded.ShardedBKTIndex.load(
        folder, mesh=sharded.Mesh(["cpu"] * 2), dense=True)
    m = sharded.ShardedBKTIndex.load(
        folder, mesh=sharded.Mesh(["cuda:0", "cuda:0"]), dense=True)
    d, ids = m.search(q, 10)
    parts_d, parts_i = [], []
    for s, eng in enumerate(m.engines):
        sd, si = eng.search(q, 10, m.max_check, m.beam_width, None,
                            m.nbp_limit)
        parts_d.append(sd)
        parts_i.append(np.where(si >= 0, si + s * m.n_local, -1))
    all_d = np.concatenate(parts_d, 1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(
        ids, np.take_along_axis(np.concatenate(parts_i, 1), order, 1))
    np.testing.assert_array_equal(d, np.take_along_axis(all_d, order, 1))
    cd, ci = on_cpu.search(q, 10)
    np.testing.assert_array_equal(ids, ci)
    np.testing.assert_array_equal(d, cd)
    block_dots.reset_launch_counts()
    dd, di = m.search_dense(q, 10)
    assert block_dots.launch_counts()["probe_block_dots_f32"] >= 2
    np.testing.assert_array_equal(di, on_cpu.search_dense(q, 10)[1])


# ---- several cards: an engine on a card that is not the current one, and
# the mesh with one shard a card ---------------------------------------------

@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards (on a machine with several: "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py -k 'second_card or own_card "
                    "or its_cards')")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _engines_on(devices, binned="off", seed=81):
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.core.types import DistCalcMethod

    n = 3000
    data = _int_rows(n, 32, seed=seed)
    graph = _weak_graph(n, 16, seed=seed + 1)
    pivots = np.random.default_rng(seed + 2).choice(n, 400, replace=False)
    return [teng.GraphSearchEngine(data, graph, pivots, None,
                                   DistCalcMethod.L2, 1, binned_topk=binned,
                                   device=dev) for dev in devices]


@pytest.mark.cuda
@pytest.mark.parametrize("binned", ["off", "on"])
def test_walk_on_a_second_card_equals_the_first_cards(two_cards, binned):
    """With cuda:0 current, an engine on cuda:1 returns the bits of the
    same engine on cuda:0 and of the CPU: the eager walk (more than
    _GRAPH_MAX_Q queries) and the small chunks' walk graph, asked for
    three times (eager, captured, replayed), on fresh queries each time:
    a graph captured off its card would replay stale outputs."""
    q = _int_rows(300, 32, seed=84)
    engines = _engines_on(list(two_cards) + ["cpu"], binned)
    assert torch.cuda.current_device() == 0

    def all_equal(qq, **kw):
        out = [e.search(qq, 10, max_check=512, **kw) for e in engines]
        for d, ids in out[:2]:
            np.testing.assert_array_equal(ids, out[2][1])
            assert d.tobytes() == out[2][0].tobytes()
    all_equal(q)                                   # eager
    for lo in (0, 4, 8, 12):                       # eager, capture, replays
        all_equal(q[lo:lo + 4])
    assert len(engines[1]._graphs) == 1
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_scheduler_segments_on_a_second_card_replay_its_graphs(two_cards):
    """With cuda:0 current, a slot scheduler over an engine on cuda:1
    captures and replays its segments as CUDA graphs on cuda:1 and
    returns the monolithic walk's ids and distances."""
    from sptag_tpu_torch.algo.scheduler import BeamSlotScheduler

    q = _int_rows(200, 32, seed=85)
    e1, cpu = _engines_on([two_cards[1], "cpu"])
    want = cpu.search(q, 10, max_check=1024)
    sched = BeamSlotScheduler(e1, slots=32, segment_iters=2)
    try:
        for _ in range(2):
            got = sched.search_batch(q, 10, 1024)
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].tobytes() == want[0].tobytes()
        stats = sched.stats()
    finally:
        sched.stop()
    assert stats["graphs_captured"] >= 1 and stats["segments_replayed"] > 0
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_segment_timer_times_its_own_card(two_cards):
    """The sampled segment timer's events sit on its engine's card: work
    queued on cuda:1 between its start and its end shows in its reading
    while cuda:0 is current and idle."""
    _, e1 = _engines_on(two_cards)
    e1.device_sample_rate = 1.0
    a = torch.randn(4096, 4096, device=two_cards[1])
    a = a @ a / 64.0                      # cuBLAS's first call, untimed
    torch.cuda.synchronize(two_cards[1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(two_cards[1])
    start.record(stream)
    for _ in range(8):
        a = a @ a / 64.0
    end.record(stream)
    end.synchronize()
    work_ms = start.elapsed_time(end)
    timer = e1.segment_timer()
    for _ in range(8):
        a = a @ a / 64.0
    ns = timer()
    assert ns >= 0.5 * work_ms * 1e6, (ns, work_ms)


@pytest.mark.cuda
def test_kernel_wrappers_on_a_second_card_equal_the_first(two_cards):
    """Every kernel wrapper launched on cuda:1 while cuda:0 is current
    returns the bits it returns on cuda:0 (block dots f32 / int8, the
    walk's seeding and scoring, the gathered int8 tier, the Hamming
    scan), and counts its launches on the card it ran on."""
    from sptag_tpu_torch.ops import cascade as tc
    from sptag_tpu_torch.ops import int8_dots, sketch_dots
    from sptag_tpu_torch.ops import walk_dots as wd

    gen = torch.Generator().manual_seed(86)
    blocks = torch.randn((9, 32, 128), generator=gen)
    blocks8 = torch.randint(-128, 128, (9, 32, 128), generator=gen).to(
        torch.int8)
    q = torch.randn((16, 128), generator=gen)
    q8 = torch.randint(-128, 128, (16, 128), generator=gen).to(torch.int8)
    topc = torch.randint(0, 9, (16, 3), generator=gen).to(torch.int32)
    union = torch.randint(0, 9, (2, 4), generator=gen).to(torch.int32)
    rows = torch.randn((500, 128), generator=gen)
    idx = torch.randint(-1, 500, (16, 64), generator=gen)
    x8 = torch.randint(-127, 128, (500, 128), generator=gen).to(torch.int8)
    qb = torch.randint(-2 ** 31, 2 ** 31, (16, 4), generator=gen,
                       dtype=torch.int64).to(torch.int32)
    sk = torch.randint(-2 ** 31, 2 ** 31, (700, 4), generator=gen,
                       dtype=torch.int64).to(torch.int32)
    inv = torch.rand(700, generator=gen) < 0.1

    def run(dev):
        t = {k: v.to(dev) for k, v in dict(
            blocks=blocks, blocks8=blocks8, q=q, q8=q8, topc=topc,
            union=union, rows=rows, idx=idx, x8=x8, qb=qb, sk=sk,
            inv=inv).items()}
        sq = wd.row_sqnorms(t["rows"])
        qq, qs = tc.quantize_queries(t["q"])
        return [
            block_dots.probe_block_dots(t["blocks"], t["q"], t["topc"]),
            block_dots.probe_block_dots(t["blocks8"], t["q8"], t["topc"]),
            block_dots.group_block_dots(t["blocks"], t["q"], t["union"]),
            block_dots.group_block_dots(t["blocks8"], t["q8"], t["union"]),
            sq,
            wd.walk_seed(t["q"], t["rows"], sq, wd.L2),
            wd.walk_score(t["q"], t["rows"], t["idx"], sq, wd.L2, wd.GATHER,
                          64),
            int8_dots.int8_gather_dots(qq, qs, (t["q"] * t["q"]).sum(1),
                                       t["x8"], t["idx"].to(torch.int32),
                                       None, 0.03, 0, 1),
            sketch_dots.hamming(t["qb"], t["sk"], t["inv"])]
    block_dots.reset_launch_counts()
    wd.reset_launch_counts()
    on0, on1 = run(two_cards[0]), run(two_cards[1])
    assert torch.cuda.current_device() == 0
    for a, b in zip(on0, on1):
        assert b.device == two_cards[1]
        assert torch.equal(a.cpu(), b.cpu())
    by_card = block_dots.launch_counts_by_card()
    assert by_card["cuda:0"] == by_card["cuda:1"]
    assert by_card["cuda:1"]["probe_block_dots_f32"] == 1
    walk = wd.launch_counts_by_card()
    assert walk["cuda:1"]["walk_seed_f32"] == 1
    assert walk["cuda:1"]["walk_score_f32"] == 1


@pytest.mark.cuda
def test_mesh_on_its_cards_equals_the_mesh_on_one_card(two_cards, tmp_path):
    """One shard a card (up to four cards) returns the bits of the same
    folder loaded as [cuda:0] x n: the beam walk, the dense scan and the
    mesh scheduler (its segment graphs captured and replayed on every
    card); each card launches its shard's kernels, and only candidates,
    seated queries, t_limit and alive flags cross between cards."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.ops import walk_dots as wd
    from sptag_tpu_torch.parallel import sharded

    n = min(4, torch.cuda.device_count())
    data = _int_rows(4000, 16, seed=87)
    q = _int_rows(64, 16, seed=88)
    params = {"TPTNumber": 2, "CEF": 64, "MaxCheckForRefineGraph": 128,
              "FinalRefineSearchMode": "same", "MaxCheck": 512}
    folder = str(tmp_path / "mesh")
    sharded.ShardedBKTIndex.build(data, 0, mesh=sharded.Mesh(["cpu"] * n),
                                  params=params, save_to=folder)
    cards = sharded.ShardedBKTIndex.load(
        folder, mesh=sharded.Mesh([f"cuda:{i}" for i in range(n)]),
        dense=True)
    one = sharded.ShardedBKTIndex.load(
        folder, mesh=sharded.Mesh(["cuda:0"] * n), dense=True)
    block_dots.reset_launch_counts()
    wd.reset_launch_counts()
    sharded.reset_card_transfer_bytes()
    got = [cards.search(q, 10), cards.search_dense(q, 10)]
    walk = wd.launch_counts_by_card()
    dense = block_dots.launch_counts_by_card()
    assert set(sharded.card_transfer_bytes()) == {"candidates"}
    want = [one.search(q, 10), one.search_dense(q, 10)]
    for (d, ids), (wd_, wi) in zip(got, want):
        np.testing.assert_array_equal(ids, wi)
        assert d.tobytes() == wd_.tobytes()
    for i in range(n):
        assert walk[f"cuda:{i}"]["walk_seed_f32"] >= 1
        assert walk[f"cuda:{i}"]["walk_score_f32"] >= 1
        assert dense[f"cuda:{i}"]["probe_block_dots_f32"] >= 1
    teng.reset_graph_stats()
    sharded.reset_card_transfer_bytes()
    sched = cards.enable_continuous_batching(slots=64, segment_iters=2)
    try:
        for _ in range(2):
            futs = cards.submit_batch(q, 10)
            res = [f.result(timeout=120) for f in futs]
            np.testing.assert_array_equal(np.stack([r[1] for r in res]),
                                          want[0][1])
            assert np.stack([r[0] for r in res]).tobytes() == \
                want[0][0].tobytes()
        stats = sched.stats()
    finally:
        cards.retire_scheduler()
    assert stats["segments_replayed"] > 0
    graphs = teng.graph_stats()
    for i in range(n):
        assert graphs[f"cuda:{i}"]["segment_captures"] >= 1
        assert graphs[f"cuda:{i}"]["segment_replays"] >= 1
    assert set(sharded.card_transfer_bytes()) <= {
        "queries", "t_limit", "alive", "candidates"}
    assert torch.cuda.current_device() == 0
