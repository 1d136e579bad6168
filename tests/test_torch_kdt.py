"""The KDT index of the PyTorch port against the JAX package's.

The kd-tree forest is host numpy in both packages with the same generator
draws, so the same data and seed give the same nodes, seeds and kd-cell
partitions — exactly, not only the same invariants.  On integer-valued
float32 rows (L2) every distance is exact in both packages, so a KDT index
built by each from the same corpus gives the same graph and the same ids.
"""

import os
import tarfile

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.algo.dense import partition_from_kdtree as j_partition
from sptag_tpu.trees.kdtree import KDTree as JKDTree
from sptag_tpu_torch.algo.dense import partition_from_kdtree as t_partition
from sptag_tpu_torch.io import format as tfmt
from sptag_tpu_torch.trees.kdtree import KDTree as TKDTree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D = 16


def _rows(n, seed, scale=2.0):
    """Integer-valued clustered rows."""
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(77).standard_normal((24, D)) \
        .astype(np.float32) * 4.0
    x = cent[rng.integers(0, 24, n)] + rng.standard_normal((n, D)) \
        .astype(np.float32)
    return np.round(x * scale)


DATA = _rows(1500, seed=1)
QUERIES = _rows(64, seed=2)
SETTINGS = [("DistCalcMethod", "L2"), ("KDTNumber", "2"), ("TPTNumber", "4"),
            ("TPTLeafSize", "500"), ("CEF", "64"),
            ("MaxCheckForRefineGraph", "128"), ("NeighborhoodSize", "16"),
            ("MaxCheck", "512"), ("RefineQueryGroup", "32"),
            ("AddCEF", "32"), ("DenseClusterSize", "128")]


@pytest.mark.parametrize("trees,top_dims,samples,n", [(1, 5, 100, 1500),
                                                      (2, 3, 64, 700),
                                                      (3, 5, 100, 1)])
def test_kdtree_nodes_seeds_and_partition_equal_jax(trees, top_dims,
                                                    samples, n):
    data = DATA[:n] if n > 1 else DATA[:1]
    a = JKDTree(tree_number=trees, top_dims=top_dims, samples=samples)
    b = TKDTree(tree_number=trees, top_dims=top_dims, samples=samples)
    a.build(data)
    b.build(data)
    np.testing.assert_array_equal(b.tree_starts, a.tree_starts)
    assert b.nodes.dtype == tfmt.KDT_NODE_DTYPE == a.nodes.dtype
    np.testing.assert_array_equal(b.nodes, a.nodes)
    for backtrack in (0, 4, 9):
        np.testing.assert_array_equal(
            b.collect_seeds(QUERIES, backtrack=backtrack),
            a.collect_seeds(QUERIES, backtrack=backtrack))
    for target in (64, 200):
        ca, cb = j_partition(a, n, target), t_partition(b, n, target)
        np.testing.assert_array_equal(cb[0], ca[0])
        assert len(cb[1]) == len(ca[1])
        for x, y in zip(cb[1], ca[1]):
            np.testing.assert_array_equal(x, y)
        assert sorted(np.concatenate(cb[1]).tolist()) == list(range(n))


def test_kdtree_file_interchanges(tmp_path):
    a = JKDTree(tree_number=2)
    a.build(DATA[:400])
    path = str(tmp_path / "tree.bin")
    a.save(path)
    b = TKDTree.load(path)
    np.testing.assert_array_equal(b.nodes, a.nodes)
    b.save(str(tmp_path / "again.bin"))
    assert open(path, "rb").read() == \
        open(str(tmp_path / "again.bin"), "rb").read()


def test_reference_built_fixture_seeded_walk_equals_jax(tmp_path):
    """The KDT folder built by SPTAG's own indexbuilder loads in the port;
    the seeded walk and the kd-cell dense search return the JAX package's
    ids on the same folder, distances within float32 rounding."""
    with tarfile.open(os.path.join(FIXTURES,
                                   "ref_built_kdt_2000x16.tar.gz")) as tf:
        tf.extractall(str(tmp_path), filter="data")
    folder = str(tmp_path / "fix_index")
    data = np.load(str(tmp_path / "fix_data.npy"))
    rng = np.random.default_rng(0)
    q = (data[rng.choice(len(data), 64, replace=False)]
         + rng.standard_normal((64, D)) * 0.3).astype(np.float32)
    ref = jsp.load_index(folder)
    got = tsp.load_index(folder, device="cpu")
    assert got.num_samples == ref.num_samples == len(data)
    np.testing.assert_array_equal(got._tree.nodes, ref._tree.nodes)
    for mode in ("beam", "dense"):
        for max_check in (256, 1024):
            d_ref, i_ref = ref.search_batch(q, 10, max_check=max_check,
                                            search_mode=mode)
            d_got, i_got = got.search_batch(q, 10, max_check=max_check,
                                            search_mode=mode)
            np.testing.assert_array_equal(i_got, i_ref)
            np.testing.assert_allclose(d_got, d_ref, rtol=1e-5, atol=1e-3)
    resave = str(tmp_path / "resaved")
    got.save_index(resave)
    for name in ("vectors.bin", "tree.bin", "graph.bin", "deletes.bin"):
        assert open(os.path.join(resave, name), "rb").read() == \
            open(os.path.join(folder, name), "rb").read(), name


def _kdt(pkg, final, **kw):
    idx = pkg.create_instance("KDT", "Float", **kw)
    for name, value in SETTINGS + [("FinalRefineSearchMode", final)]:
        assert idx.set_parameter(name, value)
    return idx


@pytest.mark.parametrize("final", ["same", "beam"])
def test_kdt_built_in_both_packages_is_equal(tmp_path, final):
    """Tree, TPT candidates, the dense refine passes over the kd-cell
    partition and the final pass (the kd-seeded engine's pivot walk, or
    the dense scan again) draw and tie alike: the graphs are bit-equal
    and the searches return the same ids."""
    ref, got = _kdt(jsp, final), _kdt(tsp, final, device="cpu")
    ref.build(DATA)
    got.build(DATA)
    np.testing.assert_array_equal(got._tree.nodes, ref._tree.nodes)
    np.testing.assert_array_equal(got._graph, ref._graph.graph)
    ids = {}
    for mode in ("beam", "dense"):
        d_ref, ids[mode] = ref.search_batch(QUERIES, 10, search_mode=mode)
        d_got, i_got = got.search_batch(QUERIES, 10, search_mode=mode)
        np.testing.assert_array_equal(i_got, ids[mode])
        np.testing.assert_array_equal(d_got, d_ref)
    if final == "same":
        folder = str(tmp_path / "k")
        got.save_index(folder)
        back = jsp.load_index(folder)
        _, i_back = back.search_batch(QUERIES, 10, search_mode="beam")
        np.testing.assert_array_equal(i_back, ids["beam"])
    got.close()


@pytest.mark.parametrize("final", ["same", "beam"])
def test_kdt_full_compaction_equals_jax(final):
    """Adds, deletes and the whole compaction (remap, kd forest rebuild,
    the refine pass, the orphan repair) in both packages: the kd forest
    draws alike, so the compacted forest, graph and ids are equal.  64
    pivots (not every row) make the walk of a beam pass read the remapped
    graph."""
    ref, got = _kdt(jsp, final), _kdt(tsp, final, device="cpu")
    for idx in (ref, got):
        assert idx.set_parameter("NumberOfInitialDynamicPivots", "2")
        idx.build(DATA[:1200])
        assert int(idx.add(DATA[1200:1300])) == 0
        assert int(idx.delete(DATA[0:400:4])) == 0
    dels = ref.num_deleted
    assert got.num_deleted == dels > 0
    np.testing.assert_array_equal(got._graph, ref._graph.graph)
    assert int(got.refine_index()) == int(ref.refine_index()) == 0
    assert got.num_samples == ref.num_samples == 1300 - dels
    np.testing.assert_array_equal(got._host[:got._n], ref._host[:ref._n])
    np.testing.assert_array_equal(got._tree.nodes, ref._tree.nodes)
    np.testing.assert_array_equal(got._graph, ref._graph.graph)
    for mode in ("beam", "dense"):
        d_ref, i_ref = ref.search_batch(QUERIES, 10, search_mode=mode)
        d_got, i_got = got.search_batch(QUERIES, 10, search_mode=mode)
        np.testing.assert_array_equal(i_got, i_ref, err_msg=mode)
        np.testing.assert_array_equal(d_got, d_ref, err_msg=mode)
    got.close()


def test_kdt_add_delete_dense_replicas_and_recall():
    """KDT add, delete and refine (BKT's machinery) and dense search with
    DenseReplicas=2 on the port; recall against the exact truth."""
    idx = _kdt(tsp, "same", device="cpu")
    idx.build(DATA[:1200])
    assert idx.add(DATA[1200:1300]) == tsp.ErrorCode.Success
    _, ids = idx.search_batch(DATA[1200:1300], 1, search_mode="beam")
    assert np.mean(ids[:, 0] == np.arange(1200, 1300)) >= 0.95
    assert idx.delete(DATA[1200:1210]) == tsp.ErrorCode.Success
    assert idx.num_deleted >= 9
    _, ids = idx.search_batch(DATA[1200:1210], 5, search_mode="beam")
    assert not idx._deleted[ids[ids >= 0]].any()
    truth = idx.exact_search_batch(QUERIES, 10)[1]
    for mode, replicas in (("beam", 1), ("dense", 1), ("dense", 2)):
        idx.set_parameter("DenseReplicas", str(replicas))
        _, ids = idx.search_batch(QUERIES, 10, search_mode=mode)
        recall = np.mean([len(set(a) & set(t)) / 10
                          for a, t in zip(ids, truth)])
        assert recall >= 0.9, (mode, replicas, recall)
    idx.refine_index()
    assert idx.num_deleted == 0 and idx.num_samples == 1300 - 10
    _, ids = idx.search_batch(QUERIES, 10, search_mode="beam")
    assert (ids >= 0).all()
    idx.close()


def test_kdt_continuous_batching_raises_naming_the_scheduler():
    """The slot scheduler is ported: ContinuousBatching=1 no longer
    raises, and the kd-seeded queries it schedules return the monolithic
    walk's ids (tests/test_torch_scheduler.py holds them to the JAX
    package's)."""
    idx = _kdt(tsp, "same", device="cpu")
    idx.build(DATA[:300])
    want = idx.search_batch(QUERIES[:8], 5, search_mode="beam")
    idx.set_parameter("ContinuousBatching", "1")
    got = idx.search_batch(QUERIES[:8], 5, search_mode="beam")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert idx._scheduler.stats()["retired"] == 8
    idx.close()
