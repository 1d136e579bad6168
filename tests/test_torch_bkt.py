"""End to end: the port's BKT index (BuildGraph=0, SearchMode=dense)
against the JAX package's, through folders and carried state.

Comparisons follow tests/test_torch_dense.py: exact for int8 cosine,
float32 distances within rtol 1e-5 and ids equal at separated ranks.
"""

import os

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu_torch.state import bkt_index_from_arrays
from test_torch_dense import assert_same_neighbors

@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is several times faster here
    than a pool contended by the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BLOBS = ("vectors.bin", "tree.bin", "graph.bin", "deletes.bin",
         "indexloader.ini", "manifest.json")


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


SETTINGS = {
    "Float": [("DistCalcMethod", "L2"), ("BuildGraph", "0"),
              ("BKTKmeansK", "8"), ("DenseClusterSize", "128"),
              ("MaxCheck", "512")],
    "Int8": [("DistCalcMethod", "Cosine"), ("BuildGraph", "0"),
             ("BKTKmeansK", "8"), ("DenseClusterSize", "64"),
             ("MaxCheck", "1024"), ("DenseQueryGroup", "32"),
             ("DenseUnionFactor", "4")],
}


def _configure(index, vt):
    for name, value in SETTINGS[vt]:
        assert index.set_parameter(name, value)
    return index


def _read(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("vt", ["Float", "Int8"])
def test_jax_folder_loads_in_port_and_saves_identical_bytes(tmp_path, vt):
    data, q = _corpus(3000, 16, 256, seed=1, int8=vt == "Int8")
    ref = _configure(jsp.create_instance("BKT", vt), vt)
    ref.build(data)
    jdir = str(tmp_path / "jax")
    ref.save_index(jdir)
    got = tsp.load_index(jdir, device="cpu")
    d_ref, i_ref = ref.search_batch(q, 10)
    d_got, i_got = got.search_batch(q, 10)
    assert got.last_effective_group == ref._dense.last_effective_group
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=vt == "Int8")
    tdir = str(tmp_path / "port")
    assert got.save_index(tdir) == tsp.ErrorCode.Success
    for name in BLOBS:
        assert _read(tdir, name) == _read(jdir, name), name


@pytest.mark.parametrize("vt", ["Float", "Int8"])
def test_port_folder_loads_in_jax(tmp_path, vt):
    data, q = _corpus(2500, 16, 256, seed=2, int8=vt == "Int8")
    mine = _configure(tsp.create_instance("BKT", vt, device="cpu"), vt)
    mine.build(data)
    folder = str(tmp_path / "idx")
    assert mine.save_index(folder) == tsp.ErrorCode.Success
    theirs = jsp.load_index(folder)
    d_ref, i_ref = theirs.search_batch(q, 10)
    d_got, i_got = mine.search_batch(q, 10)
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=vt == "Int8")


def _wilson(p, n, z=1.96):
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z / denom * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return center - half, center + half


def test_port_built_recall_within_jax_wilson_interval():
    """Each package builds its own tree on the same corpus; the port's
    recall@10 against exact truth lies in the Wilson 95% interval of the
    JAX-built index's (each result slot one trial).  Both trees come from
    fixed seeds: recall varies from tree to tree by more than this
    interval in either package, so the test pins the two builds."""
    data, q = _corpus(4000, 16, 256, seed=3)
    truth = np.argsort(((q[:, None, :] - data[None]) ** 2).sum(-1),
                       axis=1, kind="stable")[:, :10]

    def recall(index):
        _, ids = index.search_batch(q, 10, max_check=640)
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])

    ref = _configure(jsp.create_instance("BKT", "Float"), "Float")
    ref.build(data)
    mine = _configure(tsp.create_instance("BKT", "Float", device="cpu"),
                      "Float")
    mine.build(data)
    lo, hi = _wilson(recall(ref), q.shape[0] * 10)
    assert lo <= recall(mine) <= hi


def test_carried_state_with_tombstones_and_metadata(tmp_path):
    """JAX index state (corpus, forest, tombstones, graph, config) carried
    into the port searches alike and saves the same bytes."""
    data, q = _corpus(2000, 16, 128, seed=4)
    metas = jsp.MetadataSet(str(i).encode() for i in range(len(data)))
    ref = _configure(jsp.create_instance("BKT", "Float"), "Float")
    ref.build(data, metas, with_meta_index=True)
    for i in range(0, 2000, 7):
        ref.delete_by_metadata(str(i).encode())
    got = bkt_index_from_arrays(
        ref._host[:ref._n], ref._tree.tree_starts, ref._tree.nodes,
        ref._deleted[:ref._n], ref._graph.graph, ref.save_index_config(),
        device="cpu")
    got.metadata = tsp.MetadataSet(str(i).encode() for i in range(2000))
    got.build_meta_mapping()
    assert got.num_deleted == ref.num_deleted == len(range(0, 2000, 7))
    d_ref, i_ref = ref.search_batch(q, 10)
    d_got, i_got = got.search_batch(q, 10)
    assert_same_neighbors(d_ref, i_ref, d_got, i_got)
    assert not (i_got[i_got >= 0] % 7 == 0).any()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    ref.save_index(jdir)
    got.save_index(tdir)
    for name in BLOBS + ("metadata.bin", "metadataIndex.bin"):
        assert _read(tdir, name) == _read(jdir, name), name
    back = tsp.load_index(tdir, device="cpu")
    res = back.search(q[0], 5, with_metadata=True)
    assert res.metas == [str(int(v)).encode() for v in res.ids]


def test_save_load_round_trip_and_overwrite(tmp_path):
    data, q = _corpus(1500, 16, 64, seed=5)
    idx = _configure(tsp.create_instance("BKT", "Float", device="cpu"),
                     "Float")
    assert idx.build(data) == tsp.ErrorCode.Success
    d0, i0 = idx.search_batch(q, 10)
    folder = str(tmp_path / "idx")
    for _ in range(2):                     # fresh save, then overwrite
        assert idx.save_index(folder) == tsp.ErrorCode.Success
    assert sorted(os.listdir(tmp_path)) == ["idx"]
    back = tsp.load_index(folder, device="cpu")
    d1, i1 = back.search_batch(q, 10)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    with open(os.path.join(folder, "vectors.bin"), "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 1]))
    from sptag_tpu_torch.io.atomic import ManifestError
    with pytest.raises(ManifestError):
        tsp.load_index(folder, device="cpu")


def test_search_contract_padding_and_modes():
    data, q = _corpus(300, 16, 4, seed=6)
    idx = _configure(tsp.create_instance("BKT", "Float", device="cpu"),
                     "Float")
    idx.build(data)
    d, ids = idx.search_batch(q, 400)          # k beyond the corpus
    assert ids.shape == (4, 400) and (ids[:, 300:] == -1).all()
    assert (d[:, 300:] == np.float32(3.4e38)).all()
    res = idx.search(data[7], 3, search_mode="auto")
    assert res.ids[0] == 7
    with pytest.raises(RuntimeError):
        idx.search(q[0], 3, search_mode="beam")
    with pytest.raises(ValueError):
        idx.search(np.zeros(5, np.float32), 3)


def test_not_ported_paths_raise_naming_the_roadmap():
    """The library defaults (BuildGraph=1, FinalRefineSearchMode=beam)
    build and serve beam, auto and dense with BinnedTopK, take adds,
    deletes and a refine, and serve the walk's options and the cascade:
    nothing of this slice raises NotImplementedError any more."""
    data, _ = _corpus(200, 8, 1, seed=7)
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    idx.set_parameter("DistCalcMethod", "L2")
    assert idx.build(data) == tsp.ErrorCode.Success
    assert idx._graph.shape == (200, 32) and (idx._graph >= 0).any()
    for mode in ("beam", "auto", "dense"):
        assert idx.search(data[3], 3, search_mode=mode).ids[0] == 3
    idx.set_parameter("BinnedTopK", "on")
    assert idx.search(data[4], 3, search_mode="dense").ids[0] == 4
    assert idx.search(data[4], 3, search_mode="beam").ids[0] == 4
    idx.set_parameter("BinnedTopK", "off")
    assert idx.add(data[:2] + 0.5) == tsp.ErrorCode.Success
    assert idx.delete(data[:1]) == tsp.ErrorCode.Success
    assert idx.refine_index() == tsp.ErrorCode.Success
    assert idx.num_samples == 201
    assert tsp.create_instance("KDT", "Float", device="cpu").algo.name \
        == "KDT"
    # the walk options of the scheduler slice serve; the cascade raises
    want = idx.search(data[5], 3, search_mode="beam").ids[0]
    for name, value in (("ContinuousBatching", "1"),
                        ("BeamSegmentIters", "2"), ("BeamScoreDtype", "bf16"),
                        ("BeamPackedNeighbors", "1")):
        default = idx.get_parameter(name)
        idx.set_parameter(name, value)
        assert idx.search(data[5], 3, search_mode="beam").ids[0] == want
        idx.set_parameter(name, default)
    idx.close()
    # the cascade, once refused, serves both modes on every tier
    idx.set_parameter("CascadeSearch", "1")
    for tier in ("device", "host", "host_all"):
        idx.set_parameter("CorpusTier", tier)
        for mode in ("beam", "dense"):
            assert idx.search(data[5], 3, search_mode=mode).ids[0] == want
    idx.close()


# ---- the RNG graph and the beam walk ----------------------------------------

GRAPH_SETTINGS = [("TPTNumber", "4"), ("TPTLeafSize", "500"),
                  ("CEF", "64"), ("MaxCheckForRefineGraph", "128"),
                  ("NeighborhoodSize", "16"), ("BKTKmeansK", "8"),
                  ("MaxCheck", "512"), ("RefineQueryGroup", "32")]


def _graph_corpus(kind, n, nq, seed):
    """Integer-valued float32 (L2) or int8 rows (cosine): every distance is
    exact in both packages, so the walks must agree id for id."""
    if kind == "int8":
        return _corpus(n, 16, nq, seed, int8=True)
    data, q = _corpus(n, 16, nq, seed)
    if kind == "ints":
        data, q = np.round(data * 2), np.round(q * 2)
    return data, q


def _graph_index(pkg, kind, final="same", **kw):
    vt = "Int8" if kind == "int8" else "Float"
    idx = pkg.create_instance("BKT", vt, **kw)
    settings = GRAPH_SETTINGS + [
        ("DistCalcMethod", "Cosine" if kind == "int8" else "L2"),
        ("FinalRefineSearchMode", final)]
    for name, value in settings:
        assert idx.set_parameter(name, value)
    return idx


@pytest.mark.parametrize("kind", ["ints", "int8"])
def test_jax_graph_folder_beam_and_auto_equal_jax(tmp_path, kind):
    """A JAX-built BuildGraph=1 folder loads in the port: beam (exact and
    binned) and auto search return the JAX package's ids and distances,
    and the port re-saves the same bytes."""
    data, q = _graph_corpus(kind, 1500, 96, seed=11)
    ref = _graph_index(jsp, kind)
    ref.build(data)
    jdir = str(tmp_path / "jax")
    ref.save_index(jdir)
    got = tsp.load_index(jdir, device="cpu")
    for binned in ("off", "on"):
        ref.set_parameter("BinnedTopK", binned)
        got.set_parameter("BinnedTopK", binned)
        for mode in ("beam", "auto"):
            d_ref, i_ref = ref.search_batch(q, 10, search_mode=mode)
            d_got, i_got = got.search_batch(q, 10, search_mode=mode)
            np.testing.assert_array_equal(i_got, i_ref)
            np.testing.assert_array_equal(d_got, d_ref)
    d_ref, i_ref = ref.exact_search_batch(q, 10)
    d_got, i_got = got.exact_search_batch(q, 10)
    np.testing.assert_array_equal(i_got, i_ref)
    tdir = str(tmp_path / "port")
    got.set_parameter("BinnedTopK", "off")
    ref.set_parameter("BinnedTopK", "off")
    ref.save_index(jdir)
    got.save_index(tdir)
    for name in BLOBS:
        assert _read(tdir, name) == _read(jdir, name), name


@pytest.mark.parametrize("kind", ["ints", "gauss"])
def test_port_graph_folder_loads_in_jax(tmp_path, kind):
    """A port-built BuildGraph=1 folder (final refine pass through the
    walk) loads in the JAX package and beam-searches alike: id for id on
    integer data, at least 0.99 id overlap on Gaussian data."""
    data, q = _graph_corpus(kind, 1200, 96, seed=12)
    mine = _graph_index(tsp, kind, final="beam", device="cpu")
    mine.build(data)
    assert set(mine.build_stages) == {"tree", "tpt_candidates", "prune",
                                      "refine_pass_1", "refine_pass_2"}
    assert (mine._graph >= 0).sum(1).min() > 0
    folder = str(tmp_path / "idx")
    assert mine.save_index(folder) == tsp.ErrorCode.Success
    theirs = jsp.load_index(folder)
    d_ref, i_ref = theirs.search_batch(q, 10, search_mode="beam")
    d_got, i_got = mine.search_batch(q, 10, search_mode="beam")
    if kind == "ints":
        np.testing.assert_array_equal(i_got, i_ref)
        np.testing.assert_array_equal(d_got, d_ref)
    else:
        overlap = np.mean([len(set(a) & set(b)) / 10
                           for a, b in zip(i_got, i_ref)])
        assert overlap >= 0.99
    truth = np.argsort(((q[:, None, :] - data[None]) ** 2).sum(-1),
                       axis=1, kind="stable")[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_got, truth)])
    assert recall >= 0.9
