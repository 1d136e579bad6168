"""The core library API of the PyTorch port against the JAX package's:
the reader, the native host library, blobs, FileMetadataSet, the
estimators, per-query futures, the package exports, and the reference
methods and the resumable build checkpoints of the port's classes.

Everything here is host code or small CPU indexes on integer-valued
rows, so each result must equal the JAX package's exactly: bytes, ids,
distances and counts.
"""

import io
import os

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu import native as jnative
from sptag_tpu.core import index as jindex
from sptag_tpu.core import vectorset as jvs
from sptag_tpu.io import reader as jreader
from sptag_tpu.utils.threadpool import ThreadPool as JPool
from sptag_tpu_torch import native as tnative
from sptag_tpu_torch.core import index as tindex
from sptag_tpu_torch.core import vectorset as tvs
from sptag_tpu_torch.io import reader as treader
from sptag_tpu_torch.utils.threadpool import ThreadPool as TPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, d=8, seed=0):
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(42).standard_normal((12, d)) * 4.0
    return np.round((cent[rng.integers(0, 12, n)]
                     + rng.standard_normal((n, d))) * 2).astype(np.float32)


def test_exports_match_jax():
    want = set(jsp.__all__)
    assert want <= set(tsp.__all__)
    # the JAX package exposes the wrappers as attributes; the port lists
    # them in __all__ too
    for name in ("AnnIndex", "AnnClient"):
        assert getattr(jsp, name).__name__ == getattr(tsp, name).__name__
    for name in tsp.__all__:
        assert getattr(tsp, name) is not None


# ---- the reference methods and the build checkpoints ------------------------

def test_search_result_len_matches_jax():
    ids = np.arange(7, dtype=np.int32)
    d = np.zeros(7, np.float32)
    assert len(tsp.SearchResult(ids, d)) == len(jsp.core.index.SearchResult(
        ids, d)) == 7


def test_vectorset_methods_match_jax(tmp_path):
    data = _rows(9, 5, seed=1)
    a, b = tsp.VectorSet(data), jsp.VectorSet(data)
    np.testing.assert_array_equal(a.get_vector(4), b.get_vector(4))
    ta, jb = io.BytesIO(), io.BytesIO()
    a.save(ta)
    b.save(jb)
    assert ta.getvalue() == jb.getvalue()
    path = str(tmp_path / "v.bin")
    a.save(path)
    got = tsp.VectorSet.load(path, tsp.VectorValueType.Float)
    want = jsp.VectorSet.load(path, jsp.VectorValueType.Float)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.value_type == tsp.VectorValueType.Float


def test_threadpool_current_jobs_and_join_match_jax():
    import threading

    out = []
    for cls in (JPool, TPool):
        pool = cls(name="t")
        gate = threading.Event()
        done = []
        pool.init(1)
        pool.add(gate.wait)
        for i in range(5):
            pool.add(lambda i=i: done.append(i))
        # the worker blocks on the gate: the five jobs wait in the queue
        deadline = 50
        while pool.current_jobs() != 5 and deadline:
            gate.wait(0.01)
            deadline -= 1
        queued = pool.current_jobs()
        gate.set()
        pool.join()
        out.append((queued, pool.current_jobs(), done))
        pool.stop()
    assert out[1] == out[0] == (5, 0, [0, 1, 2, 3, 4])


def _ckpt_index(pkg, **kw):
    idx = pkg.create_instance("BKT", "Float", **kw)
    for name, value in (("DistCalcMethod", "L2"), ("BKTKmeansK", "4"),
                        ("TPTNumber", "2"), ("TPTLeafSize", "32"),
                        ("NeighborhoodSize", "8"), ("CEF", "16"),
                        ("MaxCheckForRefineGraph", "32"),
                        ("FinalRefineSearchMode", "same")):
        assert idx.set_parameter(name, value)
    return idx


@pytest.mark.parametrize("how", ["checkpoint_dir", "keep_checkpoint",
                                 "environment"])
def test_build_checkpoints_build_like_jax(tmp_path, monkeypatch, how):
    """Each way of asking for a resumable build builds in both packages,
    with the same graph as a plain build; on success the checkpoint
    subfolder is gone, unless `keep_checkpoint` keeps it for the caller,
    under the same fingerprint name in both packages."""
    data = _rows(200)
    out = {}
    for name, pkg, kw in (("jax", jsp, {}), ("port", tsp,
                                              {"device": "cpu"})):
        root = tmp_path / name
        args = {}
        if how == "checkpoint_dir":
            args["checkpoint_dir"] = str(root)
        elif how == "keep_checkpoint":
            args.update(checkpoint_dir=str(root), keep_checkpoint=True)
        else:
            monkeypatch.setenv("SPTAG_TPU_BUILD_CKPT", str(root))
        idx = _ckpt_index(pkg, **kw)
        assert idx.build(data, **args) == pkg.ErrorCode.Success
        monkeypatch.delenv("SPTAG_TPU_BUILD_CKPT", raising=False)
        plain = _ckpt_index(pkg, **kw)
        plain.build(data)
        graph = idx._graph.graph if pkg is jsp else idx._graph
        want = plain._graph.graph if pkg is jsp else plain._graph
        assert np.array_equal(graph, want)
        left = sorted(p.name for p in root.iterdir()) if root.exists() \
            else []
        files = sorted(p.name for p in (root / left[0]).iterdir()) \
            if left else []
        ck = idx.last_checkpoint
        out[name] = (idx.build_resumed, left, files,
                     None if ck is None else os.path.basename(ck.folder))
    assert out["port"] == out["jax"]
    resumed, left, files, kept = out["port"]
    assert not resumed
    if how == "keep_checkpoint":
        assert left == [kept] and {"tree.bin", "candidates.npz"} <= \
            set(files)
    else:
        assert left == [] and kept is None


# ---- the reader and the native library ---------------------------------------

def _write_tsv(path, data, metas, delim="|"):
    with open(path, "wb") as f:
        for meta, row in zip(metas, data):
            f.write(meta + b"\t"
                    + delim.join(repr(float(x)) for x in row).encode()
                    + b"\n")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("vt", ["Float", "Int8"])
def test_reader_tsv_matches_jax(tmp_path, monkeypatch, native, vt):
    data = _rows(300, 6, seed=3)
    metas = [f"m{i}".encode() for i in range(300)]
    path = str(tmp_path / "x.tsv")
    _write_tsv(path, data, metas)
    if not native:
        monkeypatch.setattr(jnative, "load", lambda: None)
        monkeypatch.setattr(tnative, "load", lambda: None)
    out = []
    for mod, pkg in ((jreader, jsp), (treader, tsp)):
        opts = mod.ReaderOptions(value_type=getattr(pkg.VectorValueType, vt),
                                 dimension=6, thread_num=4)
        reader = mod.VectorSetReader(opts)
        assert reader.load_file(path)
        vs, ms = reader.get_vector_set(), reader.get_metadata_set()
        folder = str(tmp_path / pkg.__name__)
        reader.save(folder)
        files = {n: open(os.path.join(folder, n), "rb").read()
                 for n in sorted(os.listdir(folder))}
        out.append((vs.data, [ms.get_metadata(i) for i in range(ms.count)],
                    files))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][0].dtype == out[0][0].dtype
    assert out[1][1] == out[0][1] == metas
    assert out[1][2] == out[0][2]


def test_reader_bin_prefix_matches_jax(tmp_path):
    data = _rows(40, 4, seed=5)
    path = str(tmp_path / "v.bin")
    tsp.VectorSet(data).save(path)
    got, gm = treader.load_vectors(
        "BIN:" + path, treader.ReaderOptions(dimension=4))
    want, wm = jreader.load_vectors(
        "BIN:" + path, jreader.ReaderOptions(dimension=4))
    np.testing.assert_array_equal(got.data, want.data)
    assert gm is None and wm is None
    bad = str(tmp_path / "bad.tsv")
    with open(bad, "wb") as f:
        f.write(b"m0\tx|y\n")
    for mod in (jreader, treader):
        with pytest.raises(ValueError, match="failed to parse"):
            mod.load_vectors(bad, mod.ReaderOptions(dimension=2))


def test_native_library_builds_into_the_port_build_dir():
    lib = tnative.load()
    if lib is None:
        pytest.skip("no g++: the reader takes its Python parser")
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "sptag_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
    blob = b"a\t1|2\nb\t3|4\n\nc\t5|6"
    assert lib.sptag_count_lines(blob, len(blob)) == 3
    got = tnative.parse_tsv(blob, "|", 2, 2)
    np.testing.assert_array_equal(got[0], [[1, 2], [3, 4], [5, 6]])
    assert got[1] == [b"a", b"b", b"c"]
    assert tnative.parse_tsv(b"a\t1|2|3\nb\t4|5\n", "|", 3, 2) is None


# ---- metadata ----------------------------------------------------------------

def test_metadata_from_texts_matches_jax():
    texts = ["a", b"bb", "ünï", ""]
    a, b = tvs.metadata_from_texts(texts), jvs.metadata_from_texts(texts)
    assert [a.get_metadata(i) for i in range(4)] == \
        [b.get_metadata(i) for i in range(4)]


def test_file_metadata_set_matches_jax(tmp_path):
    metas = [f"row-{i}".encode() * (i % 3) for i in range(25)]
    out = []
    for mod in (jvs, tvs):
        d = tmp_path / mod.__name__
        d.mkdir()
        mp, ip = str(d / "metadata.bin"), str(d / "metadataIndex.bin")
        mod.MetadataSet(metas).save(mp, ip)
        f = mod.FileMetadataSet(mp, ip)
        got = [f.get_metadata(i) for i in range(-1, 27)]
        f.add(b"late")
        refined = f.refine([3, 1, 25])
        f.save(mp, ip)                       # over its own backing file
        saved = (open(mp, "rb").read(), open(ip, "rb").read())
        out.append((got, f.count, f.get_metadata(25),
                    [refined.get_metadata(i) for i in range(3)], saved))
        f.close()
    assert out[1] == out[0]
    assert out[0][1] == 26 and out[0][2] == b"late"


def test_lazy_metadata_load_matches_jax(tmp_path):
    data = _rows(200, seed=6)
    metas = [f"id{i}".encode() for i in range(200)]
    idx = tsp.create_instance("FLAT", "Float", device="cpu")
    idx.set_parameter("DistCalcMethod", "L2")
    idx.build(data, tsp.MetadataSet(metas), with_meta_index=True)
    folder = str(tmp_path / "flat")
    assert idx.save_index(folder) == tsp.ErrorCode.Success
    got = tsp.load_index(folder, device="cpu", lazy_metadata=True)
    want = jsp.load_index(folder, lazy_metadata=True)
    assert isinstance(got.metadata, tsp.FileMetadataSet)
    assert type(want.metadata).__name__ == "FileMetadataSet"
    r_got = got.search(data[17], 3, with_metadata=True)
    r_want = want.search(data[17], 3, with_metadata=True)
    assert r_got.metas == r_want.metas and r_got.metas[0] == b"id17"
    assert got.delete_by_metadata(b"id5") == tsp.ErrorCode.Success
    got.metadata.close()
    want.metadata.close()


# ---- blobs ---------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["FLAT", "BKT", "KDT"])
def test_blobs_byte_identical_to_jax_and_round_trip(algo):
    data = _rows(400, seed=7)
    queries = _rows(20, seed=8)
    idx = tsp.create_instance(algo, "Float", device="cpu")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "2"),
                        ("TPTLeafSize", "200"), ("CEF", "32"),
                        ("MaxCheckForRefineGraph", "64"),
                        ("NeighborhoodSize", "8"), ("MaxCheck", "128"),
                        ("RefineIterations", "1")]:
        idx.set_parameter(name, value)
    metas = tsp.MetadataSet(f"m{i}".encode() for i in range(400))
    assert idx.build(data, metas, with_meta_index=True) == \
        tsp.ErrorCode.Success
    idx.delete(data[:3])      # what the configured search finds of them
    n_del = idx.num_deleted
    assert n_del >= 1
    d0, i0 = idx.search_batch(queries, 5)
    config, blobs = idx.save_index_blobs()
    assert len(blobs) == (2 if algo == "FLAT" else 4) + 2
    back = tsp.load_index_blobs(config, blobs, device="cpu")
    d1, i1 = back.search_batch(queries, 5)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    assert back.num_deleted == n_del
    res = back.search(data[9], 1, with_metadata=True)
    assert res.metas == [f"m{res.ids[0]}".encode()]
    # the JAX package reads the port's blobs and writes the same bytes
    j = jindex.load_index_blobs(config, blobs)
    jd, ji = j.search_batch(queries, 5)
    np.testing.assert_array_equal(ji, i0)
    jconfig, jblobs = j.save_index_blobs()
    assert jconfig == config and jblobs == blobs
    assert j.num_deleted == n_del
    with pytest.raises(ValueError, match="missing index blob"):
        tsp.create_instance(algo, "Float", device="cpu") \
            .load_index_blobs_data(config, [])
    for x in (idx, back, j):
        getattr(x, "close", lambda: None)()


# ---- capacity estimators -------------------------------------------------------

ESTIMATES = [(1000, 128, "BKT", "Float", 1, 32),
             (200_000, 100, "KDT", "Int8", 2, 16),
             (5, 3, "FLAT", "Float", 1, 32),
             (10_000, 64, tsp.IndexAlgoType.BKT, tsp.VectorValueType.Int16,
              3, 32)]


@pytest.mark.parametrize("n,d,algo,vt,trees,m", ESTIMATES)
def test_estimators_match_jax(n, d, algo, vt, trees, m):
    ja = jsp.IndexAlgoType(int(algo)) if not isinstance(algo, str) else algo
    jv = jsp.VectorValueType(int(vt)) if not isinstance(vt, str) else vt
    mem = tsp.estimated_memory_usage(n, d, algo, vt, trees, m)
    assert mem == jsp.estimated_memory_usage(n, d, ja, jv, trees, m)
    assert tsp.estimated_vector_count(1 << 30, d, algo, vt, trees, m) == \
        jsp.estimated_vector_count(1 << 30, d, ja, jv, trees, m)
    for dense, replicas in ((True, 1), (True, 2), (False, 1)):
        assert tsp.estimated_hbm_usage(
            n, d, vt, m, dense_mode=dense, dense_replicas=replicas) == \
            jsp.estimated_hbm_usage(n, d, jv, m, dense_mode=dense,
                                    dense_replicas=replicas)


# ---- per-query futures -----------------------------------------------------------

def test_resolved_futures_and_base_submit_batch_match_jax():
    data = _rows(300, seed=9)
    q = _rows(12, seed=10)
    out = []
    for pkg, kw in ((jsp, {}), (tsp, {"device": "cpu"})):
        idx = pkg.create_instance("FLAT", "Float", **kw)
        idx.set_parameter("DistCalcMethod", "L2")
        idx.build(data)
        futs = idx.submit_batch(q, 4)
        rows = [f.result(timeout=10) for f in futs]
        bad = idx.submit_batch(q[:, :3], 4)        # wrong dimension
        errs = [type(f.exception(timeout=10)).__name__ for f in bad]
        out.append((np.stack([r[0] for r in rows]),
                    np.stack([r[1] for r in rows]), errs,
                    idx.search_batch(q, 4)))
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[1][3][1])
    assert out[1][2] == out[0][2] == ["ValueError"] * 12
    futs = tindex.resolved_futures(lambda: (np.zeros((2, 1)),
                                            np.ones((2, 1))), 2)
    assert [f.result()[1][0] for f in futs] == [1, 1]
