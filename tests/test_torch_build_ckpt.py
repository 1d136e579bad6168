"""Resumable builds of the PyTorch port (utils/build_ckpt.py) against the
JAX package's.

The cases of tests/test_build_ckpt.py, run on the port: a checkpointed
build equals a plain one, an interrupted build resumes without re-running
its completed stages (BKT and KDT), the fingerprint binds data and params,
a corrupt stage is ignored, and orphan GC runs only from `clear()`.
Beyond those, both packages give the same data and params the same
fingerprint, and a checkpoint that an interrupted JAX build left resumes
in the port to the JAX package's uninterrupted graph, bit for bit
(integer-valued rows, so every distance is exact in both packages).
"""

import os
import time

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.graph.rng import RelativeNeighborhoodGraph as JRNG
from sptag_tpu.utils import build_ckpt as jckpt
from sptag_tpu_torch.graph.rng import RelativeNeighborhoodGraph as TRNG
from sptag_tpu_torch.trees.bktree import BKTree as TBKTree
from sptag_tpu_torch.trees.kdtree import KDTree as TKDTree
from sptag_tpu_torch.utils.build_ckpt import (BuildCheckpoint,
                                              build_fingerprint)

BKT_PARAMS = (("BKTNumber", "1"), ("BKTKmeansK", "8"), ("TPTNumber", "2"),
              ("TPTLeafSize", "64"), ("NeighborhoodSize", "8"),
              ("CEF", "32"), ("MaxCheckForRefineGraph", "64"),
              ("RefineIterations", "2"), ("MaxCheck", "256"))
KDT_PARAMS = (("KDTNumber", "1"), ("TPTNumber", "2"), ("TPTLeafSize", "64"),
              ("NeighborhoodSize", "8"), ("CEF", "32"),
              ("MaxCheckForRefineGraph", "64"), ("RefineIterations", "2"),
              ("MaxCheck", "256"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_data(n=600, d=24, seed=3):
    """Integer-valued float32 rows: exact distances in both packages."""
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(11).standard_normal((12, d)) * 4.0
    return np.round((cent[rng.integers(0, 12, n)]
                     + rng.standard_normal((n, d))) * 2).astype(np.float32)


def _mk_index(pkg=tsp, algo="BKT"):
    kw = {"device": "cpu"} if pkg is tsp else {}
    index = pkg.create_instance(algo, "Float", **kw)
    index.set_parameter("DistCalcMethod", "L2")
    for k, v in (BKT_PARAMS if algo == "BKT" else
                 KDT_PARAMS if algo == "KDT" else ()):
        index.set_parameter(k, v)
    return index


def _graph(index):
    g = index._graph
    return g if isinstance(g, np.ndarray) else g.graph


def _dying(calls):
    def dying_refine(self, *a, **kw):
        calls["n"] += 1
        raise RuntimeError("build process died")
    return dying_refine


def test_checkpointed_build_matches_plain_build(tmp_path):
    data = _mk_data()
    plain = _mk_index()
    plain.build(data)
    ckpt = _mk_index()
    ckpt.build(data, checkpoint_dir=str(tmp_path / "ck"))
    assert np.array_equal(_graph(plain), _graph(ckpt))
    # success clears the fingerprint subfolder
    root = tmp_path / "ck"
    assert not any(p.is_dir() for p in root.iterdir())
    _, ip = plain.search_batch(data[:5], 3)
    _, ic = ckpt.search_batch(data[:5], 3)
    assert np.array_equal(ip, ic)


def test_interrupted_build_resumes_completed_stages(tmp_path, monkeypatch):
    data = _mk_data()
    ck_dir = str(tmp_path / "ck")
    calls = {"n": 0}
    real_refine = TRNG.refine_once
    monkeypatch.setattr(TRNG, "refine_once", _dying(calls))
    first = _mk_index()
    with pytest.raises(RuntimeError):
        first.build(data, checkpoint_dir=ck_dir)
    assert calls["n"] == 1
    monkeypatch.setattr(TRNG, "refine_once", real_refine)

    # the tree and the candidate merge survived the crash
    sub = [p for p in (tmp_path / "ck").iterdir() if p.is_dir()]
    assert len(sub) == 1
    names = {p.name for p in sub[0].iterdir()}
    assert {"tree.bin", "candidates.npz"} <= names

    def no_tree_build(self, *a, **kw):
        raise AssertionError("tree stage re-ran on resume")

    def no_tree_candidates(self, *a, **kw):
        raise AssertionError("TPT all-pairs re-ran on resume")

    monkeypatch.setattr(TBKTree, "build", no_tree_build)
    monkeypatch.setattr(TRNG, "_tree_candidates", no_tree_candidates)
    resumed = _mk_index()
    assert resumed.build(data, checkpoint_dir=ck_dir) == tsp.ErrorCode.Success
    assert resumed.build_resumed
    monkeypatch.undo()

    plain = _mk_index()
    plain.build(data)
    assert not plain.build_resumed
    assert np.array_equal(_graph(plain), _graph(resumed))
    _, ip = plain.search_batch(data[:8], 5)
    _, ir = resumed.search_batch(data[:8], 5)
    assert np.array_equal(ip, ir)


def test_interrupted_build_resumes_after_a_saved_refine_pass(tmp_path,
                                                             monkeypatch):
    """A death in the final pass resumes from the first pass's graph:
    neither the candidates nor the first pass run again."""
    data = _mk_data()
    ck_dir = str(tmp_path / "ck")
    real_refine = TRNG.refine_once
    calls = {"n": 0}

    def die_second(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("build process died")
        return real_refine(self, *a, **kw)

    monkeypatch.setattr(TRNG, "refine_once", die_second)
    with pytest.raises(RuntimeError):
        _mk_index().build(data, checkpoint_dir=ck_dir)
    sub = [p for p in (tmp_path / "ck").iterdir() if p.is_dir()]
    assert "graph_pass0.npz" in {p.name for p in sub[0].iterdir()}

    passes = {"n": 0}

    def count_refine(self, *a, **kw):
        passes["n"] += 1
        return real_refine(self, *a, **kw)

    def no_candidates(self, *a, **kw):
        raise AssertionError("candidate stage re-ran on resume")

    monkeypatch.setattr(TRNG, "refine_once", count_refine)
    monkeypatch.setattr(TRNG, "build_candidates", no_candidates)
    resumed = _mk_index()
    resumed.build(data, checkpoint_dir=ck_dir)
    assert resumed.build_resumed and passes["n"] == 1
    monkeypatch.undo()
    plain = _mk_index()
    plain.build(data)
    assert np.array_equal(_graph(plain), _graph(resumed))


def test_kdt_interrupted_build_resumes(tmp_path, monkeypatch):
    """KDT inherits the resumable _build: its checkpointed tree loads back
    as a KDTree (KDTIndex._load_tree), not a BKTree."""
    data = _mk_data()
    ck_dir = str(tmp_path / "ck")
    real_refine = TRNG.refine_once
    monkeypatch.setattr(TRNG, "refine_once", _dying({"n": 0}))
    with pytest.raises(RuntimeError):
        _mk_index(algo="KDT").build(data, checkpoint_dir=ck_dir)
    monkeypatch.setattr(TRNG, "refine_once", real_refine)

    def no_tree_build(self, *a, **kw):
        raise AssertionError("KDT tree stage re-ran on resume")

    monkeypatch.setattr(TKDTree, "build", no_tree_build)
    resumed = _mk_index(algo="KDT")
    assert resumed.build(data, checkpoint_dir=ck_dir) == tsp.ErrorCode.Success
    assert resumed.build_resumed
    assert isinstance(resumed._tree, TKDTree)
    _, ids = resumed.search_batch(data[:8], 5)
    assert (ids[:, 0] == np.arange(8)).all()


def test_fingerprint_binds_data_and_params(tmp_path):
    data = _mk_data()
    other = _mk_data(seed=4)
    assert build_fingerprint(data, "cfg") != build_fingerprint(other, "cfg")
    assert build_fingerprint(data, "cfg") != build_fingerprint(data, "cfg2")
    a = BuildCheckpoint(str(tmp_path), build_fingerprint(data, "cfg"))
    b = BuildCheckpoint(str(tmp_path), build_fingerprint(other, "cfg"))
    a.put_bytes("tree", b"A")
    assert b.get_bytes("tree") is None
    assert a.get_bytes("tree") == b"A"
    assert a.resumed and not b.resumed


def test_corrupt_stage_file_is_ignored(tmp_path):
    ck = BuildCheckpoint(str(tmp_path), "f" * 40)
    ck.put_arrays("candidates", cand_ids=np.zeros((4, 2), np.int32),
                  cand_d=np.zeros((4, 2), np.float32),
                  trees_done=np.int64(1))
    path = os.path.join(ck.folder, "candidates.npz")
    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert ck.get_arrays("candidates") is None


def test_gc_runs_only_on_clear_and_age_is_configurable(tmp_path,
                                                       monkeypatch):
    root = str(tmp_path)
    stale = os.path.join(root, "stalebuild")
    os.makedirs(stale)
    old = time.time() - 9 * 24 * 3600
    os.utime(stale, (old, old))
    ck = BuildCheckpoint(root, "a" * 40)
    assert os.path.isdir(stale)              # the constructor reaps nothing
    monkeypatch.setenv("SPTAG_TPU_BUILD_CKPT_GC_AGE_S", "0")
    ck.put_bytes("tree", b"x")
    ck.clear()
    assert os.path.isdir(stale)              # GC disabled
    fresh = os.path.join(root, "freshbuild")
    os.makedirs(fresh)
    monkeypatch.setenv("SPTAG_TPU_BUILD_CKPT_GC_AGE_S", "3600")
    BuildCheckpoint(root, "b" * 40).clear()
    assert not os.path.isdir(stale)
    assert os.path.isdir(fresh)


@pytest.mark.parametrize("what", ["fingerprint", "stages"])
def test_checkpoint_store_equals_jax(tmp_path, what):
    """The same stage writes give the same files in both packages, and
    each package reads the other's."""
    data = _mk_data()
    if what == "fingerprint":
        for cfg in ("", "BKTIndex:0:[('a', 1)]"):
            for d in (data, data[:7], data.astype(np.int8)):
                assert build_fingerprint(d, cfg) == \
                    jckpt.build_fingerprint(d, cfg)
        assert BuildCheckpoint(str(tmp_path), "c" * 40).folder == \
            jckpt.BuildCheckpoint(str(tmp_path), "c" * 40).folder
        return
    t = BuildCheckpoint(str(tmp_path / "t"), "d" * 40)
    j = jckpt.BuildCheckpoint(str(tmp_path / "j"), "d" * 40)
    arrays = {"cand_ids": np.arange(12, dtype=np.int32).reshape(4, 3),
              "cand_d": np.linspace(0, 1, 12, dtype=np.float32)
              .reshape(4, 3), "trees_done": np.int64(2)}
    for ck in (t, j):
        ck.put_bytes("tree", b"forest")
        ck.put_arrays("candidates", **arrays)
    for name in ("tree.bin", "candidates.npz"):
        with open(os.path.join(t.folder, name), "rb") as f1, \
                open(os.path.join(j.folder, name), "rb") as f2:
            assert f1.read() == f2.read(), name
    got = t.get_arrays("candidates")
    want = j.get_arrays("candidates")
    for k in arrays:
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("algo", ["BKT", "KDT", "FLAT"])
def test_same_data_and_params_give_the_jax_fingerprint(tmp_path, algo):
    """A kept checkpoint lands in the same fingerprint subfolder in both
    packages, so either resumes the other's stages."""
    data = _mk_data(n=300)
    names = []
    for pkg in (jsp, tsp):
        index = _mk_index(pkg, algo)
        index.set_parameter("MaxCheck", "128")
        assert index.build(data, checkpoint_dir=str(tmp_path / pkg.__name__),
                           keep_checkpoint=True) == pkg.ErrorCode.Success
        names.append(os.path.basename(index.last_checkpoint.folder))
        index.last_checkpoint.clear()
    assert names[0] == names[1]


@pytest.mark.parametrize("die_at", [1, 2])
def test_jax_checkpoint_resumes_in_the_port_to_the_jax_graph(
        tmp_path, monkeypatch, die_at):
    """A JAX build dies in refine pass `die_at`; the port resumes its
    stages (the JAX tree, candidates and, past pass 1, the first pass's
    graph) and ends with the JAX package's uninterrupted graph."""
    data = _mk_data()
    ck_dir = str(tmp_path / "ck")
    real_refine = JRNG.refine_once
    calls = {"n": 0}

    def die(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == die_at:
            raise RuntimeError("build process died")
        return real_refine(self, *a, **kw)

    monkeypatch.setattr(JRNG, "refine_once", die)
    with pytest.raises(RuntimeError):
        _mk_index(jsp).build(data, checkpoint_dir=ck_dir)
    monkeypatch.undo()
    want = _mk_index(jsp)
    want.build(data)

    def no_tree_build(self, *a, **kw):
        raise AssertionError("the port rebuilt the JAX tree stage")

    monkeypatch.setattr(TBKTree, "build", no_tree_build)
    resumed = _mk_index(tsp)
    assert resumed.build(data, checkpoint_dir=ck_dir) == tsp.ErrorCode.Success
    monkeypatch.undo()
    assert resumed.build_resumed
    assert np.array_equal(resumed._graph, want._graph.graph)
    assert not [p for p in (tmp_path / "ck").iterdir() if p.is_dir()]
