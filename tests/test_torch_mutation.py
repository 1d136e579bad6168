"""Online mutation in the PyTorch port against the JAX package: the
write-ahead log, the delta shard, add / delete / refine / merge on FLAT and
BKT, the background swap and the WAL replay.

Corpora are integer-valued float32 rows (L2): every distance is exact in
both packages, so graphs after an add must be bit-equal and ids equal.  A
BKT folder built by the JAX package is loaded into both packages, so both
start from the same forest, graph and corpus.
"""

import os
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.core import delta as jdelta
from sptag_tpu.graph import rng as jrng
from sptag_tpu.io import wal as jwal
from sptag_tpu_torch.core import delta as tdelta
from sptag_tpu_torch.graph import rng as trng
from sptag_tpu_torch.io import wal as twal


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is several times faster here
    than a pool contended by the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D = 16
N_BASE = 1200
SETTINGS = [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
            ("TPTLeafSize", "500"), ("CEF", "64"),
            ("MaxCheckForRefineGraph", "128"), ("NeighborhoodSize", "16"),
            ("BKTKmeansK", "8"), ("MaxCheck", "512"),
            ("RefineQueryGroup", "32"), ("FinalRefineSearchMode", "same"),
            ("AddCEF", "32"), ("AddCountForRebuild", "100000"),
            ("DenseClusterSize", "128"), ("RefineIterations", "1")]


def _rows(n, seed):
    """Integer-valued clustered rows (exact distances in both packages)."""
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(99).standard_normal((24, D)) \
        .astype(np.float32) * 4.0
    x = cent[rng.integers(0, 24, n)] + rng.standard_normal((n, D)) \
        .astype(np.float32)
    return np.round(x * 2)


DATA = _rows(1700, seed=1)
QUERIES = _rows(64, seed=2)


def _metas(lo, hi):
    return [f"m{i}".encode() for i in range(lo, hi)]


@pytest.fixture(scope="module")
def jax_folder(tmp_path_factory):
    """A BKT folder (graph, metadata index) built by the JAX package over
    the first N_BASE rows."""
    idx = jsp.create_instance("BKT", "Float")
    for name, value in SETTINGS:
        assert idx.set_parameter(name, value)
    idx.build(DATA[:N_BASE], jsp.MetadataSet(_metas(0, N_BASE)),
              with_meta_index=True)
    folder = str(tmp_path_factory.mktemp("jax_bkt") / "idx")
    assert idx.save_index(folder) == jsp.ErrorCode.Success
    return folder


def _both(folder, **params):
    """The folder loaded in both packages, `params` set in each."""
    a, b = jsp.load_index(folder), tsp.load_index(folder, device="cpu")
    for name, value in params.items():
        assert a.set_parameter(name, str(value))
        assert b.set_parameter(name, str(value))
    return a, b


def _close(*indexes):
    for idx in indexes:
        if hasattr(idx, "close"):
            idx.close()


def _graph(idx):
    g = idx._graph
    return np.asarray(g.graph if hasattr(g, "graph") else g)


def _same_search(a, b, queries=QUERIES, k=10, modes=("beam", "dense")):
    for mode in modes:
        da, ia = a.search_batch(queries, k, search_mode=mode)
        db, ib = b.search_batch(queries, k, search_mode=mode)
        np.testing.assert_array_equal(ib, ia, err_msg=mode)
        np.testing.assert_array_equal(db, da, err_msg=mode)
    da, ia = a.exact_search_batch(queries, k)
    db, ib = b.exact_search_batch(queries, k)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_array_equal(db, da)


# ---- the write-ahead log ---------------------------------------------------

def _write_log(mod, path):
    w = mod.WalWriter(path, sync=False)
    w.append(mod.pack_add(10, DATA[:3], [b"a", b"", b"ccc"]))
    w.append(mod.pack_add(13, DATA[3:5].astype(np.int8), None))
    w.append(mod.pack_delete([4, 11, 2 ** 40]))
    w.close()
    with open(path, "rb") as f:
        return f.read()


def _records(recs):
    out = []
    for r in recs:
        if hasattr(r, "vids"):
            out.append(("del", list(r.vids)))
        else:
            out.append(("add", r.begin, r.rows.dtype.str, r.rows.tobytes(),
                        r.metas))
    return out


@pytest.mark.parametrize("tail", ["clean", "torn", "crc"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_bytes_identical_and_cross_replay(tmp_path, writer, tail):
    """Both packages write the same bytes; a log written by either replays
    in the other, a torn tail or a CRC-corrupted last record truncated at
    the same offset."""
    raw_j = _write_log(jwal, str(tmp_path / "j.bin"))
    raw_t = _write_log(twal, str(tmp_path / "t.bin"))
    assert raw_t == raw_j
    good = len(raw_j)
    raw = raw_j if writer == "jax" else raw_t
    extra = twal.pack_add(20, DATA[:2], None)
    rec = struct.pack("<II", len(extra), 0) + extra
    if tail == "torn":
        import zlib
        rec = struct.pack("<II", len(extra), zlib.crc32(extra)) + extra
        raw = raw + rec[:len(rec) // 2]
    elif tail == "crc":
        raw = raw + rec                      # checksum 0: corrupt
    out = {}
    for name, mod in (("jax", jwal), ("port", twal)):
        path = str(tmp_path / f"replay_{name}.bin")
        with open(path, "wb") as f:
            f.write(raw)
        recs, torn = mod.replay(path)
        out[name] = (_records(recs), torn, os.path.getsize(path))
    assert out["port"] == out["jax"]
    assert out["port"][1] == (tail != "clean")
    assert out["port"][2] == good and len(out["port"][0]) == 3


def test_wal_refuses_fault_injection(tmp_path, monkeypatch):
    """``SPTAG_FAULTINJECT`` arms the WAL's storage faults in both
    packages: a torn append leaves the same durable prefix and raises
    InjectedCrash, and the replay of the torn log agrees (the record
    never acked is truncated away)."""
    from sptag_tpu.utils import faultinject as jfi
    from sptag_tpu_torch.utils import faultinject as tfi

    monkeypatch.setenv("SPTAG_FAULTINJECT", "torn_write@wal.append:after=1")
    out = {}
    for name, mod, fi in (("jax", jwal, jfi), ("port", twal, tfi)):
        fi.reset()
        path = str(tmp_path / f"w_{name}.bin")
        w = mod.WalWriter(path)
        w.append(mod.pack_add(0, np.ones((2, 4), np.float32), None))
        with pytest.raises(fi.InjectedCrash):
            w.append(mod.pack_delete([1, 3]))
        w.close()
        fi.reset()
        with open(path, "rb") as f:
            raw = f.read()
        recs, torn = mod.replay(path)
        fi.reset()          # no injector outlives the test's environment
        out[name] = (raw, len(recs), torn)
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (1, True)


# ---- the delta shard -------------------------------------------------------

def test_merge_topk_equal():
    rng = np.random.default_rng(3)
    for k in (1, 5, 12):
        d1 = np.sort(rng.integers(0, 9, (7, 6)).astype(np.float32), 1)
        i1 = rng.integers(-1, 20, (7, 6)).astype(np.int32)
        d2 = np.sort(rng.integers(0, 9, (7, 4)).astype(np.float32), 1)
        i2 = rng.integers(-1, 20, (7, 4)).astype(np.int32)
        d1[:, -1] = np.float32(3.4e38)
        i1[:, -1] = -1
        dj, ij = jdelta.merge_topk(d1, i1, d2, i2, k)
        dt, it = tdelta.merge_topk(d1, i1, d2, i2, k)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)
        assert it.dtype == np.int32 and dt.dtype == np.float32


@pytest.mark.parametrize("metric", [0, 1])
def test_delta_shard_search_equal(metric):
    rows = DATA[:40]
    if metric == 1:
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    rows = rows.astype(np.float32)
    deleted = np.zeros(500 + 40, bool)
    deleted[[503, 517, 530]] = True
    a = jdelta.DeltaShard(500, D, np.float32, 64, metric, 1)
    b = tdelta.DeltaShard(500, D, np.float32, 64, metric, 1, device="cpu")
    for lo, hi in ((0, 25), (25, 40)):
        a.append(rows[lo:hi], 500 + lo)
        b.append(rows[lo:hi], 500 + lo)
        for k in (1, 7, 50):
            dj, ij = a.search(rows[:10], k, deleted)
            dt, it = b.search(rows[:10], k, deleted)
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-6)
    assert (it[:, 0] >= 500).all() and not np.isin([503, 517], it).any()
    c = b.rebased(520, rows[20:40])
    assert c.base_id == 520 and c.count == 20
    assert b.rebased(540, None) is None


# ---- adds, deletes, merge into one JAX-built folder -------------------------

def test_linked_adds_give_bit_equal_graph_and_ids(jax_folder):
    a, b = _both(jax_folder)
    for lo, hi in ((N_BASE, N_BASE + 60), (N_BASE + 60, N_BASE + 130)):
        metas = jsp.MetadataSet(_metas(lo, hi))
        assert a.add(DATA[lo:hi], metas) == jsp.ErrorCode.Success
        assert b.add(DATA[lo:hi], tsp.MetadataSet(_metas(lo, hi))) \
            == tsp.ErrorCode.Success
        np.testing.assert_array_equal(_graph(b), _graph(a))
    assert b.num_samples == a.num_samples == N_BASE + 130
    _same_search(a, b)
    res = b.search(DATA[N_BASE + 5], 1, with_metadata=True)
    assert res.ids[0] == N_BASE + 5 and res.metas == [b"m1205"]
    _close(a, b)


def test_dense_only_adds_match(tmp_path):
    """BuildGraph=0: an add appends rows with empty graph rows and the
    next search rebuilds the whole dense layout, filing each new row with
    its nearest tree center.  Rows far from the corpus can fall outside
    the probed blocks; which ones is the JAX package's answer too."""
    ref = jsp.create_instance("BKT", "Float")
    for name, value in SETTINGS + [("BuildGraph", "0")]:
        assert ref.set_parameter(name, value)
    ref.build(DATA[:N_BASE])
    folder = str(tmp_path / "dense")
    assert ref.save_index(folder) == jsp.ErrorCode.Success
    a, b = _both(folder)
    far = np.round(np.random.default_rng(5).standard_normal((40, D)) * 12)
    for rows in (DATA[N_BASE:N_BASE + 60], far, DATA[N_BASE + 60:N_BASE + 61]):
        n0 = a.num_samples
        assert int(a.add(rows)) == int(b.add(rows)) == 0
        assert b.num_samples == a.num_samples == n0 + len(rows)
        np.testing.assert_array_equal(_graph(b), _graph(a))
        assert (_graph(b)[n0:] == -1).all()
        _same_search(a, b, modes=("dense",))
        _same_search(a, b, queries=rows, k=1, modes=("dense",))
    _close(a, b)


def test_delete_and_delete_by_metadata_match(jax_folder):
    a, b = _both(jax_folder)
    noisy = DATA[20:23] + 0.5
    for call in (lambda i, m: i.delete(DATA[3:9]),
                 lambda i, m: i.delete(DATA[3:4]),          # again
                 lambda i, m: i.delete(noisy),              # not stored
                 lambda i, m: i.delete(np.zeros((1, D + 1), np.float32)),
                 lambda i, m: i.delete_by_metadata(b"m40"),
                 lambda i, m: i.delete_by_metadata(b"m40"),
                 lambda i, m: i.delete_by_metadata(b"nope")):
        assert int(call(b, tsp)) == int(call(a, jsp))
        np.testing.assert_array_equal(b._deleted[:b._n], a._deleted[:a._n])
    # a search by content may miss a row at this budget: both packages
    # miss the same ones
    assert b.num_deleted == a.num_deleted >= 5
    _same_search(a, b)
    _, ids = b.search_batch(DATA[3:9], 3, search_mode="beam")
    assert not b._deleted[ids[ids >= 0]].any()
    _close(a, b)


def test_delta_shard_visibility_masking_overflow_and_bulk(jax_folder):
    a, b = _both(jax_folder, DeltaShardCapacity=48)
    lo = N_BASE
    for idx in (a, b):
        idx.add(DATA[lo:lo + 30])
        assert idx.mutation_state()["delta_rows"] == 30
    # visible at once, from the delta tier
    for mode in ("beam", "dense"):
        _, ids = b.search_batch(DATA[lo:lo + 30], 1, search_mode=mode)
        assert (ids[:, 0] == np.arange(lo, lo + 30)).all()
    # masking works in both tiers: a main row (one the delete's search
    # finds) and a delta row
    _, ids = b.search_batch(DATA[:50], 1)
    r = int(np.flatnonzero(ids[:, 0] == np.arange(50))[0])
    for idx in (a, b):
        assert int(idx.delete(DATA[r:r + 1])) == 0
        assert int(idx.delete(DATA[lo + 4:lo + 5])) == 0
    _, ids = b.search_batch(np.concatenate([DATA[r:r + 1],
                                            DATA[lo + 4:lo + 5]]),
                            5, search_mode="beam")
    assert r not in ids[0] and lo + 4 not in ids[1]
    _same_search(a, b)
    # overflow: 30 + 30 > 48 absorbs (links) the delta, then a new shard
    for idx in (a, b):
        idx.add(DATA[lo + 30:lo + 60])
        assert idx.mutation_state()["delta_rows"] == 30
    np.testing.assert_array_equal(_graph(b), _graph(a))
    assert _graph(b).shape[0] == lo + 30
    # a bulk add larger than the shard takes the linked path
    for idx in (a, b):
        idx.add(DATA[lo + 60:lo + 120])
        assert idx.mutation_state()["delta_rows"] == 0
    np.testing.assert_array_equal(_graph(b), _graph(a))
    assert _graph(b).shape[0] == lo + 120
    _same_search(a, b)
    _close(a, b)


def test_merge_index_equal_ids(jax_folder):
    a, b = _both(jax_folder)
    src_j = jsp.create_instance("FLAT", "Float")
    src_t = tsp.create_instance("FLAT", "Float", device="cpu")
    for src, pkg in ((src_j, jsp), (src_t, tsp)):
        src.set_parameter("DistCalcMethod", "L2")
        src.build(DATA[N_BASE:N_BASE + 80],
                  pkg.MetadataSet(_metas(5000, 5080)), with_meta_index=True)
        src.delete(DATA[N_BASE + 3:N_BASE + 4])
    assert int(b.merge_index(src_t)) == int(a.merge_index(src_j)) == 0
    assert b.num_samples == a.num_samples == N_BASE + 79
    np.testing.assert_array_equal(_graph(b), _graph(a))
    _same_search(a, b)
    assert b.metadata.get_metadata(N_BASE + 3) == b"m5004"
    _close(a, b)


# ---- the background swap and the tree rebuild -------------------------------

@pytest.mark.parametrize("oracle", ["exact", "beam"])
def test_a_swap_between_the_tiers_loses_no_acked_row(jax_folder,
                                                      monkeypatch, oracle):
    """The delta shard is pinned before the main tier is searched: a swap
    that absorbs it in between (refine_index run inside the main tier's
    search) leaves every added row its own nearest neighbour."""
    b = tsp.load_index(jax_folder, device="cpu")
    lo = N_BASE
    try:
        assert b.set_parameter("DeltaShardCapacity", "64")
        b.add(DATA[lo:lo + 20])
        assert b.mutation_state()["delta_rows"] == 20
        name = "_exact_scan" if oracle == "exact" else "_search_batch"
        main = getattr(b, name)
        swaps = []

        def main_then_swap(*args, **kw):
            out = main(*args, **kw)
            if b._delta is not None:
                b.refine_index()                 # absorbs the delta
                swaps.append(b.mutation_state()["delta_rows"])
            return out
        monkeypatch.setattr(b, name, main_then_swap)
        if oracle == "exact":
            _, ids = b.exact_search_batch(DATA[lo:lo + 20], 1)
        else:
            _, ids = b.search_batch(DATA[lo:lo + 20], 1, search_mode="beam")
        assert swaps == [0]
        np.testing.assert_array_equal(ids[:, 0], np.arange(lo, lo + 20))
    finally:
        _close(b)


def test_background_swap_and_rebuild_while_searching(jax_folder):
    """AutoRefineThreshold links the delta in the background and swaps a
    new engine in; AddCountForRebuild rebuilds the forest on the same
    worker.  Searches running meanwhile never fail and always find every
    acked row; the swapped graph equals the JAX package's."""
    a, b = _both(jax_folder, DeltaShardCapacity=64, AutoRefineThreshold=16)
    lo = N_BASE
    errors, stop = [], threading.Event()
    probe = DATA[lo - 10:lo + 60]
    rows = np.arange(lo - 10, lo + 60)

    def reader():
        try:
            while not stop.is_set():
                n = b.num_samples        # every row below n is acked
                _, ids = b.exact_search_batch(probe, 1)
                if (ids[rows < n, 0] != rows[rows < n]).any():
                    errors.append(ids[:, 0].tolist())
                _, ids = b.search_batch(probe, 3, search_mode="beam")
                if ids.shape != (len(rows), 3):
                    errors.append(ids.shape)
        except Exception as e:                           # noqa: BLE001
            errors.append(repr(e))

    def wait_swaps(idx, count):
        deadline = time.time() + 60
        while time.time() < deadline:
            st = idx.mutation_state()
            if st["swap_count"] >= count and not st["refine_in_flight"]:
                break
            time.sleep(0.02)
        assert st["swap_count"] >= count and st["delta_rows"] == 0, st
    t = threading.Thread(target=reader)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    t.start()
    try:
        for idx in (a, b):
            idx.add(DATA[lo:lo + 20])          # crosses the threshold
        for idx in (a, b):
            wait_swaps(idx, 1)
        np.testing.assert_array_equal(_graph(b), _graph(a))
        _same_search(a, b, modes=("beam",))
        # the forest rebuild, queued by the next swap on the same worker
        b.set_parameter("AddCountForRebuild", "10")
        b.add(DATA[lo + 20:lo + 60])
        wait_swaps(b, 2)
        b.wait_for_rebuild(timeout=60)
        assert b._rebuild_done.is_set()
        _, ids = b.search_batch(DATA[lo:lo + 60], 1, search_mode="beam")
        assert (ids[:, 0] == np.arange(lo, lo + 60)).all()
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        t.join(30)
        _close(a, b)
    assert not t.is_alive()
    assert not errors, errors[:3]
    assert b.mutation_state()["swap_windows_ms"]


# ---- refine_index (compaction) ----------------------------------------------

def test_bkt_compaction_remap_equals_jax(jax_folder, monkeypatch):
    """With the refine pass held out (each package's own tree rebuild
    draws differently), the compaction's id remap, graph remap, orphan
    repair, corpus and metadata are the JAX package's."""
    a, b = _both(jax_folder)
    for idx in (a, b):
        idx.delete(DATA[0:200:3])
        idx.delete_by_metadata(b"m500")
        idx.add(DATA[N_BASE:N_BASE + 40])
    live = N_BASE + 40 - a.num_deleted
    monkeypatch.setattr(jrng.RelativeNeighborhoodGraph, "refine_once",
                        lambda self, *a, **k: None)
    monkeypatch.setattr(trng.RelativeNeighborhoodGraph, "refine_once",
                        lambda self, *a, **k: None)
    assert int(b.refine_index()) == int(a.refine_index()) == 0
    assert b.num_samples == a.num_samples == live
    assert b.num_deleted == a.num_deleted == 0
    np.testing.assert_array_equal(b._host[:b._n], a._host[:a._n])
    np.testing.assert_array_equal(_graph(b), _graph(a))
    assert [b.metadata.get_metadata(i) for i in range(b.num_samples)] == \
        [a.metadata.get_metadata(i) for i in range(a.num_samples)]
    assert b.delete_by_metadata(b"m1") == a.delete_by_metadata(b"m1")
    _close(a, b)


@pytest.mark.parametrize("final", ["same", "beam"])
def test_bkt_full_compaction_equals_jax_on_one_forest(jax_folder,
                                                      monkeypatch, final):
    """The whole compaction — id remap, forest rebuild, the refine pass
    (the dense scan over the new forest's partition, or the walk over the
    remapped graph) and the orphan repair — on one forest: the JAX
    package's tree build is handed the forest the port drew, so every
    later stage must give the same graph and the same ids.  64 pivots
    (not every row) make the walk of a beam pass read the remapped graph."""
    a, b = _both(jax_folder, FinalRefineSearchMode=final,
                 NumberOfInitialDynamicPivots=2)
    for idx in (a, b):
        idx.delete(DATA[0:300:3])
        idx.delete_by_metadata(b"m500")
        idx.add(DATA[N_BASE:N_BASE + 60])
    np.testing.assert_array_equal(_graph(b), _graph(a))
    assert b.refine_index() == tsp.ErrorCode.Success
    forest = b._tree

    def port_forest(self, data, seed=42, sample_ids=None):
        assert data.shape[0] == b.num_samples
        self.tree_starts = forest.tree_starts.copy()
        self.nodes = np.asarray(forest.nodes, self.nodes.dtype).copy()
        self._rebuild_sample_center_map()

    monkeypatch.setattr(type(a._tree), "build", port_forest)
    assert a.refine_index() == jsp.ErrorCode.Success
    np.testing.assert_array_equal(b._host[:b._n], a._host[:a._n])
    np.testing.assert_array_equal(b._tree.nodes, a._tree.nodes)
    np.testing.assert_array_equal(_graph(b), _graph(a))
    _same_search(a, b)
    _close(a, b)


def test_bkt_compaction_recall_after_tree_rebuild(jax_folder):
    """The real compaction (new forest, one refine pass, repair): recall
    against the exact truth over the live rows holds."""
    _, b = _both(jax_folder)
    b.add(DATA[N_BASE:N_BASE + 100])
    b.delete(DATA[:N_BASE + 100:4])
    kept = np.flatnonzero(~b._deleted[:b._n])
    assert len(kept) <= N_BASE + 100 - 300

    def recall():
        _, ids = b.search_batch(QUERIES, 10, search_mode="beam")
        _, truth = b.exact_search_batch(QUERIES, 10)
        return np.mean([len(set(x) & set(t)) / 10
                        for x, t in zip(ids, truth)]), truth
    before, truth_before = recall()
    assert b.refine_index() == tsp.ErrorCode.Success
    assert b.num_samples == len(kept) and b.num_deleted == 0
    np.testing.assert_array_equal(b._host[:b._n], DATA[kept])
    after, truth_after = recall()
    # the same live rows, renumbered
    np.testing.assert_array_equal(kept[truth_after], truth_before)
    assert after >= min(before - 0.02, 0.95), (before, after)
    _close(b)


def test_flat_compaction_and_save_equal(tmp_path):
    """FLAT: delete, delete_by_metadata, compaction and the compaction a
    save does past DeletePercentageForRefine give the JAX package's
    corpus, metadata, ids and bytes."""
    out = {}
    for name, pkg, kw in (("jax", jsp, {}), ("port", tsp,
                                            {"device": "cpu"})):
        idx = pkg.create_instance("FLAT", "Float", **kw)
        idx.set_parameter("DistCalcMethod", "L2")
        idx.build(DATA[:300], pkg.MetadataSet(_metas(0, 300)),
                  with_meta_index=True)
        codes = [int(idx.delete(DATA[:150:2])),
                 int(idx.delete_by_metadata(b"m7")),
                 int(idx.add(DATA[300:330]))]
        res = idx.search_batch(QUERIES, 10)
        idx.refine_index()
        after = idx.search_batch(QUERIES, 10)
        idx.delete(DATA[100:260])                # past 40 %: save compacts
        folder = str(tmp_path / name)
        idx.save_index(folder)
        blobs = {f: open(os.path.join(folder, f), "rb").read()
                 for f in ("vectors.bin", "deletes.bin", "metadata.bin",
                           "metadataIndex.bin")}
        out[name] = (codes, res, after, idx.num_samples, blobs)
    j, t = out["jax"], out["port"]
    assert t[0] == j[0] and t[3] == j[3]
    for x, y in ((t[1], j[1]), (t[2], j[2])):
        np.testing.assert_array_equal(x[1], y[1])
        np.testing.assert_array_equal(x[0], y[0])
    assert t[4] == j[4]


# ---- save -> WAL -> reload, both directions ---------------------------------

@pytest.mark.parametrize("saver", ["jax", "port"])
def test_wal_replay_across_packages(jax_folder, tmp_path, saver):
    """One package saves with WalEnabled=1 and keeps mutating (the log
    grows); the other package loads the folder, replaying the log, and
    holds the live index's rows, tombstones, graph and ids."""
    pkgs = {"jax": (jsp, {}), "port": (tsp, {"device": "cpu"})}
    pkg, kw = pkgs[saver]
    live = pkg.load_index(jax_folder, **kw)
    live.set_parameter("WalEnabled", "1")
    live.set_parameter("WalFsync", "0")
    folder = str(tmp_path / "wal_idx")
    assert int(live.save_index(folder)) == 0
    lo = N_BASE
    live.add(DATA[lo:lo + 40], pkg.MetadataSet(_metas(lo, lo + 40)))
    live.delete(DATA[10:14])
    live.add(DATA[lo + 40:lo + 50], pkg.MetadataSet(_metas(lo + 40,
                                                           lo + 50)))
    live.delete_by_metadata(b"m1210")
    assert live.mutation_state()["acked_writes"] == 4
    other, okw = pkgs["port" if saver == "jax" else "jax"]
    back = other.load_index(folder, **okw)
    assert back.num_samples == live.num_samples == lo + 50
    assert back.num_deleted == live.num_deleted == 5
    np.testing.assert_array_equal(_graph(back), _graph(live))
    _same_search(live, back)
    # the reloaded index logs on: its next add replays in the first package
    back.add(DATA[lo + 50:lo + 55])
    again = pkg.load_index(folder, **kw)
    assert again.num_samples == lo + 55
    np.testing.assert_array_equal(_graph(again), _graph(back))
    _close(live, back, again)
