"""The port's FLAT index (sptag_tpu_torch/algo/flat.py) against the JAX
package's, through the public entry points and through folders.

Data are integer-valued, so every distance is exact in float32 whatever
the summation order (|dot| < 2^24): ids and distances must be equal for
all four value types and both metrics, except float32 cosine, whose rows
are normalized to non-integers — there distances agree within rtol 1e-5
and ids at separated ranks (tests/test_torch_dense.py's rule).
``ApproxTopK`` is the exact top-k in both packages off the TPU;
``BinnedTopK=on`` bins the same rows the same way.
"""

import os

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from test_torch_dense import assert_same_neighbors

@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is several times faster here
    than a pool contended by the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TYPES = {"Float": np.float32, "Int8": np.int8, "UInt8": np.uint8,
         "Int16": np.int16}


def _data(vt, n, nq, d, seed):
    rng = np.random.default_rng(seed)
    if vt == "UInt8":
        x = rng.integers(0, 40, (n + nq, d))
    elif vt == "Int16":
        x = rng.integers(-300, 300, (n + nq, d))
    else:
        x = rng.integers(-20, 20, (n + nq, d))
    x = x.astype(TYPES[vt])
    return x[:n], x[n:]


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
@pytest.mark.parametrize("vt", list(TYPES))
def test_flat_search_matches_jax(vt, metric):
    data, q = _data(vt, 700, 48, 24, seed=len(vt) + len(metric))
    ref = jsp.create_instance("FLAT", vt)
    got = tsp.create_instance("FLAT", vt, device="cpu")
    exact = not (vt == "Float" and metric == "Cosine")
    for knob in (None, ("ApproxTopK", "true"), ("BinnedTopK", "on")):
        for index in (ref, got):
            index.set_parameter("DistCalcMethod", metric)
            if knob:
                index.set_parameter("ApproxTopK", "false")
                index.set_parameter(*knob)
            index.build(data)
        d_ref, i_ref = ref.search_batch(q, 10)
        d_got, i_got = got.search_batch(q, 10)
        assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=exact)
    d_ref, i_ref = ref.exact_search_batch(q, 10)
    d_got, i_got = got.exact_search_batch(q, 10)
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=exact)


def test_binned_wins_over_approx_and_auto_rule():
    data, q = _data("Float", 3000, 16, 16, seed=3)
    for settings in ([("ApproxTopK", "true"), ("BinnedTopK", "on"),
                      ("ApproxRecallTarget", "0.9")],
                     [("BinnedTopK", "auto")]):
        ref = jsp.create_instance("FLAT", "Float")
        got = tsp.create_instance("FLAT", "Float", device="cpu")
        for index in (ref, got):
            index.set_parameter("DistCalcMethod", "L2")
            for name, value in settings:
                index.set_parameter(name, value)
            index.build(data)
        d_ref, i_ref = ref.search_batch(q, 32)
        d_got, i_got = got.search_batch(q, 32)
        assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=True)


def test_flat_folders_interchange_and_padding(tmp_path):
    data, q = _data("Int8", 300, 8, 16, seed=4)
    mine = tsp.create_instance("FLAT", "Int8", device="cpu")
    mine.set_parameter("DistCalcMethod", "L2")
    mine.build(data)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    assert mine.save_index(tdir) == tsp.ErrorCode.Success
    theirs = jsp.load_index(tdir)
    theirs.save_index(jdir)
    back = tsp.load_index(jdir, device="cpu")
    for name in ("vectors.bin", "deletes.bin", "indexloader.ini"):
        assert open(os.path.join(tdir, name), "rb").read() == \
            open(os.path.join(jdir, name), "rb").read(), name
    for index in (theirs, back):
        d, ids = index.search_batch(q, 400)       # k beyond the corpus
        d0, ids0 = mine.search_batch(q, 400)
        np.testing.assert_array_equal(ids, ids0)
        np.testing.assert_array_equal(d, d0)
    assert (ids0[:, 300:] == -1).all()
    assert (d0[:, 300:] == np.float32(3.4e38)).all()
    assert mine.search(data[5], 1).ids[0] == 5


def test_flat_deletes_from_a_jax_folder(tmp_path):
    data, q = _data("Float", 500, 16, 8, seed=5)
    ref = jsp.create_instance("FLAT", "Float")
    ref.set_parameter("DistCalcMethod", "L2")
    ref.build(data)
    for i in range(0, 500, 3):
        ref.delete(data[i])
    folder = str(tmp_path / "f")
    ref.save_index(folder)
    got = tsp.load_index(folder, device="cpu")
    assert got.num_deleted == ref.num_deleted
    d_ref, i_ref = ref.search_batch(q, 10)
    d_got, i_got = got.search_batch(q, 10)
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=True)
    assert not (i_got % 3 == 0).any()


def test_flat_not_ported_knobs_raise():
    """SketchPrefilter and CascadeSearch, once refused, now serve: the same
    ids as the JAX package's index, and nothing raises."""
    data, q = _data("Float", 400, 6, 8, seed=6)
    ref = jsp.create_instance("FLAT", "Float")
    idx = tsp.create_instance("FLAT", "Float", device="cpu")
    for index in (ref, idx):
        index.set_parameter("DistCalcMethod", "L2")
        index.build(data)
    for name, value in (("SketchPrefilter", "true"), ("CascadeSearch", "1")):
        for index in (ref, idx):
            index.set_parameter(name, value)
        d_ref, i_ref = ref.search_batch(q, 3)
        d_got, i_got = idx.search_batch(q, 3)
        assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=True)
        for index in (ref, idx):
            index.set_parameter(name,
                                "0" if name == "CascadeSearch" else "false")
    # mutation is ported (tests/test_torch_mutation.py): an add is found
    assert idx.add(data[:2] + 0.25) == tsp.ErrorCode.Success
    assert idx.search_batch(data[:2] + 0.25, 1)[1][:, 0].tolist() == \
        [400, 401]


# ---- the sketch prefilter and its calibration -------------------------------

def _clustered(n, nq, d, seed):
    """The JAX package's sketch test corpus: clustered float rows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2.0
    data = centers[rng.integers(0, 16, n)] \
        + rng.standard_normal((n, d)).astype(np.float32)
    q = centers[rng.integers(0, 16, nq)] \
        + rng.standard_normal((nq, d)).astype(np.float32)
    return data.astype(np.float32), q.astype(np.float32)


def _sketch_pair(data, **params):
    ref = jsp.create_instance("FLAT", "Float")
    got = tsp.create_instance("FLAT", "Float", device="cpu")
    for index in (ref, got):
        index.set_parameter("DistCalcMethod", "L2")
        index.set_parameter("SketchPrefilter", "true")
        for k, v in params.items():
            index.set_parameter(k, str(v))
        index.build(data)
    return ref, got


@pytest.mark.parametrize("rerank", [0, 300])
def test_flat_sketch_prefilter_matches_jax(rerank):
    """Auto calibration (the same R as the JAX package's: 64 rows drawn by
    default_rng(0xC0FFEE), 95th percentile, a power of two) and an
    explicit SketchRerank: the same ids, distances within float32."""
    data, q = _clustered(1500, 24, 48, seed=3)
    ref, got = _sketch_pair(data, SketchRerank=rerank)
    d_ref, i_ref = ref.search_batch(q, 10)
    d_got, i_got = got.search_batch(q, 10)
    np.testing.assert_array_equal(i_got, i_ref)
    np.testing.assert_allclose(d_got, d_ref, rtol=1e-5, atol=1e-4)
    with ref._lock:
        cal_ref = ref._sketch[3]
    assert got._sketch[3] == cal_ref
    if rerank:
        assert cal_ref is None           # an explicit R never calibrates
    else:
        assert cal_ref > 0 and cal_ref & (cal_ref - 1) == 0
    # a deletion rebuilds the sketches; both still agree
    for index in (ref, got):
        index.delete(data[i_ref[0, :2]])
    np.testing.assert_array_equal(got.search_batch(q, 10)[1],
                                  ref.search_batch(q, 10)[1])


def test_flat_sketch_calibration_failure_cached():
    """Fewer than 8 live rows: the calibration fails once, is cached as -1
    and the N/32 heuristic serves."""
    data, q = _clustered(300, 4, 16, seed=4)
    _, got = _sketch_pair(data)
    got.delete(data[7:])
    calls = []
    orig = type(got)._calibrate

    def spy(self, *a):
        calls.append(1)
        return orig(self, *a)

    type(got)._calibrate = spy
    try:
        got.search_batch(q, 3)
        got.search_batch(q, 3)
    finally:
        type(got)._calibrate = orig
    assert calls == [1] and got._sketch[3] == -1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sketch_cal_file_crosses_packages(tmp_path, writer):
    """sketch_cal.bin (SPTSCAL1, "<8sqqi") written by either package is
    read by the other: the loaded index reuses the calibration without the
    scan, returns the writer's ids, and a mutation drops it.  The two
    packages write the same bytes."""
    from sptag_tpu.algo.flat import FlatIndex as JaxFlat
    from sptag_tpu_torch.algo.flat import FlatIndex as PortFlat

    data, q = _clustered(1500, 8, 48, seed=5)
    ref, got = _sketch_pair(data)
    _, i_ref = ref.search_batch(q, 10)
    _, i_got = got.search_batch(q, 10)
    folders = {}
    for name, index in (("jax", ref), ("port", got)):
        folders[name] = str(tmp_path / name)
        assert index.save_index(folders[name]) == tsp.ErrorCode.Success
    blobs = [open(os.path.join(f, "sketch_cal.bin"), "rb").read()
             for f in folders.values()]
    assert blobs[0] == blobs[1] and blobs[0][:8] == b"SPTSCAL1"
    # the folder's manifest checksums it like every blob
    with open(os.path.join(folders["port"], "manifest.json")) as f:
        assert "sketch_cal.bin" in f.read()
    reader = "port" if writer == "jax" else "jax"
    loaded = (tsp.load_index(folders[writer], device="cpu")
              if reader == "port" else jsp.load_index(folders[writer]))
    cls = PortFlat if reader == "port" else JaxFlat
    assert loaded._loaded_cal[2] == ref._sketch[3]
    calls = []
    orig = cls._calibrate

    def spy(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    cls._calibrate = spy
    try:
        _, ids = loaded.search_batch(q, 10)
        assert not calls
        np.testing.assert_array_equal(ids, i_ref if reader == "jax"
                                      else i_got)
        assert loaded.add(q[:1]) == tsp.ErrorCode.Success
        assert loaded._loaded_cal is None
        loaded.search_batch(q, 10)
        assert calls
    finally:
        cls._calibrate = orig


def test_sketch_cal_file_absent_by_default(tmp_path):
    data, _ = _clustered(1200, 4, 16, seed=6)
    idx = tsp.create_instance("FLAT", "Float", device="cpu")
    idx.build(data)
    folder = str(tmp_path / "plain")
    assert idx.save_index(folder) == tsp.ErrorCode.Success
    assert not os.path.exists(os.path.join(folder, "sketch_cal.bin"))
