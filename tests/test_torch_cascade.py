"""The port's tiered corpus cascade (sptag_tpu_torch/ops/cascade.py and its
wiring into FLAT, the dense scan, the beam walk, KDT and the scheduler)
against the JAX package's, on the same numpy inputs, on the CPU.

The stages are held piece by piece (budgets, quantization, sign packing
with bit-31 words, the Hamming scan, the int8 tiers, the fp re-rank), then
``CascadeState`` on every tier, the streamed host oracle, the triage
counts, and the indexes end to end.  Integer arithmetic (bits, Hamming
distances, int8 dots, shortlists) must match exactly; float32 distances
within 1e-5 of their terms' magnitude (the two packages sum in other
orders), with the ids equal.  The port's own contracts are held exactly:
a host tier returns the device tier's ids and distance bits, and
scheduled and segmented walks the monolithic walk's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.ops import cascade as jc
from sptag_tpu_torch.ops import cascade as tc
from sptag_tpu_torch.ops import int8_dots, sketch_dots
from sptag_tpu_torch.ops import walk_dots as wd
from sptag_tpu_torch.utils import devmem

L2, COS = 0, 1


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is several times faster here
    than a pool contended by the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(n=1500, d=48, nq=32, seed=7):
    """The JAX package's cascade test corpus: mildly clustered."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2.0
    data = (centers[rng.integers(0, 16, n)]
            + rng.standard_normal((n, d)).astype(np.float32))
    queries = (centers[rng.integers(0, 16, nq)]
               + rng.standard_normal((nq, d)).astype(np.float32))
    return data.astype(np.float32), queries.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, scale):
    """float32 distances within 1e-5 of the magnitude of their terms."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.broadcast_to(np.asarray(scale, np.float64), want.shape)
    big = want >= 3e38
    assert (got[big] >= 3e38).all()
    err = np.abs(got - want)[~big]
    assert (err <= 1e-5 * scale[~big] + 1e-6).all(), float(err.max())


def _flat(mod, data, **params):
    kw = {"device": "cpu"} if mod is tsp else {}
    idx = mod.create_instance("FLAT", "Float", **kw)
    idx.set_parameter("DistCalcMethod", "L2")
    for k, v in params.items():
        idx.set_parameter(k, str(v))
    idx.build(data)
    return idx


# ---- budgets, quantization, sign bits ---------------------------------------

@pytest.mark.parametrize("b1,b2,k,n", [(0, 0, 10, 4096), (300, 33, 10, 4096),
                                       (100000, 100000, 10, 4096),
                                       (0, 0, 100, 2048), (5, 3, 10, 128),
                                       (0, 7, 1, 1 << 20)])
def test_resolve_budgets_match_jax(b1, b2, k, n):
    assert tc.resolve_budgets(b1, b2, k, n) == jc.resolve_budgets(b1, b2, k,
                                                                  n)


def test_budget_and_tier_validation():
    for bad in ((-1, 0), (0, -5)):
        with pytest.raises(ValueError):
            tc.resolve_budgets(*bad, 10, 4096)
    with pytest.raises(ValueError):
        tc.normalize_tier("hbm")
    assert tc.normalize_tier(" Host ") == "host"
    with pytest.raises(ValueError):
        tc.quantize_int8(np.zeros((4, 4), np.int8))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_matches_jax(seed):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((300, 40)) * (3 + seed)).astype(np.float32)
    q, scale = tc.quantize_int8(data)
    jq, jscale = jc.quantize_int8(data)
    assert scale == jscale
    np.testing.assert_array_equal(q, jq)


@pytest.mark.parametrize("d", [32, 48, 64, 70])
def test_pack_sign_bits_matches_jax_with_bit31(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((97, d)).astype(np.float32)
    x[:5, 31::32] = 1.0               # bit 31 set: negative int32 words
    got = tc.pack_sign_bits(_t(x)).numpy()
    want = np.asarray(jc.pack_sign_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any()


def test_hamming_plain_version_matches_jax():
    rng = np.random.default_rng(3)
    sk = rng.integers(-2 ** 31, 2 ** 31, (300, 3)).astype(np.int32)
    qb = rng.integers(-2 ** 31, 2 ** 31, (9, 3)).astype(np.int32)
    inv = rng.random(300) < 0.1
    got = sketch_dots.hamming(_t(qb), _t(sk), _t(inv)).numpy()
    want = np.asarray(jc._hamming(jnp.asarray(sk), jnp.asarray(qb),
                                  jnp.asarray(inv)))
    np.testing.assert_array_equal(got, want)
    assert sketch_dots.launch_counts()["sketch_hamming"] == 0


def test_quantize_queries_matches_jax_and_zero_rows():
    _, q = _dataset(nq=16)
    q[3] = 0.0                       # a bucket's zero padding row
    qq, qs = tc.quantize_queries(_t(q))
    jqq, jqs = jc._quantize_queries(jnp.asarray(q))
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs)[:, 0])
    assert np.isfinite(qs.numpy()).all() and (qq.numpy()[3] == 0).all()


# ---- tier stages -------------------------------------------------------------

def _state_inputs(n=900, d=48, nq=12, seed=5):
    data, q = _dataset(n=n, d=d, nq=nq, seed=seed)
    i8, scale = tc.quantize_int8(data)
    inv = np.zeros(n, bool)
    inv[::17] = True
    return data, q, i8, np.float32(scale), inv


@pytest.mark.parametrize("metric", [L2, COS])
def test_int8_tier_stages_match_jax(metric):
    data, q, i8, scale, inv = _state_inputs()
    base = 1
    # the whole corpus
    x2 = tc.int8_row_norms(_t(i8), float(scale))
    got = tc.int8_full_scores(_t(q), _t(i8), x2, float(scale), metric, base)
    want = np.asarray(jc._int8_full_scores(jnp.asarray(q), jnp.asarray(i8),
                                           jnp.float32(scale), metric, base))
    _close(got.numpy(), want, np.abs(want) + 1.0)
    # a gathered shortlist (-1 slots and tombstones -> MAX_DIST)
    rng = np.random.default_rng(1)
    short = rng.integers(-1, len(data), (len(q), 64)).astype(np.int32)
    got = tc.int8_gathered_scores(_t(q), _t(i8), _t(short), _t(inv),
                                  float(scale), metric, base).numpy()
    want = np.asarray(jc._int8_gathered_scores(
        jnp.asarray(q), jnp.asarray(i8)[jnp.maximum(short, 0)],
        jnp.float32(scale), metric, base))
    dead = (short < 0) | inv[np.maximum(short, 0)]
    want = np.where(dead, np.float32(tc.MAX_DIST), want)
    _close(got, want, np.abs(want) + 1.0)
    # ROWS mode (rows fetched in output order) gives GATHER's bits
    rows = i8[np.maximum(short, 0)].reshape(-1, i8.shape[1])
    ids = np.where(inv[np.maximum(short, 0)], -1, short)
    rows_mode = tc.int8_gathered_scores(
        _t(q), _t(rows), _t(ids), None, float(scale), metric, base,
        int8_dots.ROWS).numpy()
    assert rows_mode.tobytes() == got.tobytes()


@pytest.mark.parametrize("metric", [L2, COS])
def test_int8_gathered_scores_equal_the_full_scan_at_their_ids(metric):
    """The gathered int8 tier sums each row's squares itself; with the
    full scan's norm table (``int8_row_norms``) both give the same bits
    for every live slot, and MAX_DIST for -1 ids and tombstones."""
    data, q, i8, scale, inv = _state_inputs()
    x2 = tc.int8_row_norms(_t(i8), float(scale))
    full = tc.int8_full_scores(_t(q), _t(i8), x2, float(scale), metric,
                               1).numpy()
    rng = np.random.default_rng(2)
    short = rng.integers(-1, len(data), (len(q), 80)).astype(np.int32)
    got = tc.int8_gathered_scores(_t(q), _t(i8), _t(short), _t(inv),
                                  float(scale), metric, 1).numpy()
    safe = np.maximum(short, 0)
    dead = (short < 0) | inv[safe]
    want = np.where(dead, np.float32(tc.MAX_DIST),
                    np.take_along_axis(full, safe, axis=1))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("b1,b2", [(256, 64), (128, 128)])
def test_shortlists_match_jax(b1, b2):
    data, q, i8, scale, inv = _state_inputs()
    st = tc.CascadeState(data, inv, "device", L2, 1, device="cpu")
    jst = jc.CascadeState(data, inv, "device", L2, 1)
    np.testing.assert_array_equal(st.sketches_d.numpy(),
                                  np.asarray(jst.sketches_d))
    short1 = tc.shortlist_sketch(st.sketches_d, st.mean_d, st.invalid_d,
                                 _t(q), b1)
    jshort1 = jc._shortlist_sketch(jst.sketches_d, jst.mean_d,
                                   jst.invalid_d, jnp.asarray(q), b1)
    np.testing.assert_array_equal(short1.numpy(), np.asarray(jshort1))
    short2 = tc.shortlist_int8_from(_t(q), st.int8_d, st.scale,
                                    st.invalid_d, short1, b2, L2, 1)
    jshort2 = jc._shortlist_int8_from(jnp.asarray(q), jst.int8_d,
                                      jst.scale_d, jst.invalid_d, jshort1,
                                      b2, L2, 1)
    np.testing.assert_array_equal(short2.numpy(), np.asarray(jshort2))
    full = tc.shortlist_int8_full(_t(q), st.int8_d, st._int8_norms(),
                                  st.scale, st.invalid_d, b2, L2, 1)
    jfull = jc._shortlist_int8_full(jnp.asarray(q), jst.int8_d, jst.scale_d,
                                    jst.invalid_d, b2, L2, 1)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    # the fp re-rank, resident (GATHER) and fetched (ROWS): one set of bits
    d, ids = tc.rerank_gathered(_t(q), st.fp_d, short2, 10, L2, 1,
                                wd.GATHER)
    rows = st.fp_d[short2.clamp_min(0).long()].reshape(-1, data.shape[1])
    d2, ids2 = tc.rerank_gathered(_t(q), rows, short2, 10, L2, 1, wd.ROWS)
    assert d.numpy().tobytes() == d2.numpy().tobytes()
    np.testing.assert_array_equal(ids.numpy(), ids2.numpy())
    jd, jids = jc.rerank_gathered(
        jnp.asarray(q), jst.fp_d[jnp.maximum(jshort2, 0)], jshort2, 10, L2,
        1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(d.numpy(), np.asarray(jd), 4 * np.abs(np.asarray(jd)) + 100.0)


# ---- CascadeState: three tiers -----------------------------------------------

@pytest.mark.parametrize("tier", ["device", "host", "host_all"])
@pytest.mark.parametrize("b1,b2", [(512, 128), (256, 256), (0, 0)])
def test_cascade_state_search_matches_jax(tier, b1, b2):
    data, q, _, _, inv = _state_inputs(n=1300, nq=24)
    st = tc.CascadeState(data, inv, tier, L2, 1, device="cpu")
    jst = jc.CascadeState(data, inv, tier, L2, 1)
    d, ids = st.search(q, 10, b1, b2)
    jd, jids = jst.search(q, 10, b1, b2)
    np.testing.assert_array_equal(ids, jids)
    _close(d, jd, 4 * np.abs(jd) + 100.0)
    assert st.device_bytes() <= jst.device_bytes() + 1300 * 4
    assert st.host_bytes() == jst.host_bytes()


def test_cascade_state_budgets_composing_tiers_out():
    data, q, _, _, inv = _state_inputs(n=700)
    for tier in ("device", "host"):
        st = tc.CascadeState(data, inv, tier, L2, 1, device="cpu")
        jst = jc.CascadeState(data, inv, tier, L2, 1)
        for b1, b2 in ((10 ** 6, 64), (10 ** 6, 10 ** 6)):
            d, ids = st.search(q, 10, b1, b2)
            jd, jids = jst.search(q, 10, b1, b2)
            np.testing.assert_array_equal(ids, jids)
            _close(d, jd, 4 * np.abs(jd) + 100.0)
    with pytest.raises(ValueError, match="host_all"):
        tc.CascadeState(data, inv, "host_all", L2, 1,
                        device="cpu").search(q, 10, 10 ** 6, 64)


def test_host_exact_scan_matches_jax_across_blocks():
    data, q, _, _, inv = _state_inputs(n=1000, nq=8)
    got = tc.host_exact_scan(data, inv, q, 10, L2, 1, block_rows=257,
                             device="cpu")
    want = jc.host_exact_scan(data, inv, q, 10, L2, 1, block_rows=257)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0], 4 * np.abs(want[0]) + 100.0)


@pytest.mark.parametrize("b1,b2", [(64, 16), (10 ** 6, 32)])
def test_tier_membership_counts_match_jax(b1, b2):
    data, q, _, _, inv = _state_inputs(n=1100, nq=4)
    st = tc.CascadeState(data, inv, "host_all" if b1 < 10 ** 6 else "host",
                         L2, 1, device="cpu")
    jst = jc.CascadeState(data, inv, st.tier, L2, 1)
    truth = tc.host_exact_scan(data, inv, q[:1], 10, L2, 1,
                               device="cpu")[1][0]
    assert st.tier_membership(q[0], truth, 10, b1, b2) == \
        jst.tier_membership(q[0], truth, 10, b1, b2)


# ---- FLAT -------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["host", "host_all"])
def test_flat_host_tier_bit_identical_to_device(tier):
    data, q = _dataset(n=2000, nq=32)
    params = dict(CascadeSearch=1, TierBudgetSketch=512, TierBudgetInt8=128)
    d0, i0 = _flat(tsp, data, **params).search_batch(q, 10)
    d1, i1 = _flat(tsp, data, CorpusTier=tier, **params).search_batch(q, 10)
    np.testing.assert_array_equal(i0, i1)
    assert d0.tobytes() == d1.tobytes()
    jd, ji = _flat(jsp, data, CorpusTier=tier, **params).search_batch(q, 10)
    np.testing.assert_array_equal(i1, ji)
    _close(d1, jd, 4 * np.abs(jd) + 100.0)


@pytest.mark.parametrize("tier", ["device", "host"])
def test_flat_cosine_cascade_matches_jax(tier):
    """A cosine FLAT cascade returns the JAX package's ids on the device and
    host tiers at the same budgets, distances within float32 tolerance;
    the host tier returns the device tier's bits."""
    data, q = _dataset(n=2000, nq=32)
    params = dict(DistCalcMethod="Cosine", CascadeSearch=1,
                  TierBudgetSketch=512, TierBudgetInt8=128)
    d, ids = _flat(tsp, data, CorpusTier=tier, **params).search_batch(q, 10)
    jd, ji = _flat(jsp, data, CorpusTier=tier, **params).search_batch(q, 10)
    np.testing.assert_array_equal(ids, ji)
    _close(d, jd, np.abs(jd) + 2.0)
    if tier == "host":
        d0, i0 = _flat(tsp, data, **params).search_batch(q, 10)
        np.testing.assert_array_equal(i0, ids)
        assert d0.tobytes() == d.tobytes()


def test_flat_host_tiers_keep_fp_off_the_device():
    data, q = _dataset(n=2000, nq=8)
    devmem.reset()
    try:
        idx = _flat(tsp, data, CascadeSearch=1, CorpusTier="host")
        idx.search_batch(q, 10)
        comp = devmem.component_bytes()
        assert "corpus" not in comp, comp
        assert comp.get("int8_blocks", 0) > 0 and comp.get("sketch", 0) > 0
        assert comp.get("host_corpus", 0) >= data.nbytes
        device_host = devmem.device_bytes()
        devmem.reset()
        del idx
        idx = _flat(tsp, data, CascadeSearch=1, CorpusTier="host_all")
        idx.search_batch(q, 10)
        comp2 = devmem.component_bytes()
        assert "corpus" not in comp2 and "int8_blocks" not in comp2, comp2
        assert comp2["host_corpus"] > comp["host_corpus"]
        # the sketches, the mean and the mask: N_pad (4W + 1) + 4D bytes
        n_pad = 2048
        assert devmem.device_bytes() == n_pad * (4 * 2 + 1) + 4 * 48
        assert devmem.device_bytes() < device_host
    finally:
        devmem.reset()


def test_flat_host_oracle_streams_and_is_exact():
    data, q = _dataset(n=2000, nq=16)
    td, ti = _flat(tsp, data).exact_search_batch(q, 10)
    host = _flat(tsp, data, CascadeSearch=1, CorpusTier="host")
    hd, hi = host.exact_search_batch(q, 10)
    np.testing.assert_array_equal(ti, hi)
    _close(hd, td, 4 * np.abs(td) + 100.0)


@pytest.mark.parametrize("tier", ["device", "host", "host_all"])
def test_flat_tombstones_hidden_by_every_tier_as_in_jax(tier):
    data, q = _dataset(n=1500, nq=16)
    params = dict(CascadeSearch=1, TierBudgetSketch=512, TierBudgetInt8=128,
                  CorpusTier=tier)
    idx, ref = _flat(tsp, data, **params), _flat(jsp, data, **params)
    _, before = idx.search_batch(q, 10)
    victims = sorted({int(v) for v in before[:, :3].ravel() if v >= 0})[:16]
    for index in (idx, ref):
        assert index.delete(data[victims]) == tsp.ErrorCode.Success
    _, after = idx.search_batch(q, 10)
    assert not set(victims) & set(after.ravel().tolist())
    np.testing.assert_array_equal(after, ref.search_batch(q, 10)[1])
    _, oracle = idx.exact_search_batch(q, 10)
    assert not set(victims) & set(oracle.ravel().tolist())


@pytest.mark.parametrize("tier", ["device", "host"])
def test_flat_delta_shard_adds_found_through_tiers(tier):
    data, q = _dataset(n=1500, nq=8)
    idx = _flat(tsp, data, CascadeSearch=1, CorpusTier=tier,
                DeltaShardCapacity=64)
    assert idx.add(q[:4]) == tsp.ErrorCode.Success
    d, ids = idx.search_batch(q[:4], 5)
    assert (ids[:, 0] >= 1500).all() and (d[:, 0] <= 1e-4).all()


def test_flat_cascade_off_parity():
    data, q = _dataset(n=1200, nq=16)
    plain = _flat(tsp, data)
    d0, i0 = plain.search_batch(q, 10)
    devmem.reset()
    try:
        off = _flat(tsp, data)
        assert str(off.get_parameter("CascadeSearch")) == "0"
        assert str(off.get_parameter("CorpusTier")) == "device"
        d1, i1 = off.search_batch(q, 10)
        assert d0.tobytes() == d1.tobytes() and i0.tobytes() == i1.tobytes()
        comp = devmem.component_bytes()
        assert "int8_blocks" not in comp and "host_corpus" not in comp
        assert off._cascade is None and off.cascade_triage(q[0], i0[0]) \
            is None
    finally:
        devmem.reset()


def test_flat_cascade_triage_matches_jax_and_feeds_qualmon():
    from sptag_tpu_torch.utils import qualmon

    data, q = _dataset(n=2000, nq=4)
    params = dict(CascadeSearch=1, TierBudgetSketch=64, TierBudgetInt8=16)
    idx, ref = _flat(tsp, data, **params), _flat(jsp, data, **params)
    _, truth = idx.exact_search_batch(q[:1], 10)
    tri = idx.cascade_triage(q[0], truth[0], 10)
    assert tri == ref.cascade_triage(q[0], truth[0], 10)
    assert set(tri) == {"sketch_dropped", "int8_dropped", "host_dropped"}
    verdict, _ = qualmon.classify_low_recall("", "flat", cascade=tri)
    assert verdict in ("sketch_budget", "int8_budget", "unknown")


# ---- the dense scan, the beam walk and KDT on a JAX-built folder -----------

@pytest.fixture(scope="module")
def graph_folders(tmp_path_factory):
    """A BKT and a KDT folder built by the JAX package on the cascade
    corpus."""
    data, q = _dataset(n=1200, d=32, nq=16)
    out = {}
    for algo in ("BKT", "KDT"):
        idx = jsp.create_instance(algo, "Float")
        for k, v in {"DistCalcMethod": "L2", "BKTKmeansK": "8",
                     "TPTNumber": "2", "RefineIterations": "1",
                     "FinalRefineSearchMode": "dense"}.items():
            idx.set_parameter(k, v)
        idx.build(data)
        folder = str(tmp_path_factory.mktemp(algo.lower()))
        idx.save_index(folder)
        idx.close()
        out[algo] = folder
    return out, data, q


def _pair(folder):
    return jsp.load_index(folder), tsp.load_index(folder, device="cpu")


def _recall(ids, truth, k=10):
    return float(np.mean([len(set(a[:k]) & set(t[:k])) / k
                          for a, t in zip(ids.tolist(), truth.tolist())]))


@pytest.mark.parametrize("algo", ["BKT", "KDT"])
@pytest.mark.parametrize("mode", ["dense", "beam"])
def test_graph_cascade_matches_jax_on_both_tiers(graph_folders, algo, mode):
    folders, data, q = graph_folders
    j, t = _pair(folders[algo])
    try:
        _, truth = t.exact_search_batch(q, 10)
        for index in (j, t):
            index.set_parameter("SearchMode", mode)
        _, off = t.search_batch(q, 10, max_check=512)
        out = {}
        for tier in ("device", "host"):
            for index in (j, t):
                index.set_parameter("CascadeSearch", "1")
                index.set_parameter("TierBudgetInt8", "128")
                index.set_parameter("CorpusTier", tier)
            jd, ji = j.search_batch(q, 10, max_check=512)
            out[tier] = t.search_batch(q, 10, max_check=512)
            np.testing.assert_array_equal(out[tier][1], ji)
            _close(out[tier][0], jd, 4 * np.abs(jd) + 100.0)
            assert _recall(out[tier][1], truth) >= _recall(off, truth) - 0.1
        # the fp re-rank of fetched rows is the resident re-rank's
        if mode == "dense":
            np.testing.assert_array_equal(out["device"][1], out["host"][1])
            assert out["device"][0].tobytes() == out["host"][0].tobytes()
        # the host tier's oracle streams and stays exact
        np.testing.assert_array_equal(t.exact_search_batch(q, 10)[1], truth)
    finally:
        j.close()
        t.close()


@pytest.fixture(scope="module")
def cosine_folder(tmp_path_factory):
    """A cosine BKT folder built by the JAX package on the cascade
    corpus."""
    data, q = _dataset(n=1200, d=32, nq=16, seed=9)
    idx = jsp.create_instance("BKT", "Float")
    for k, v in {"DistCalcMethod": "Cosine", "BKTKmeansK": "8",
                 "TPTNumber": "2", "RefineIterations": "1",
                 "FinalRefineSearchMode": "dense"}.items():
        idx.set_parameter(k, v)
    idx.build(data)
    folder = str(tmp_path_factory.mktemp("bkt_cosine"))
    idx.save_index(folder)
    idx.close()
    return folder, q


@pytest.mark.parametrize("mode", ["dense", "beam"])
def test_graph_cosine_cascade_matches_jax_on_both_tiers(cosine_folder, mode):
    """The cosine BKT cascade (the dense scan over int8 blocks, the walk
    over int8 rows) returns the JAX package's ids on the device and host
    tiers at the same budgets, distances within float32 tolerance."""
    folder, q = cosine_folder
    j, t = _pair(folder)
    try:
        for index in (j, t):
            index.set_parameter("SearchMode", mode)
        for tier in ("device", "host"):
            for index in (j, t):
                index.set_parameter("CascadeSearch", "1")
                index.set_parameter("TierBudgetInt8", "128")
                index.set_parameter("CorpusTier", tier)
            jd, ji = j.search_batch(q, 10, max_check=512)
            d, ids = t.search_batch(q, 10, max_check=512)
            np.testing.assert_array_equal(ids, ji)
            _close(d, jd, np.abs(jd) + 2.0)
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("tier", ["device", "host"])
def test_cascade_walk_scheduled_and_segmented_equal_monolithic(
        graph_folders, tier):
    folders, _, q = graph_folders
    t = tsp.load_index(folders["BKT"], device="cpu")
    try:
        for name, value in (("SearchMode", "beam"), ("CascadeSearch", "1"),
                            ("CorpusTier", tier)):
            t.set_parameter(name, value)
        d1, i1 = t.search_batch(q, 10, max_check=512)
        t.set_parameter("BeamSegmentIters", "3")
        d2, i2 = t.search_batch(q, 10, max_check=512)
        t.set_parameter("BeamSegmentIters", "0")
        t.set_parameter("ContinuousBatching", "1")
        d3, i3 = t.search_batch(q, 10, max_check=512)
        for d, i in ((d2, i2), (d3, i3)):
            np.testing.assert_array_equal(i1, i)
            assert d1.tobytes() == d.tobytes()
    finally:
        t.close()


def test_graph_cascade_ledger_and_off_parity(graph_folders):
    folders, _, q = graph_folders
    t = tsp.load_index(folders["BKT"], device="cpu")
    try:
        t.set_parameter("SearchMode", "beam")
        d0, i0 = t.search_batch(q, 10, max_check=512)
        devmem.reset()
        t.set_parameter("CascadeSearch", "1")
        t.set_parameter("CorpusTier", "host")
        t.search_batch(q, 10, max_check=512)
        comp = devmem.component_bytes()
        assert "corpus" not in comp and comp.get("int8_blocks", 0) > 0
        assert comp.get("host_corpus", 0) >= 1200 * 32 * 4
        eng = t._get_engine()
        assert eng.data.dtype == torch.int8 and eng.nbr_vecs is None
        t.set_parameter("CascadeSearch", "0")
        d1, i1 = t.search_batch(q, 10, max_check=512)
        assert d0.tobytes() == d1.tobytes() and i0.tobytes() == i1.tobytes()
    finally:
        devmem.reset()
        t.close()


@pytest.mark.parametrize("name", ["cascade_search_cost",
                                  "cascade_shortlist_cost",
                                  "fp_rerank_resident_cost",
                                  "host_scan_block_cost",
                                  "pack_sketches_cost"])
def test_cost_formulas_equal_jax_ledger_entries(name):
    """The port's cost ledger evaluates each cascade family exactly as the
    JAX package's ledger does."""
    from sptag_tpu.utils import costmodel as jcm
    from sptag_tpu_torch.utils import costmodel as tcm

    family = {"cascade_search_cost": "cascade.search",
              "cascade_shortlist_cost": "cascade.shortlist",
              "fp_rerank_resident_cost": "cascade.rerank_resident",
              "host_scan_block_cost": "cascade.host_scan",
              "pack_sketches_cost": "cascade.pack_sketches"}[name]
    shape = dict(Q=1024, N=200064, W=4, D=128, b1=8192, b2=1024, k=10,
                 R=65536)
    def both(**kw):
        t, j = tcm.estimate(family, **kw), jcm.estimate(family, **kw)
        return (t.flops, t.hbm_bytes), (j.flops, j.hbm_bytes)

    port, ref = both(**shape)
    assert port == ref
    assert getattr(tc, "_" + name)(**shape) == \
        getattr(jc, "_" + name)(**shape)
    if name in ("cascade_search_cost", "cascade_shortlist_cost"):
        for flags in ({"use_sketch": False}, {"use_int8": False},
                      {"use_sketch": False, "use_int8": False}):
            port, ref = both(**shape, **flags)
            assert port == ref
