"""The walk's remaining options and the slot scheduler of the PyTorch port
(sptag_tpu_torch/algo/engine.py, algo/scheduler.py, the index wiring)
against the JAX package.

On integer-valued rows with |x| <= 16 every bf16 value is exact and every
distance an exact float32 integer, so the bf16 shadow, packed neighbours
and the segmented walk give the JAX package's ids and distances bit for
bit.  On random float rows the bf16 walks of the two packages sum their
exact products in different orders, so ids are held by overlap (at least
0.9 of each query's top 10 on average) and the re-ranked distances of
shared ids within 1e-5 relative.  The scheduler returns the ids of the
monolithic walk (the port's and the JAX package's) for BKT and KDT,
whatever shares its slots, and distances within 1e-6 relative (refill
buckets change the float32 tiling); on integer rows they are equal.
"""

import threading
import time

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.algo import engine as jeng
from sptag_tpu_torch.algo import engine as teng
from sptag_tpu_torch.algo.scheduler import (BeamSlotScheduler,
                                            SchedulerStopped, gather_futures)
from test_torch_engine import _graph, _setup


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WALK_ARGS = dict(max_check=512, beam_width=16, nbp_limit=3,
                 dynamic_pivots=4)

# (corpus kind, BinnedTopK, BeamScoreDtype, BeamPackedNeighbors)
OPTIONS = [("l2", "off", "bf16", False), ("l2", "on", "bf16", False),
           ("l2", "off", "f32", True), ("l2", "on", "bf16", True),
           ("int8_cosine", "off", "bf16", False),
           ("int8_cosine", "on", "f32", True)]


@pytest.mark.parametrize("kind,binned,score,packed", OPTIONS,
                         ids=["-".join(map(str, o)) for o in OPTIONS])
def test_walk_options_equal_jax(kind, binned, score, packed):
    data, q, graph, pivots, deleted, metric, base = _setup(kind)
    kw = dict(score_dtype=score, packed_neighbors=packed,
              binned_topk=binned)
    j = jeng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               **kw)
    t = teng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               device="cpu", **kw)
    jd, ji = j.search(q, 10, **WALK_ARGS)
    td, ti = t.search(q, 10, **WALK_ARGS)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    bf16 = score == "bf16" and kind == "l2"     # integer corpora ignore it
    assert (t.data_score is not None) == bf16 == (j.data_score is not None)
    if packed:
        m = graph.shape[1]
        assert tuple(t.nbr_vecs.shape) == (len(data), m, data.shape[1])
        assert t.nbr_vecs.dtype == (torch.bfloat16 if bf16
                                    else t.data.dtype)
        assert "packed_neighbors" in t.device_bytes()


def test_bf16_walk_on_float_rows_overlaps_jax_and_reranks_exactly():
    rng = np.random.default_rng(5)
    n, d = 900, 12
    data = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((100, d)).astype(np.float32)
    graph = _graph(data, 16, 6, jsp.DistCalcMethod.L2)
    pivots = rng.choice(n, 300, replace=False).astype(np.int32)
    j = jeng.GraphSearchEngine(data, graph, pivots, None,
                               jsp.DistCalcMethod.L2, 1, score_dtype="bf16")
    t = teng.GraphSearchEngine(data, graph, pivots, None,
                               tsp.DistCalcMethod.L2, 1, score_dtype="bf16",
                               device="cpu")
    jd, ji = j.search(q, 10, **WALK_ARGS)
    td, ti = t.search(q, 10, **WALK_ARGS)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, ji)])
    assert overlap >= 0.9, overlap
    for row in range(len(q)):
        for vid in np.intersect1d(ti[row], ji[row]):
            np.testing.assert_allclose(td[row][ti[row] == vid],
                                       jd[row][ji[row] == vid], rtol=1e-5)
    # the re-rank: every returned distance is the float32 distance of its
    # id to the float32 query
    exact = ((q[:, None, :].astype(np.float64)
              - data[ti].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(td, exact, rtol=1e-5, atol=1e-5)


# (max_check, beam_width, nbp_limit, dynamic_pivots, BinnedTopK)
SEGMENTS = [(32, 4, 1, 0, "off"), (64, 8, 3, 4, "off"),
            (128, 4, 2, 0, "on")]


@pytest.mark.parametrize("mc,bw,nbp,dp,binned", SEGMENTS)
def test_segmented_walk_equals_monolithic_and_jax(mc, bw, nbp, dp, binned):
    data, q, graph, pivots, deleted, metric, base = _setup("l2", n=600)
    j = jeng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               binned_topk=binned)
    t = teng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               binned_topk=binned, device="cpu")
    kw = dict(max_check=mc, beam_width=bw, nbp_limit=nbp,
              dynamic_pivots=dp)
    jd, ji = j.search(q[:70], 5, **kw)
    d0, i0 = t.search(q[:70], 5, **kw)
    np.testing.assert_array_equal(i0, ji)
    for s in (1, 3):
        d1, i1 = t.search(q[:70], 5, segment_iters=s, **kw)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(d0, jd)


def test_segmented_seeded_walk_equals_jax():
    """KDT-style per-query seeds (duplicates and -1 pads) through the
    segments, against the JAX package's segmented walk."""
    data, q, graph, pivots, deleted, metric, base = _setup("l2", n=600)
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, len(data), (40, 6)).astype(np.int32)
    seeds[:, 3] = seeds[:, 0]
    seeds[0, 5] = -1
    j = jeng.GraphSearchEngine(data, graph, pivots, deleted, metric, base)
    t = teng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               device="cpu")
    kw = dict(max_check=64, beam_width=4, nbp_limit=2, seeds=seeds)
    jd, ji = j.search(q[:40], 5, segment_iters=2, **kw)
    td, ti = t.search(q[:40], 5, segment_iters=2, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(t.search(q[:40], 5, **kw)[1], ti)


# ---- the slot scheduler ------------------------------------------------------

D = 8
SETTINGS = [("DistCalcMethod", "L2"), ("TPTNumber", "2"),
            ("TPTLeafSize", "200"), ("CEF", "32"),
            ("MaxCheckForRefineGraph", "64"), ("NeighborhoodSize", "8"),
            ("BKTKmeansK", "8"), ("KDTNumber", "1"), ("MaxCheck", "128"),
            ("RefineIterations", "1"), ("SearchMode", "beam")]


def _rows(n, seed):
    """Integer-valued clustered rows (every distance exact)."""
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(99).standard_normal((16, D)) * 4.0
    return np.round((cent[rng.integers(0, 16, n)]
                     + rng.standard_normal((n, D))) * 2).astype(np.float32)


DATA = _rows(600, 1)
QUERIES = _rows(40, 2)


def _index(algo, data=DATA, extra=()):
    idx = tsp.create_instance(algo, "Float", device="cpu")
    other = "KDT" if algo == "BKT" else "BKT"
    for name, value in list(SETTINGS) + list(extra):
        if not name.startswith(other):
            assert idx.set_parameter(name, value), name
    assert idx.build(data) == tsp.ErrorCode.Success
    return idx


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """BKT and KDT folders built by the port; both packages load them."""
    out = {}
    for algo in ("BKT", "KDT"):
        idx = _index(algo)
        path = str(tmp_path_factory.mktemp(algo.lower()))
        assert idx.save_index(path) == tsp.ErrorCode.Success
        idx.close()
        out[algo] = path
    return out


def _scheduled(idx, slots="8", seg="2"):
    for name, value in [("ContinuousBatching", "1"), ("BeamSlots", slots),
                        ("BeamSegmentIters", seg)]:
        assert idx.set_parameter(name, value)


@pytest.mark.parametrize("algo", ["BKT", "KDT"])
def test_scheduler_matches_engine_search_and_jax(folders, algo):
    jidx = jsp.load_index(folders[algo])
    jd, ji = jidx.search_batch(QUERIES, 5, max_check=128)
    jidx.close()
    idx = tsp.load_index(folders[algo], device="cpu")
    d0, i0 = idx.search_batch(QUERIES, 5, max_check=128)
    np.testing.assert_array_equal(i0, ji)
    _scheduled(idx)
    try:
        d1, i1 = idx.search_batch(QUERIES, 5, max_check=128)
        futs = idx.submit_batch(QUERIES, 5, max_check=128)
        for row, f in enumerate(futs):
            fd, fi = f.result(timeout=60)
            np.testing.assert_array_equal(fi, i1[row])
            np.testing.assert_array_equal(fd, d1[row])
        stats = idx._scheduler.stats()
    finally:
        idx.close()
    np.testing.assert_array_equal(i1, ji)
    np.testing.assert_array_equal(d1, jd)
    assert stats["live"] == 0 and stats["pending"] == 0, stats
    assert stats["retired"] == 2 * len(QUERIES)
    # KDT pools its queries by their kd-seed width
    assert stats["pools"] == 1


def test_scheduler_hammer_mixed_maxcheck(folders):
    """Four submitters, mixed budgets: MaxCheck 8,192 and 16,384 share one
    pool (L and B agree, the budgets ride per row), 64 has its own.
    Every query is answered once with the monolithic walk's result and a
    drain leaves no slot occupied."""
    idx = tsp.load_index(folders["BKT"], device="cpu")
    budgets = (64, 8192, 16384)
    ref = {mc: idx.search_batch(QUERIES, 5, max_check=mc) for mc in budgets}
    eng = idx._get_engine()
    plans = {mc: eng.walk_plan(5, mc, 16, None, 3) for mc in budgets}
    assert plans[8192][:3] == plans[16384][:3] != plans[64][:3]
    _scheduled(idx, slots="8", seg="1")
    answers, errors = [], []
    lock = threading.Lock()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        for _ in range(10):
            qi = int(rng.integers(0, len(QUERIES)))
            mc = int(budgets[rng.integers(0, len(budgets))])
            try:
                res = idx.search(QUERIES[qi], 5, max_check=mc)
            except Exception as e:                       # noqa: BLE001
                errors.append(e)
                return
            with lock:
                answers.append((qi, mc, res.dists.copy(), res.ids.copy()))
    threads = [threading.Thread(target=submitter, args=(s,))
               for s in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(answers) == 40
        for qi, mc, d, ids in answers:
            np.testing.assert_array_equal(ids, ref[mc][1][qi])
            np.testing.assert_allclose(d, ref[mc][0][qi], rtol=1e-6)
        stats = idx._scheduler.stats()
    finally:
        idx.close()
    assert stats["live"] == 0 and stats["pending"] == 0, stats
    assert stats["pools"] == 2, stats


def test_scheduler_retire_drains_and_stop_fails_pending(folders):
    """retire() (the swap path) takes no new query and finishes those it
    has, and its worker exits; after stop() a submit raises
    SchedulerStopped and the worker is gone (test_stop_fails_queued_queries
    holds the queries pending at the stop)."""
    idx = tsp.load_index(folders["BKT"], device="cpu")
    try:
        eng = idx._get_engine()
        sched = BeamSlotScheduler(eng, slots=8, segment_iters=1)
        futs = [sched.submit(QUERIES[i], 5, 128) for i in range(12)]
        sched.retire()
        d, ids = gather_futures(futs, 5)
        np.testing.assert_array_equal(ids,
                                      eng.search(QUERIES[:12], 5, 128)[1])
        with pytest.raises(SchedulerStopped):
            sched.submit(QUERIES[0], 5, 128)
        sched._thread.join(timeout=30)
        assert not sched.alive

        sched = BeamSlotScheduler(eng, slots=8, segment_iters=1)
        sched.submit(QUERIES[0], 5, 64).result(timeout=60)
        sched.stop()
        with pytest.raises(SchedulerStopped):
            sched.submit(QUERIES[0], 5, 64)
        assert not sched.alive
    finally:
        idx.close()


def test_stop_fails_queued_queries():
    """Queries pending when the worker stops resolve with
    SchedulerStopped instead of blocking their callers."""
    data, q, graph, pivots, deleted, metric, base = _setup("l2", n=300,
                                                           pivots=100)
    eng = teng.GraphSearchEngine(data, graph, pivots, None, metric, base,
                                 device="cpu")
    sched = BeamSlotScheduler(eng, slots=8, segment_iters=1)
    gate = threading.Event()
    run_segment = eng.run_segment

    def slow_segment(*a, **kw):
        gate.wait(30)
        return run_segment(*a, **kw)
    eng.run_segment = slow_segment
    futs = [sched.submit(q[i], 5, 512) for i in range(20)]
    time.sleep(0.2)                     # the worker holds the first slots
    stopper = threading.Thread(target=sched.stop)
    stopper.start()
    time.sleep(0.2)
    gate.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    failed = [f for f in futs if f.exception(timeout=60) is not None]
    assert failed and all(isinstance(f.exception(), SchedulerStopped)
                          for f in failed)


def test_submit_batch_with_live_delta_shard(folders):
    """ContinuousBatching futures merge the delta shard's exact scan per
    query: the same rows as the JAX package's search_batch over the same
    folder and adds, and as the port's own synchronous path."""
    adds = _rows(30, 3) + 0.5
    extra = [("DeltaShardCapacity", "64"), ("AutoRefineThreshold", "0")]
    jidx = jsp.load_index(folders["BKT"])
    idx = tsp.load_index(folders["BKT"], device="cpu")
    try:
        for index in (jidx, idx):
            for name, value in extra:
                assert index.set_parameter(name, value)
            assert index.add(adds) == tsp.ErrorCode.Success
        assert idx._delta is not None and idx._delta.count == 30
        q = np.concatenate([QUERIES[:10], adds[:10]])
        jd, ji = jidx.search_batch(q, 5, max_check=128)
        sd, si = idx.search_batch(q, 5, max_check=128)
        _scheduled(idx)
        got = [f.result(timeout=60)
               for f in idx.submit_batch(q, 5, max_check=128)]
        ids = np.stack([g[1] for g in got])
        dists = np.stack([g[0] for g in got])
        np.testing.assert_array_equal(ids, ji)
        np.testing.assert_array_equal(ids, si)
        np.testing.assert_array_equal(dists, sd)
        assert (ids[10:, 0] == np.arange(600, 610)).all()  # the delta rows
    finally:
        idx.close()
        jidx.close()


def test_swap_retires_the_scheduler_with_queries_in_flight(folders):
    """A background swap (delta adds past AutoRefineThreshold) while
    scheduled queries are in flight: every future resolves, the old
    scheduler's worker exits, and the next query walks the new
    snapshot."""
    idx = tsp.load_index(folders["BKT"], device="cpu")
    _scheduled(idx, seg="1")
    for name, value in [("DeltaShardCapacity", "64"),
                        ("AutoRefineThreshold", "16")]:
        assert idx.set_parameter(name, value)
    try:
        futs = idx.submit_batch(QUERIES, 5, max_check=128)
        old = idx._scheduler
        adds = _rows(20, 4) + 0.25
        assert idx.add(adds) == tsp.ErrorCode.Success
        for f in futs:
            assert f.exception(timeout=60) is None
        deadline = time.time() + 60
        while idx.mutation_state()["swap_count"] == 0 \
                and time.time() < deadline:
            time.sleep(0.05)
        assert idx.mutation_state()["swap_count"] >= 1
        assert idx._scheduler is not old
        old._thread.join(timeout=30)
        assert not old.alive
        res = idx.search(adds[3], 5)
        assert res.ids[0] == 603
        assert idx._scheduler._engine.n == 620
    finally:
        idx.close()


@pytest.mark.parametrize("algo", ["BKT", "KDT"])
def test_submit_batch_moves_on_when_a_swap_retires_the_scheduler(folders,
                                                                 algo):
    """A swap that retires the scheduler in the middle of a submit_batch
    (here after its third query, as _auto_refine_job does: unpublish,
    then retire): the queries left go to the replacement, every future
    resolves with the monolithic walk's ids, and the old worker exits."""
    idx = tsp.load_index(folders[algo], device="cpu")
    try:
        _, want = idx.search_batch(QUERIES, 5, max_check=128)
        _scheduled(idx)
        old = idx._get_scheduler()
        submit, calls = old.submit, [0]

        def submit_then_swap(*a, **kw):
            calls[0] += 1                    # the fourth call is refused
            fut = submit(*a, **kw)
            if calls[0] == 3:
                with idx._lock:
                    idx._scheduler = None
                old.retire()
            return fut
        old.submit = submit_then_swap
        futs = idx.submit_batch(QUERIES, 5, max_check=128)
        got = np.stack([f.result(timeout=60)[1] for f in futs])
        np.testing.assert_array_equal(got, want)
        new = idx._scheduler
        assert new is not old and calls[0] == 4
        old._thread.join(timeout=30)
        assert not old.alive
        assert old.stats()["retired"] == 3
        assert new.stats()["retired"] == len(QUERIES) - 3
    finally:
        idx.close()


def test_submitters_racing_a_swap_get_no_errors(folders):
    """Submitter threads keep calling submit_batch while delta adds force
    a background swap: 0 errors, every future resolves, no slot leaks."""
    idx = tsp.load_index(folders["BKT"], device="cpu")
    _scheduled(idx, seg="1")
    for name, value in [("DeltaShardCapacity", "64"),
                        ("AutoRefineThreshold", "16")]:
        assert idx.set_parameter(name, value)
    errors, futs, stop = [], [], threading.Event()

    def submitter(t):
        lo = 0
        try:
            while not stop.is_set():
                futs.extend(idx.submit_batch(
                    QUERIES[t * 10 + lo:t * 10 + lo + 2], 5, max_check=128))
                lo = (lo + 2) % 10
        except Exception as e:                           # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    try:
        for t in threads:
            t.start()
        assert idx.add(_rows(20, 5) + 0.25) == tsp.ErrorCode.Success
        deadline = time.time() + 60
        while idx.mutation_state()["swap_count"] == 0 \
                and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert idx.mutation_state()["swap_count"] >= 1
        assert errors == []
        assert all(f.exception(timeout=60) is None for f in futs)
        st = idx._scheduler.stats()
        assert st["live"] == 0 and st["pending"] == 0
    finally:
        stop.set()
        idx.close()


def test_search_mode_ready_matches_jax(folders):
    """The readiness answers of both packages over the same folder, the
    same searches and the same add."""
    seen = []
    for pkg, kw in ((jsp, {}), (tsp, {"device": "cpu"})):
        idx = pkg.load_index(folders["BKT"], **kw)
        out = [idx.search_mode_ready(m) for m in ("beam", "dense", "auto")]
        idx.search_batch(QUERIES[:4], 5)
        out += [idx.search_mode_ready(m) for m in ("beam", "dense")]
        idx.search_batch(QUERIES[:4], 5, search_mode="dense")
        out.append(idx.search_mode_ready("dense", 64))
        idx.add(QUERIES[:2] + 0.5)
        out += [idx.search_mode_ready(m) for m in ("beam", "dense")]
        idx.set_parameter("BuildGraph", "0")
        out.append(idx.search_mode_ready("beam"))
        seen.append(out)
        idx.close()
    assert seen[1] == seen[0]
    assert seen[0][:2] == [True, False]
