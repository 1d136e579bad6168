"""The port's graph build (sptag_tpu_torch/graph/, ops/graph.py) against
the JAX package's.

Inputs are integer-valued float32 (or int8 normalized rows, also integers),
so every distance is exact whatever the summation order and only the tie
rules decide: ids must be equal.  The whole RNG build, given the same
exact search function, must give a bit-equal graph.
"""

import io

import numpy as np
import pytest
import torch

from sptag_tpu.graph import rng as jrng
from sptag_tpu.graph.tptree import tpt_partition as jtpt
from sptag_tpu.ops import graph as jgraph
from sptag_tpu.ops.distance import normalize
from sptag_tpu_torch.graph import rng as trng
from sptag_tpu_torch.graph.tptree import tpt_partition as ttpt
from sptag_tpu_torch.ops import graph as tgraph


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is several times faster here
    than a pool contended by the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(shape, seed, lo=-6, hi=7):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def test_tpt_partition_gives_the_same_leaves():
    data = np.random.default_rng(0).standard_normal((3000, 12)).astype(
        np.float32)
    for seed, leaf in ((1, 200), (2, 777), (3, 3000)):
        a = jtpt(data, leaf, 5, 500, np.random.default_rng([seed, 0]))
        b = ttpt(data, leaf, 5, 500, np.random.default_rng([seed, 0]))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("metric,base", [(0, 1), (1, 127)])
def test_leaf_allpairs_topk_matches_jax(metric, base):
    vecs = _ints((5, 40, 8), seed=metric)
    valid = np.random.default_rng(9).random((5, 40)) < 0.8
    valid[4] = False
    for C in (6, 39, 64):
        jp, jd = jgraph.leaf_allpairs_topk(vecs, valid, C, metric, base)
        tp, td = tgraph.leaf_allpairs_topk(torch.from_numpy(vecs),
                                           torch.from_numpy(valid), C,
                                           metric, base)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_merge_candidates_matches_jax():
    rng = np.random.default_rng(2)
    N, C = 64, 12
    a_ids = rng.integers(-1, 30, (N, C)).astype(np.int32)
    b_ids = rng.integers(-1, 30, (N, C)).astype(np.int32)
    a_d = rng.integers(0, 6, (N, C)).astype(np.float32)
    b_d = rng.integers(0, 6, (N, C)).astype(np.float32)
    a_d[a_ids < 0] = b_d[b_ids < 0] = np.float32(3.4e38)
    ji, jd = jgraph.merge_candidates(a_ids, a_d, b_ids, b_d)
    ti, td = tgraph.merge_candidates(*(torch.from_numpy(x) for x in
                                       (a_ids, a_d, b_ids, b_d)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("metric,base", [(0, 1), (1, 127)])
@pytest.mark.parametrize("m", [3, 8, 40])
def test_rng_select_and_node_dists_match_jax(metric, base, m):
    B, C, D = 24, 30, 6
    node = _ints((B, D), seed=3)
    cand = _ints((B, C, D), seed=4)
    d = np.asarray(jgraph.node_candidate_dists(node, cand, metric, base))
    td = tgraph.node_candidate_dists(torch.from_numpy(node),
                                     torch.from_numpy(cand), metric, base)
    np.testing.assert_array_equal(td.numpy(), d)
    order = np.argsort(d, axis=1, kind="stable")
    cand = np.take_along_axis(cand, order[..., None], axis=1)
    d = np.take_along_axis(d, order, axis=1)
    valid = np.random.default_rng(5).random((B, C)) < 0.85
    jk = jgraph.rng_select(node, cand, d, valid, m, metric, base)
    tk = tgraph.rng_select(torch.from_numpy(cand), torch.from_numpy(d),
                           torch.from_numpy(valid), m, metric, base)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def _exact_factory(data, metric, base):
    """A SearchFn factory over exact float64 distances (stable order)."""
    x = data.astype(np.float64)

    def factory(graph, final=False):
        def search(q, k):
            qd = q.astype(np.float64)
            if metric == 1:
                dd = base * base - qd @ x.T
            else:
                dd = (qd * qd).sum(1)[:, None] + (x * x).sum(1)[None] \
                    - 2 * qd @ x.T
            order = np.argsort(dd, axis=1, kind="stable")[:, :k]
            return (np.take_along_axis(dd, order, 1).astype(np.float32),
                    order.astype(np.int32))
        return search
    return factory


KW = dict(neighborhood_size=12, tpt_number=3, tpt_leaf_size=300, cef=48,
          tpt_samples=500)


@pytest.mark.parametrize("kind", ["l2", "int8_cosine", "guard_rollback"])
def test_rng_build_is_bit_equal(kind):
    rng = np.random.default_rng(7)
    if kind == "int8_cosine":
        data = normalize(rng.integers(-60, 60, (1200, 12)).astype(np.int8),
                         127)
        metric, base = 1, 127
    else:
        data = _ints((1200, 12), seed=8, lo=-4, hi=5)
        metric, base = 0, 1
    kw = dict(KW)
    factory = _exact_factory(data, metric, base)
    if kind == "guard_rollback":
        # a refine "search" that returns garbage rows: the guard must roll
        # the pass back in both packages
        def factory(graph, final=False):           # noqa: F811
            def search(q, k):
                ids = np.tile(np.arange(k, dtype=np.int32), (len(q), 1))
                return np.zeros((len(q), k), np.float32), ids
            return search
        kw["refine_accuracy_floor"] = 0.9
    a = jrng.RelativeNeighborhoodGraph(**kw)
    a.build(data, metric, base, factory)
    b = trng.RelativeNeighborhoodGraph(device="cpu", **kw)
    b.build(data, metric, base, factory)
    np.testing.assert_array_equal(b.graph, a.graph)
    passes = {"refine_pass_1"} if kind == "guard_rollback" \
        else {"refine_pass_1", "refine_pass_2"}
    assert set(b.stage_seconds) == {"tpt_candidates", "prune"} | passes
    truth_a = a.accuracy_truth(data, metric, base, width=12)
    truth_b = b.accuracy_truth(data, metric, base, width=12)
    for x, y in zip(truth_a, truth_b):
        np.testing.assert_array_equal(x, y)
    assert b.accuracy_estimation(data, metric, base, width=12) == \
        a.accuracy_estimation(data, metric, base, width=12)


def test_candidates_only_build_and_persistence():
    data = _ints((900, 10), seed=10)
    a = jrng.RelativeNeighborhoodGraph(**{**KW, "refine_iterations": 0})
    a.build(data, 0, 1, None)
    b = trng.RelativeNeighborhoodGraph(device="cpu",
                                       **{**KW, "refine_iterations": 0})
    b.build(data, 0, 1, None)
    np.testing.assert_array_equal(b.graph, a.graph)
    buf_a, buf_b = io.BytesIO(), io.BytesIO()
    a.save(buf_a)
    b.save(buf_b)
    assert buf_a.getvalue() == buf_b.getvalue()
    back = trng.RelativeNeighborhoodGraph.load(io.BytesIO(buf_a.getvalue()))
    np.testing.assert_array_equal(back.graph, a.graph)


def test_repair_connectivity_matches_jax():
    rng = np.random.default_rng(11)
    g = rng.integers(-1, 40, (60, 5)).astype(np.int32)
    g[:, 0] = rng.integers(0, 20, 60)           # rows 20.. mostly orphans
    a = jrng.RelativeNeighborhoodGraph(neighborhood_size=5)
    b = trng.RelativeNeighborhoodGraph(neighborhood_size=5)
    a.graph, b.graph = g.copy(), g.copy()
    a.repair_connectivity()
    b.repair_connectivity()
    np.testing.assert_array_equal(b.graph, a.graph)
