"""The port's beam walk (sptag_tpu_torch/algo/engine.py) against the JAX
package's GraphSearchEngine, given the same data, graph, pivots and
tombstones.

The corpus is integer-valued (float32 L2) or int8 rows (cosine), so every
distance is exact in both packages and only the tie rules decide the
trajectories: ids and distances must be equal, for the exact walk and the
binned one, with no-better-propagation stops, spare-pivot injection, k > n
padding and several chunks (``_VISITED_BUDGET`` shrunk in both packages).
"""

import numpy as np
import pytest
import torch

from sptag_tpu.algo import engine as jeng
from sptag_tpu.core.types import DistCalcMethod
from sptag_tpu.ops.distance import normalize
from sptag_tpu_torch.algo import engine as teng


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread is several times faster here
    than a pool contended by the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(data, m, seed, metric):
    """A deliberately weak graph: each row's m//2 nearest plus random
    edges, some slots empty."""
    rng = np.random.default_rng(seed)
    x = data.astype(np.float64)
    if metric == DistCalcMethod.Cosine:
        d = -(x @ x.T)
    else:
        d = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    near = np.argsort(d, axis=1, kind="stable")[:, :m // 2]
    rand = rng.integers(0, len(data), (len(data), m - m // 2))
    g = np.concatenate([near, rand], axis=1).astype(np.int32)
    g[rng.random(g.shape) < 0.1] = -1
    return g


def _setup(kind, n=900, d=12, seed=0, pivots=500):
    rng = np.random.default_rng(seed)
    if kind == "int8_cosine":
        data = normalize(rng.integers(-50, 50, (n, d)).astype(np.int8), 127)
        q = normalize(rng.integers(-50, 50, (200, d)).astype(np.int8), 127)
        metric, base = DistCalcMethod.Cosine, 127
    else:
        data = rng.integers(-3, 4, (n, d)).astype(np.float32)
        q = rng.integers(-3, 4, (200, d)).astype(np.float32)
        metric, base = DistCalcMethod.L2, 1
    graph = _graph(data, 16, seed + 1, metric)
    pivots = rng.choice(n, pivots, replace=False).astype(np.int32)
    deleted = rng.random(n) < 0.05
    return data, q, graph, pivots, deleted, metric, base


def _engines(data, graph, pivots, deleted, metric, base, binned,
             target=0.99):
    j = jeng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               binned_topk=binned, recall_target=target)
    t = teng.GraphSearchEngine(data, graph, pivots, deleted, metric, base,
                               binned_topk=binned, recall_target=target,
                               device="cpu")
    return j, t


# (k, max_check, beam_width, nbp_limit, dynamic_pivots, recall target)
CASES = {
    "default": (10, 512, 16, 3, 4, 0.99),
    # the nbp counter trips with no spares to re-seed from
    "nbp_trips_no_spares": (10, 256, 16, 1, 0, 0.99),
    # L = 72 over 1,100 pivots: binned seeding keeps 216 spares, and a 0.5
    # target bins the finalize too
    "small_budget_binned_seed": (5, 64, 16, 2, 4, 0.5),
    "wide_k": (40, 512, 8, 3, 2, 0.99),
}
WALKS = [("l2", "off", "default"), ("l2", "on", "default"),
         ("int8_cosine", "off", "default"), ("int8_cosine", "on", "default"),
         ("l2", "off", "nbp_trips_no_spares"),
         ("l2", "on", "small_budget_binned_seed"),
         ("int8_cosine", "off", "wide_k"), ("int8_cosine", "on", "wide_k")]


@pytest.mark.parametrize("kind,binned,case", WALKS,
                         ids=["-".join(w) for w in WALKS])
def test_walk_ids_equal_jax(kind, binned, case):
    if case == "small_budget_binned_seed":
        data, q, graph, pivots, deleted, metric, base = _setup(
            kind, n=1200, pivots=1100)
    else:
        data, q, graph, pivots, deleted, metric, base = _setup(kind)
    k, mc, bw, nbp, dyn, target = CASES[case]
    j, t = _engines(data, graph, pivots, deleted, metric, base, binned,
                    target)
    kw = dict(max_check=mc, beam_width=bw, nbp_limit=nbp,
              dynamic_pivots=dyn)
    jd, ji = j.search(q, k, **kw)
    td, ti = t.search(q, k, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert not deleted[ti[ti >= 0]].any()
    plan = t.walk_plan(k, mc, bw, None, nbp)
    assert plan == j.walk_plan(k, mc, bw, None, nbp)
    L, B = plan[1], plan[2]
    assert t.merge_bins_for(L, B) == j.merge_bins_for(L, B)
    assert t.seed_keep_for(L) == j.seed_keep_for(L)
    assert t.finalize_bins_for(plan[0], L) == j.finalize_bins_for(plan[0], L)
    if binned == "on":
        assert t.merge_bins_for(L, B) > 0
    if case == "small_budget_binned_seed":
        assert t.seed_keep_for(L) > 0 and t.finalize_bins_for(k, L) > 0
    assert 0 < t.last_iterations <= plan[3]


@pytest.mark.parametrize("binned", ["off", "on"])
def test_several_chunks_equal_one(monkeypatch, binned):
    data, q, graph, pivots, deleted, metric, base = _setup("l2", seed=3)
    monkeypatch.setattr(jeng, "_VISITED_BUDGET", 112 * 60)
    monkeypatch.setattr(teng, "_VISITED_BUDGET", 112 * 60)
    j, t = _engines(data, graph, pivots, deleted, metric, base, binned)
    assert t.chunk_size() == j.chunk_size() == 60         # 200 queries: 4
    jd, ji = j.search(q, 10, max_check=256)
    td, ti = t.search(q, 10, max_check=256)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    monkeypatch.setattr(teng, "_VISITED_BUDGET", 1 << 29)
    whole = teng.GraphSearchEngine(data, graph, pivots, deleted, metric,
                                   base, binned_topk=binned, device="cpu")
    np.testing.assert_array_equal(whole.search(q, 10, max_check=256)[1], ti)


def test_k_beyond_corpus_pads_and_exact_scan():
    data, q, graph, pivots, deleted, metric, base = _setup("l2", n=60,
                                                           pivots=20)
    graph = _graph(data, 8, 5, metric)
    j, t = _engines(data, graph, pivots, deleted[:60], metric, base, "off")
    jd, ji = j.search(q[:7], 80, max_check=128)
    td, ti = t.search(q[:7], 80, max_check=128)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    assert (ti[:, 60:] == -1).all()
    jd, ji = j.exact_scan(q[:7], 12)
    td, ti = t.exact_scan(q[:7], 12)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


# (kind, binned, seeds per query, k, max_check): duplicates, -1 padding
# and fewer seeds than the pool
SEEDED = [("l2", "off", 24, 10, 512), ("l2", "on", 24, 10, 512),
          ("int8_cosine", "off", 40, 5, 256), ("l2", "off", 6, 10, 512)]


@pytest.mark.parametrize("kind,binned,S,k,mc", SEEDED)
def test_seeded_walk_ids_equal_jax(kind, binned, S, k, mc):
    """The seeded walk (KDT's per-query seeds): de-duplicated, premarked
    visited, scored in one contraction, no spares; ids and distances equal
    to the JAX package's."""
    data, q, graph, pivots, deleted, metric, base = _setup(kind)
    rng = np.random.default_rng(9)
    seeds = rng.integers(-1, len(data), (len(q), S)).astype(np.int32)
    seeds[:, 1] = seeds[:, 0]                    # a seed reached twice
    j, t = _engines(data, graph, pivots, deleted, metric, base, binned)
    jd, ji = j.search(q, k, max_check=mc, seeds=seeds)
    td, ti = t.search(q, k, max_check=mc, seeds=seeds)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    # the seeds are the walk's start: searching from every row's own
    # seed set finds the row itself
    own = np.full((len(q), 2), -1, np.int32)
    own[:, 0] = np.arange(len(q))
    _, ids = t.search(data[:len(q)], 1, max_check=mc, seeds=own)
    assert (ids[~deleted[:len(q)], 0] == np.arange(len(q))[
        ~deleted[:len(q)]]).all()


def test_not_ported_options_raise():
    """Every walk option runs now, the cascade included: on both tiers
    its walk returns the JAX package's ids (its distances within float32),
    and its host tier runs segmented; the bf16 shadow, packed neighbours
    and the segmented walk run (their parity is
    tests/test_torch_scheduler.py's)."""
    data, q, graph, pivots, deleted, metric, base = _setup("l2", n=100,
                                                           pivots=50)
    for tier in ("device", "host", "host_all"):
        j = jeng.GraphSearchEngine(data, graph, pivots, deleted, metric,
                                   base, cascade_search=True,
                                   corpus_tier=tier)
        c = teng.GraphSearchEngine(data, graph, pivots, deleted, metric,
                                   base, device="cpu", cascade_search=True,
                                   corpus_tier=tier)
        assert c.score_scale == j.score_scale > 0
        assert (c.fp_host is None) == (tier == "device")
        jd, ji = j.search(q[:8], 3)
        cd, ci = c.search(q[:8], 3)
        np.testing.assert_array_equal(ci, ji)
        np.testing.assert_allclose(cd, jd, rtol=1e-5, atol=1e-4)
    t = teng.GraphSearchEngine(data, graph, pivots, None, metric, base,
                               device="cpu")
    want = t.search(q[:2], 3)
    for kw in ({"score_dtype": "bf16"}, {"packed_neighbors": True}):
        got = teng.GraphSearchEngine(data, graph, pivots, None, metric,
                                     base, device="cpu", **kw).search(q[:2],
                                                                      3)
        np.testing.assert_array_equal(got[1], want[1])
    got = t.search(q[:2], 3, segment_iters=2)
    np.testing.assert_array_equal(got[1], want[1])
