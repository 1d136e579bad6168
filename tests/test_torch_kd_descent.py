"""The kd forest's seed descent (ops/kd_descent.py, csrc/kd_descent.cu) and
the KDT walk seeded from it.

On the CPU the plain version must give, in every (query, tree) group, the
leaves `KDTree.collect_seeds` gives (the host numpy descent the JAX
package shares; only their order inside a group may differ), and exactly
the seeds and node reads of a scalar walk of the forest written below; an
engine seeded through the forest must return the ids of one seeded with
the host seeds; and a KDT index searched through `search_batch` is held
to the exact search of the benchmark's plain reference
(annbench/reference.py).  On the card (marker ``cuda``; this file imports
neither jax nor sptag_tpu, so on the card: ``python -m pytest
--noconftest -m cuda tests/test_torch_kd_descent.py``) the kernel must give
the plain version's seeds and reads exactly, the walk seeded on the card
the host-seeded walk's ids, eager and replayed, a single query's replay
must hold the descent, and the reads counter costs no sync of its own.
Rows are Gaussian floats, so no two bounds or distances tie.
"""

import os

import numpy as np
import pytest
import torch

import sptag_tpu_torch as tsp
from annbench import reference
from sptag_tpu_torch.algo import engine as teng
from sptag_tpu_torch.algo.kdt import KDTIndex
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import kd_descent as kd
from sptag_tpu_torch.trees.kdtree import KDTree
from sptag_tpu_torch.utils import metrics
from sptag_tpu_torch.utils import trace as ttrace


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kd_descent.py)")
    return torch.device("cuda")


def _rows(n, D, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:
        # heavy tails: the mean splits leave most rows on one side, and
        # some bounds overflow float32 (never chosen)
        return rng.pareto(0.3, (n, D)).astype(np.float32)
    cent = rng.standard_normal((max(n // 60, 1), D)) * 4.0
    return (cent[rng.integers(0, len(cent), n)]
            + rng.standard_normal((n, D))).astype(np.float32)


# rows, width, trees, queries, backtrack, skewed rows
CASES = {
    "one_tree": dict(n=1500, D=16, trees=1, Q=64, bt=8, skew=False),
    "two_trees": dict(n=1200, D=12, trees=2, Q=50, bt=5, skew=False),
    "backtrack_past_depth": dict(n=300, D=8, trees=1, Q=40, bt=200,
                                 skew=False),
    "one_query": dict(n=900, D=10, trees=2, Q=1, bt=16, skew=False),
    "skewed": dict(n=2000, D=6, trees=2, Q=60, bt=12, skew=True),
    "one_row": dict(n=1, D=5, trees=3, Q=7, bt=4, skew=False),
    "no_backtrack": dict(n=700, D=8, trees=2, Q=20, bt=0, skew=False),
}


def _forest(c, seed=0):
    data = _rows(c["n"], c["D"], seed, c["skew"])
    tree = KDTree(tree_number=c["trees"])
    tree.build(data)
    q = _rows(c["Q"], c["D"], seed + 1, c["skew"])
    return data, tree, q


def _scalar_descent(tree, q, backtrack):
    """One query's seeds and node reads, a plain walk of the records: the
    greedy leaf, then the `backtrack` lowest (bound, level) branches of
    its path with a finite bound descended greedily, then -1."""
    seeds, reads = [], 0

    def step(p):
        node = tree.nodes[p]
        diff = np.float32(q[int(node["split_dim"])] - node["split_value"])
        go_left = diff < 0
        best, other = ((node["left"], node["right"]) if go_left
                       else (node["right"], node["left"]))
        return int(best), int(other), np.float32(diff * diff)

    for root in tree.tree_starts:
        path, p = [], int(root)
        while p >= 0:
            p, other, bound = step(p)
            path.append((float(bound), len(path), other))
            reads += 1
        group = [-p - 1]
        for _, _, p in sorted(b for b in path
                              if np.isfinite(b[0]))[:backtrack]:
            while p >= 0:
                p = step(p)[0]
                reads += 1
            group.append(-p - 1)
        seeds += group + [-1] * (1 + backtrack - len(group))
    return seeds, reads


def _groups(seeds, trees, backtrack):
    """Each (query, tree) group's leaves, sorted."""
    g = np.asarray(seeds).reshape(len(seeds), trees, 1 + backtrack)
    return np.sort(g, axis=2)


def _plain(tree, q, backtrack, device="cpu"):
    reads = torch.zeros(1, dtype=torch.int64, device=device)
    out = kd.kd_seeds(torch.from_numpy(q).to(device),
                      torch.from_numpy(kd.forest_words(tree.nodes)).to(device),
                      torch.from_numpy(tree.tree_starts).to(device),
                      backtrack, reads=reads)
    return out.cpu().numpy(), int(reads.cpu()[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_descent_equals_collect_seeds_and_a_scalar_walk(case):
    c = CASES[case]
    _, tree, q = _forest(c)
    got, reads = _plain(tree, q, c["bt"])
    width = c["trees"] * (1 + c["bt"])
    assert got.shape == (c["Q"], width) and got.dtype == np.int64
    np.testing.assert_array_equal(
        _groups(got, c["trees"], c["bt"]),
        _groups(tree.collect_seeds(q, backtrack=c["bt"]), c["trees"],
                c["bt"]))
    want = [_scalar_descent(tree, row, c["bt"]) for row in q]
    np.testing.assert_array_equal(got, np.asarray([w[0] for w in want]))
    assert reads == sum(w[1] for w in want)
    if case == "skewed":
        # unbalanced: far deeper than a balanced tree of its rows
        depth = kd.forest_depth(kd.forest_words(tree.nodes),
                                tree.tree_starts)
        assert depth > 2.5 * np.log2(c["n"]), depth
    if case == "one_row":
        assert (got == 0).sum() == c["Q"] * c["trees"] * 2


def test_forest_words_and_depth():
    _, tree, _ = _forest(CASES["two_trees"])
    words = kd.forest_words(tree.nodes)
    assert words.dtype == np.int32 and words.shape == (tree.num_nodes, 4)
    np.testing.assert_array_equal(words[:, 0], tree.nodes["left"])
    np.testing.assert_array_equal(words[:, 3].view(np.float32),
                                  tree.nodes["split_value"])
    longest = max(len(p) for p in _paths(tree))
    assert kd.forest_depth(words, tree.tree_starts) == longest
    with pytest.raises(ValueError):
        kd.kd_seeds(torch.zeros((1, 12)), torch.from_numpy(words),
                    torch.from_numpy(tree.tree_starts), -1)


def _paths(tree):
    """Every root-to-leaf path's internal nodes."""
    out, stack = [], [(int(r), []) for r in tree.tree_starts]
    while stack:
        p, path = stack.pop()
        if p < 0:
            out.append(path)
            continue
        node = tree.nodes[p]
        stack += [(int(node["left"]), path + [p]),
                  (int(node["right"]), path + [p])]
    return out


def _engine(device, n=1500, D=16, trees=2, m=16, seed=3):
    data = _rows(n, D, seed)
    tree = KDTree(tree_number=trees)
    tree.build(data)
    rng = np.random.default_rng(seed)
    graph = rng.integers(0, n, (n, m)).astype(np.int32)
    graph[rng.random(graph.shape) < 0.1] = -1
    eng = teng.GraphSearchEngine(
        data, graph, rng.choice(n, 64, replace=False), None,
        DistCalcMethod.L2, 1, device=device,
        kd_forest=(tree.nodes, tree.tree_starts))
    return eng, tree, data


def test_engine_seeded_through_the_forest_equals_host_seeds():
    eng, tree, data = _engine("cpu")
    q = _rows(40, 16, 9)
    bt = 12
    host = tree.collect_seeds(q, backtrack=bt)
    want = eng.search(q, 10, max_check=512, seeds=host)
    _, reads = _plain(tree, q, bt)
    before = metrics.counter_value("search.kd_node_reads")
    ttrace.reset()
    got = eng.search(q, 10, max_check=512, kd_backtrack=bt)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert ttrace.report()["walk.kd_seeds"]["count"] == 1
    assert metrics.counter_value("search.kd_node_reads") - before == reads
    seg = eng.search(q, 10, max_check=512, kd_backtrack=bt, segment_iters=3)
    np.testing.assert_array_equal(seg[1], want[1])
    np.testing.assert_array_equal(seg[0], want[0])
    # host seeds win over the forest; an engine with no forest refuses
    again = eng.search(q, 10, max_check=512, seeds=host, kd_backtrack=bt)
    np.testing.assert_array_equal(again[1], want[1])
    bare = teng.GraphSearchEngine(data, eng.graph.numpy(), [0, 1], None,
                                  DistCalcMethod.L2, 1, device="cpu")
    with pytest.raises(ValueError):
        bare.search(q, 10, kd_backtrack=bt)
    parts = eng.device_bytes()
    assert parts["kd_forest"] == tree.num_nodes * 16 + 2 * 4 + 8


def test_reads_of_a_collected_engine_are_counted_once():
    eng, tree, _ = _engine("cpu", n=600)
    q = _rows(5, 16, 4)
    _, reads = _plain(tree, q, 6)
    before = metrics.counter_value("search.kd_node_reads")
    eng.search(q, 5, max_check=256, kd_backtrack=6)
    del eng
    import gc
    gc.collect()
    assert metrics.counter_value("search.kd_node_reads") - before == reads
    assert metrics.counter_value("search.kd_node_reads") - before == reads


KDT_SETTINGS = [("DistCalcMethod", "L2"), ("KDTNumber", "2"),
                ("TPTNumber", "2"), ("CEF", "64"),
                ("MaxCheckForRefineGraph", "128"),
                ("FinalRefineSearchMode", "same"), ("MaxCheck", "512")]


def _kdt_index(data, device="cpu"):
    idx = tsp.create_instance("KDT", "Float", device=device)
    for name, value in KDT_SETTINGS:
        assert idx.set_parameter(name, value)
    idx.build(data)
    return idx


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.RandomState(5)
    from annbench import data as adata
    x = adata.make_blobs(2300, 24, 23, 1.0, (-10.0, 10.0), rng)
    return x[:2000].astype(np.float32), x[2000:].astype(np.float32)


def test_kdt_index_search_batch_against_the_exact_reference(blobs):
    corpus, queries = blobs
    idx = _kdt_index(corpus)
    d, ids = idx.search_batch(queries, 10, search_mode="beam")
    x = reference.prepare(corpus, "L2", torch.device("cpu"))
    q = reference.prepare(queries, "L2", torch.device("cpu"))
    _, truth = reference.exact_topk(x, q, 10, "L2")
    assert (ids >= 0).all()
    exact, scale = reference.pair_distances(
        q, x[torch.from_numpy(ids.astype(np.int64))], "L2")
    gap = float(((torch.from_numpy(d).double() - exact).abs()
                 / scale).max())
    # float32 distances of an expanded form are off by a few float32
    # roundings of their terms' scale (a few 1e-7); TF32 products read
    # some 1e-4, so 1e-5 (the benchmark's dist_gap limit) separates them
    assert gap <= 1e-5, gap
    hits = (torch.from_numpy(ids.astype(np.int64))[:, :, None]
            == truth[:, None, :]).any(-1).float().mean()
    # MaxCheck 512 over 2,000 rows in 23 blobs: the walk reads a quarter
    # of the corpus (1.0 measured; 0.993 even at MaxCheck 32); rows far
    # from the query, as a walk that never left wrong seeds returns, read
    # near 0
    assert float(hits) >= 0.95, float(hits)
    idx.close()


def test_kdt_index_forest_seeded_equals_host_seeded(blobs, monkeypatch):
    """The index's card path (the forest on the engine, `kd_backtrack`),
    run on the CPU's plain version, returns the host-seeded ids; the CPU
    index itself seeds on the host and holds no forest."""
    corpus, queries = blobs
    idx = _kdt_index(corpus)
    want = idx.search_batch(queries, 10, search_mode="beam")
    eng = idx._get_engine()
    assert eng.kd_nodes is None and "kd_forest" not in eng.device_bytes()
    assert idx._kd_backtrack(eng, 512) == 0
    monkeypatch.setattr(KDTIndex, "_kd_forest", lambda self: (
        self._tree.nodes, self._tree.tree_starts))
    monkeypatch.setattr(KDTIndex, "_walk_seeds", lambda *a: pytest.fail(
        "the host descent ran"))
    idx._dirty = True                       # a new snapshot, with the forest
    eng = idx._get_engine()
    assert eng.kd_nodes is not None and eng.kd_depth > 0
    assert idx._kd_backtrack(eng, 512) == idx._backtrack_for(512)
    ttrace.reset()
    got = idx.search_batch(queries, 10, search_mode="beam")
    assert ttrace.report()["walk.kd_seeds"]["count"] == 1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    idx.close()


# ---- the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["many_queries"])
def test_kernel_equals_the_plain_version_on_card(cuda, case):
    c = CASES.get(case) or dict(n=20000, D=100, trees=2, Q=3000, bt=64,
                                skew=False)
    _, tree, q = _forest(c)
    kd.reset_launch_counts()
    got, reads = _plain(tree, q, c["bt"], device=cuda)
    assert kd.launch_counts()["kd_descent"] == 1
    want, want_reads = _plain(tree, q, c["bt"])
    np.testing.assert_array_equal(got, want)
    assert reads == want_reads


@pytest.mark.cuda
def test_card_seeded_walk_equals_host_seeded_eager_and_replayed(
        cuda, monkeypatch):
    eng, tree, _ = _engine(cuda, n=6000, D=32, trees=2, m=24)
    bt = 16
    for nq in (300, 5):             # eager (past _GRAPH_MAX_Q), replayed
        q = _rows(nq, 32, 11)
        want = eng.search(q, 10, max_check=1024,
                          seeds=tree.collect_seeds(q, backtrack=bt))
        teng.reset_graph_stats()
        for _ in range(3):          # eager, capture and replay, replay
            got = eng.search(q, 10, max_check=1024, kd_backtrack=bt)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
        replays = teng.graph_stats().get(str(cuda), {}).get("walk_replays",
                                                             0)
        assert replays == (0 if nq > teng._GRAPH_MAX_Q else 2)
    monkeypatch.setattr(teng, "_GRAPH_MAX_Q", 0)      # the eager walk
    got = eng.search(q, 10, max_check=1024, kd_backtrack=bt)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_single_query_replay_holds_the_descent_and_counts_reads(cuda):
    import torch.profiler as tp

    # the session tears CUPTI down at its end, so later sessions of the
    # process see the card's kernels (utils/trace.py)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    eng, tree, _ = _engine(cuda, n=6000, D=32, trees=1, m=24)
    q = _rows(1, 32, 12)
    for _ in range(2):              # the key's eager walk, then capture
        eng.search(q, 10, max_check=1024, kd_backtrack=32)
    # count every read of the card's accumulator by the registry
    calls = []
    sources = [s for s in metrics._sources.values()
               if s[0] == "search.kd_node_reads"]
    assert sources
    for s in sources:
        s[1] = (lambda read: lambda: calls.append(1) or read())(s[1])
    teng.reset_graph_stats()
    kd.reset_launch_counts()
    with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eng.search(q, 10, max_check=1024, kd_backtrack=32)
        torch.cuda.synchronize()
    assert teng.graph_stats()[str(cuda)]["walk_replays"] == 5
    assert kd.launch_counts()["kd_descent"] == 0       # none from the host
    assert calls == []                                 # no read a search
    names = [e.name for e in prof.events()]
    assert any("kd_descent_kernel" in n for n in names), set(names)
    # the first call's eager walk of its one row, then the bucket of 4
    # rows the graph pads it to (copies of the row): the capture's
    # warm-up and six replays
    _, per_row = _plain(tree, q, 32)
    total = int(eng.kd_reads.cpu()[0])
    assert total == (1 + 4 * 7) * per_row
    assert metrics.counter_value("search.kd_node_reads") >= total
    assert calls
