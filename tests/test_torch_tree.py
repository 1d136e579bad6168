"""BKT forest and k-means of the PyTorch port.

The two packages draw different random numbers, so their trees differ;
what must hold is the forest's invariants and the file format, and the
deterministic k-means step must agree given the same centers.
"""

import io

import numpy as np
import pytest
import torch

from sptag_tpu.ops import kmeans as jkm
from sptag_tpu.trees.bktree import BKTree as JTree
from sptag_tpu_torch.ops import kmeans as tkm
from sptag_tpu_torch.trees.bktree import BKTree as TTree


def _corpus(n, d, seed, n_centers=12):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((n_centers, d)).astype(np.float32) * 4.0
    return (cent[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def _check_forest(tree, n, leaf_size):
    """Every id under each tree exactly once, sentinels, leaf sizes."""
    nodes = tree.nodes
    cid, cs, ce = nodes["centerid"], nodes["childStart"], nodes["childEnd"]
    starts = list(tree.tree_starts) + [len(nodes)]
    for t in range(len(tree.tree_starts)):
        lo, hi = starts[t], starts[t + 1]
        assert cid[lo] == n                       # root: the sample count
        assert cid[hi - 1] == -1                  # per-tree sentinel
        seen = []
        for ni in range(lo + 1, hi - 1):
            seen.append(int(cid[ni]))
            if cs[ni] >= 0 and ce[ni] - cs[ni] > 0:
                kids = range(cs[ni], ce[ni])
                if all(cs[c] == -1 and ce[c] == -1 for c in kids):
                    assert len(kids) <= leaf_size     # a leaf expansion
        assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("metric,base", [(0, 1), (1, 1)])
def test_port_forest_invariants(metric, base):
    data = _corpus(1500, 16, seed=1)
    if metric == 1:
        data /= np.linalg.norm(data, axis=1, keepdims=True)
    tree = TTree(tree_number=2, kmeans_k=8, leaf_size=8, metric=metric,
                 base=base, device="cpu")
    tree.build(data)
    assert len(tree.tree_starts) == 2
    _check_forest(tree, len(data), 8)


def test_duplicates_build_the_sample_center_map():
    data = np.repeat(_corpus(40, 8, seed=2), 10, axis=0)   # 10 copies each
    tree = TTree(kmeans_k=4, leaf_size=3, device="cpu")
    tree.build(data)
    _check_forest(tree, len(data), 3)
    assert tree.sample_center_map
    reloaded = TTree.from_arrays(tree.tree_starts, tree.nodes)
    assert reloaded.sample_center_map == tree.sample_center_map


def test_tree_bin_loads_in_both_packages():
    data = _corpus(1200, 16, seed=3)
    mine = TTree(kmeans_k=8, device="cpu")
    mine.build(data)
    buf = io.BytesIO()
    mine.save(buf)
    theirs = JTree.load(io.BytesIO(buf.getvalue()))
    np.testing.assert_array_equal(theirs.tree_starts, mine.tree_starts)
    np.testing.assert_array_equal(theirs.nodes, mine.nodes)

    jt = JTree(kmeans_k=8)
    jt.build(data)
    jbuf = io.BytesIO()
    jt.save(jbuf)
    back = TTree.load(io.BytesIO(jbuf.getvalue()))
    np.testing.assert_array_equal(back.nodes, jt.nodes)
    assert back.sample_center_map == jt.sample_center_map
    out = io.BytesIO()
    back.save(out)
    assert out.getvalue() == jbuf.getvalue()


@pytest.mark.parametrize("metric,base", [(0, 1), (1, 127)])
def test_kmeans_final_assign_matches_jax(metric, base):
    """Same batch and centers -> same labels, counts and medoids."""
    rng = np.random.default_rng(4)
    B, P, D, K = 3, 64, 16, 5
    data = rng.standard_normal((B, P, D)).astype(np.float32) * 10
    valid = np.ones((B, P), bool)
    valid[1, 50:] = False
    valid[2, 7:] = False
    centers = data[:, :K].copy()
    want = jkm.kmeans_final_assign(data, valid, centers, K, metric, base)
    got = tkm.kmeans_final_assign(torch.from_numpy(data),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(centers), K, metric, base)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kmeans_fit_balances_and_counts():
    """Lloyd with count balancing: every valid row counted once, no empty
    cluster on well-separated data, centers near the true means."""
    rng = np.random.default_rng(6)
    true = rng.standard_normal((4, 8)).astype(np.float32) * 20
    lab = rng.integers(0, 4, (2, 200))
    data = (true[lab] + rng.standard_normal((2, 200, 8))).astype(np.float32)
    valid = np.ones((2, 200), bool)
    valid[1, 150:] = False
    gen = torch.Generator().manual_seed(0)
    centers, counts = tkm.kmeans_fit(torch.from_numpy(data),
                                     torch.from_numpy(valid), gen, 4, 16, 3,
                                     0, 1)
    assert centers.shape == (2, 4, 8)
    assert counts.sum(1).tolist() == [200, 150]
    assert (counts > 0).all()
    dist = ((centers[0][:, None, :] - torch.from_numpy(true)[None]) ** 2
            ).sum(-1)
    assert dist.min(1).values.max().item() < 1.0
