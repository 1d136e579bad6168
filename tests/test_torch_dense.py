"""Dense search of the PyTorch port against the JAX package, on the same
block layout.

The JAX side builds the layout (``DenseTreeSearcher.build_layout``); the
port takes it through ``from_layout`` and both search the same queries.
The JAX side runs as its own tests run it on the CPU (the XLA path), the
port with ``device="cpu"`` (the plain versions of its kernels).

Tolerances: int8 cosine distances are exact integers, so ids and distances
must be equal.  Float32: distances within rtol 1e-5 (atol 1e-4 for values
near 0, where the ``|q|^2 + |x|^2 - 2 q.x`` expansion cancels), and ids
equal at every rank whose JAX distance is more than 1e-5 relative away
from both neighbouring ranks — XLA:CPU and torch sum the matrix products
in different orders, so nearer distances may swap.
"""

import numpy as np
import pytest
import torch

from sptag_tpu.algo import dense as jdense
from sptag_tpu.core.types import DistCalcMethod
from sptag_tpu.ops.distance import normalize
from sptag_tpu_torch.algo import dense as tdense
from sptag_tpu_torch.ops import block_dots

RTOL = 1e-5


def assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=False):
    """Compare (Q, k) results under the module docstring's rule."""
    d_ref, d_got = np.asarray(d_ref), np.asarray(d_got)
    i_ref, i_got = np.asarray(i_ref), np.asarray(i_got)
    assert d_ref.shape == d_got.shape and i_ref.shape == i_got.shape
    if exact:
        np.testing.assert_array_equal(i_got, i_ref)
        np.testing.assert_array_equal(d_got, d_ref)
        return
    np.testing.assert_allclose(d_got, d_ref, rtol=RTOL, atol=1e-4)
    scale = np.maximum(np.abs(d_ref), 1e-30)
    gap = np.abs(np.diff(d_ref, axis=1)) > RTOL * scale[:, 1:]
    sep = np.ones_like(d_ref, dtype=bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert sep.mean() > 0.9, "too few separated ranks to compare"
    np.testing.assert_array_equal(i_got[sep], i_ref[sep])


def _corpus(n, d, nq, n_centers, seed, int8=False):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((n_centers, d)).astype(np.float32) * 3.0
    lab = rng.integers(0, n_centers, n)
    data = cent[lab] + rng.standard_normal((n, d)).astype(np.float32)
    q = (cent[rng.integers(0, n_centers, nq)]
         + rng.standard_normal((nq, d)).astype(np.float32))
    clusters = [np.flatnonzero(lab == c) for c in range(n_centers)]
    if int8:
        data = normalize(np.clip(np.round(data * 10), -127, 127)
                         .astype(np.int8), 127)
        q = normalize(np.clip(np.round(q * 10), -127, 127)
                      .astype(np.int8), 127)
    return data, q, clusters


# (value type, metric, base, d): float32 L2 and int8 cosine, each with a
# block count (32) that lets int8 grouping run at its floor of 32
CASES = {
    "f32_l2": (False, DistCalcMethod.L2, 1, 16),
    "i8_cos": (True, DistCalcMethod.Cosine, 127, 16),
    "f32_l2_d128": (False, DistCalcMethod.L2, 1, 128),
}


@pytest.mark.parametrize("case,group,replicas,tombstones", [
    ("f32_l2", 0, 1, False),
    ("f32_l2", 8, 1, True),
    ("f32_l2", 0, 2, True),
    ("f32_l2", 8, 2, False),
    ("i8_cos", 0, 1, True),
    ("i8_cos", 32, 1, False),
    ("i8_cos", 32, 2, True),
    ("i8_cos", 0, 2, False),
    ("f32_l2_d128", 8, 1, False),
])
def test_from_layout_matches_jax(case, group, replicas, tombstones):
    int8, metric, base, d = CASES[case]
    data, q, clusters = _corpus(2048, d, 256, 32, seed=3, int8=int8)
    n = data.shape[0]
    deleted = np.zeros(n, bool)
    if tombstones:
        deleted[np.random.default_rng(9).choice(n, n // 10, replace=False)] \
            = True
    lay = jdense.DenseTreeSearcher.build_layout(data, clusters, metric,
                                                replicas)
    ref = jdense.DenseTreeSearcher(data, np.zeros(len(clusters), np.int64),
                                   clusters, deleted, metric, base,
                                   replicas=replicas)
    got = tdense.DenseTreeSearcher.from_layout(lay, deleted, metric, base,
                                               replicas, device="cpu")
    assert got.cluster_size == ref.cluster_size
    assert got.num_clusters == ref.num_clusters == 32
    max_check = 8 * got.cluster_size
    d_ref, i_ref = ref.search(q, 10, max_check=max_check, group=group,
                              union_factor=4)
    d_got, i_got = got.search(q, 10, max_check=max_check, group=group,
                              union_factor=4)
    assert got.last_effective_group == ref.last_effective_group == group
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=int8)
    assert not deleted[i_got[i_got >= 0]].any()


@pytest.mark.parametrize("case,group,nq,nprobe,chunk", [
    ("f32_l2", 0, 200, 4, 64),
    ("f32_l2", 8, 200, 4, 64),
    ("i8_cos", 0, 200, 4, 64),
    ("i8_cos", 32, 256, 8, 96),
])
def test_multi_chunk_matches_jax(monkeypatch, case, group, nq, nprobe,
                                 chunk):
    """Patch the gather budget in both packages so a batch splits into
    `chunk`-query chunks, the last one padded (the JAX side runs its
    lax.map chunk program)."""
    int8, metric, base, d = CASES[case]
    data, q, clusters = _corpus(2048, d, nq, 32, seed=5, int8=int8)
    lay = jdense.DenseTreeSearcher.build_layout(data, clusters, metric, 1)
    ref = jdense.DenseTreeSearcher(data, np.zeros(32, np.int64), clusters,
                                   None, metric, base)
    got = tdense.DenseTreeSearcher.from_layout(lay, None, metric, base,
                                               device="cpu")
    P = got.cluster_size
    U = min(4 * nprobe, 32)
    bytes_q = ((U * P * d * 4 + group - 1) // group if group
               else nprobe * P * d * 4)
    budget = chunk * bytes_q
    monkeypatch.setattr(jdense, "_GATHER_BUDGET", budget)
    monkeypatch.setattr(tdense, "_GATHER_BUDGET", budget)
    d_ref, i_ref = ref.search(q, 10, max_check=nprobe * P, group=group,
                              union_factor=4)
    d_got, i_got = got.search(q, 10, max_check=nprobe * P, group=group,
                              union_factor=4)
    assert got.last_effective_group == ref.last_effective_group == group
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=int8)


@pytest.mark.parametrize("case,group,binned,target", [
    ("f32_l2", 0, "on", 0.5),
    ("f32_l2", 8, "auto", 0.9),
    ("i8_cos", 0, "auto", 0.5),
    ("i8_cos", 32, "on", 0.9),
])
def test_binned_epilogue_matches_jax(monkeypatch, case, group, binned,
                                     target):
    """BinnedTopK routes the final select through the bin reduction at the
    recall-target size in both packages (ops/topk_bins.py)."""
    from sptag_tpu_torch.ops import topk_bins

    bins_used = []
    real = topk_bins.binned_topk
    monkeypatch.setattr(topk_bins, "binned_topk",
                        lambda d, k, bins: bins_used.append(bins)
                        or real(d, k, bins))
    int8, metric, base, d = CASES[case]
    data, q, clusters = _corpus(2048, d, 256, 32, seed=13, int8=int8)
    lay = jdense.DenseTreeSearcher.build_layout(data, clusters, metric, 1)
    ref = jdense.DenseTreeSearcher(data, np.zeros(32, np.int64), clusters,
                                   None, metric, base)
    got = tdense.DenseTreeSearcher.from_layout(lay, None, metric, base,
                                               device="cpu")
    kw = dict(max_check=8 * got.cluster_size, group=group, union_factor=4,
              binned=binned, recall_target=target)
    d_ref, i_ref = ref.search(q, 10, **kw)
    d_got, i_got = got.search(q, 10, **kw)
    assert bins_used and got.last_effective_group == group
    assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=int8)


def test_grouped_demotion_rules_match_jax():
    """Sparse and tiny batches demote grouping in both packages alike."""
    data, q, clusters = _corpus(2048, 16, 256, 32, seed=7, int8=True)
    lay = jdense.DenseTreeSearcher.build_layout(
        data, clusters, DistCalcMethod.Cosine, 1)
    ref = jdense.DenseTreeSearcher(data, np.zeros(32, np.int64), clusters,
                                   None, DistCalcMethod.Cosine, 127)
    got = tdense.DenseTreeSearcher.from_layout(
        lay, None, DistCalcMethod.Cosine, 127, device="cpu")
    for nq, group in [(20, 32), (100, 32), (256, 64)]:
        d_ref, i_ref = ref.search(q[:nq], 5, max_check=512, group=group,
                                  union_factor=4)
        d_got, i_got = got.search(q[:nq], 5, max_check=512, group=group,
                                  union_factor=4)
        assert got.last_effective_group == ref.last_effective_group
        assert_same_neighbors(d_ref, i_ref, d_got, i_got, exact=True)


def test_finalize_topk_tie_rule_and_dedup():
    """All-equal distances keep the lowest positions; repeated ids keep
    their first occurrence only."""
    nd = torch.zeros((2, 6))
    ids = torch.tensor([[5, 3, 5, 1, -1, 3], [0, 1, 2, 3, 4, 5]],
                       dtype=torch.int32)
    deleted = torch.zeros(6, dtype=torch.bool)
    d, out = tdense._finalize_topk(nd, ids, deleted, True, 4)
    assert out.tolist() == [[5, 3, 1, -1], [0, 1, 2, 3]]
    assert d[0, 3].item() == np.float32(3.4e38)


def test_partition_and_layout_match_jax():
    """The tree cut and the layout built by the port equal the JAX
    package's on the same (JAX-built) tree."""
    from sptag_tpu.trees.bktree import BKTree as JTree
    from sptag_tpu_torch.trees.bktree import BKTree as TTree

    data, _, _ = _corpus(1500, 16, 1, 12, seed=11)
    jt = JTree(kmeans_k=8)
    jt.build(data)
    tt = TTree.from_arrays(jt.tree_starts, jt.nodes)
    jc, jcl = jdense.partition_from_tree(jt, len(data), 128)
    tc, tcl = tdense.partition_from_tree(tt, len(data), 128)
    np.testing.assert_array_equal(tc, jc)
    assert len(tcl) == len(jcl)
    for a, b in zip(tcl, jcl):
        np.testing.assert_array_equal(a, b)
    for replicas in (1, 2):
        jl = jdense.DenseTreeSearcher.build_layout(
            data, jcl, DistCalcMethod.L2, replicas)
        tl = tdense.DenseTreeSearcher.build_layout(
            data, tcl, DistCalcMethod.L2, replicas, device="cpu")
        for key in ("perm", "ids", "sq", "cent", "cent_sq"):
            np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
        assert tl["cluster_size"] == jl["cluster_size"]


def test_probe_kernel_path_is_taken_for_f32_and_int8(monkeypatch):
    """The dense search hands float32 and int8 blocks to the block-dot
    wrappers (which use the plain version on the CPU)."""
    calls = []
    real = block_dots.probe_block_dots

    def spy(blocks, queries, topc):
        calls.append(blocks.dtype)
        return real(blocks, queries, topc)

    monkeypatch.setattr(block_dots, "probe_block_dots", spy)
    for int8, metric, base in [(False, DistCalcMethod.L2, 1),
                               (True, DistCalcMethod.Cosine, 127)]:
        data, q, clusters = _corpus(600, 16, 8, 6, seed=2, int8=int8)
        s = tdense.DenseTreeSearcher(data, clusters, None, metric, base,
                                     device="cpu")
        s.search(q, 3, max_check=64)
    assert calls == [torch.float32, torch.int8]
    assert block_dots.launch_counts()["probe_block_dots_f32"] == 0
