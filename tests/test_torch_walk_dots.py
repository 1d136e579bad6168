"""The walk's fixed-order distances (ops/walk_dots.py) on the CPU.

On the card they are the two kernels of csrc/walk_dots.cu (tests/
test_torch_cuda.py holds them against these plain versions and shows
their bits do not depend on the batch).  On the CPU `walk_distance` must
compute exactly what the walk computed before the kernels fused the
epilogue (``ops/distance.py``'s formulas over rows gathered with the
masked slots pointing at row 0, norms in output order, then the masked
slots set to MAX_DIST), so the port's walk keeps the JAX package's
results there: the plain fused version is checked for equality
(``torch.equal``) with that unfused formula, in every mode, metric, D and
dtype, and against the JAX package's distance functions on the same
seeded numpy inputs within float32 tolerance (rtol 1e-5, atol 1e-3: the
matrix products sum in different orders, and the expanded L2 form
cancels near 0, as tests/test_torch_distance.py states).
"""

import numpy as np
import pytest
import torch

from sptag_tpu.core.types import DistCalcMethod as JMethod
from sptag_tpu.ops import distance as JD
from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import walk_dots as wd

MODES = {"gather": wd.GATHER, "rows": wd.ROWS, "shared": wd.SHARED}
METRICS = [DistCalcMethod.L2, DistCalcMethod.Cosine]


def _inputs(dtype, D=24, seed=0, Q=9, N=70, C=13):
    """Queries, rows, (Q, C) ids with about a third of the slots -1."""
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        q = rng.standard_normal((Q, D)).astype(np.float32)
        x = rng.standard_normal((N, D)).astype(np.float32)
    else:
        q = rng.integers(-128, 128, (Q, D)).astype(np.int8)
        x = rng.integers(-128, 128, (N, D)).astype(np.int8)
    idx = rng.integers(0, N, (Q, C))
    idx[rng.random((Q, C)) < 0.3] = -1
    return torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx)


def _former(q, x, idx, metric, base, mode, sq_table):
    """The walk's unfused formula before the kernels: masked slots score
    row 0 with its norm, then become MAX_DIST."""
    if mode == wd.SHARED:
        return dist_ops.pairwise_distance(q, x, metric)
    fresh = idx >= 0
    gather_idx = torch.where(fresh, idx, 0)
    nd = dist_ops.batched_gathered_distance(q, x[gather_idx], metric, base,
                                            sq_table[gather_idx])
    return torch.where(fresh, nd, wd.MAX_DIST)


def _fused(q, x, idx, metric, base, mode, sq_table):
    """`walk_distance` as the walk calls it now: -1 ids, the norm table
    (GATHER), norms in output order (ROWS), cached norms (SHARED)."""
    if mode == wd.SHARED:
        return wd.walk_distance(q, x, metric, base, mode,
                                x_sqnorm=wd.row_sqnorms(x))
    if mode == wd.GATHER:
        return wd.walk_distance(q, x, metric, base, mode, idx=idx,
                                x_sqnorm=sq_table)
    safe = idx.clamp_min(0)
    rows = x[safe].reshape(-1, x.shape[1])
    return wd.walk_distance(q, rows, metric, base, mode, idx=idx,
                            x_sqnorm=sq_table[safe])


@pytest.mark.parametrize("dtype", ["f32", "i8"])
@pytest.mark.parametrize("metric", [DistCalcMethod.L2, DistCalcMethod.Cosine])
def test_walk_distance_equals_the_walks_former_formulas(dtype, metric):
    q, x, idx = _inputs(dtype)
    base = 1 if dtype == "f32" else 127
    sq = dist_ops.row_sqnorms(x)
    for mode in MODES.values():
        got = _fused(q, x, idx, metric, base, mode, sq)
        assert torch.equal(got, _former(q, x, idx, metric, base, mode, sq))


@pytest.mark.parametrize("D", [64, 100, 128])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_fused_version_equals_the_unfused_formula(mode, metric, D):
    """The kernels' plain versions (fused epilogue, -1 slots MAX_DIST,
    norms read from the table by row) equal the former unfused formula
    bit for bit, and the bare-dot epilogue is the contraction."""
    q, x, idx = _inputs("f32", D=D, seed=D + int(metric))
    m = MODES[mode]
    sq = dist_ops.row_sqnorms(x)
    want = _former(q, x, idx, metric, 1, m, sq)
    epi = wd.L2 if metric == DistCalcMethod.L2 else wd.COSINE
    if m == wd.SHARED:
        got = wd.walk_seed_reference(q, x, wd.row_sqnorms(x), epi)
        dot = wd.walk_seed_reference(q, x, None, wd.DOT)
        assert torch.equal(dot, q @ x.T)
    else:
        safe = idx.clamp_min(0)
        rows, table = ((x, sq) if m == wd.GATHER else
                       (x[safe].reshape(-1, D), sq[safe].reshape(-1)))
        got = wd.walk_score_reference(q, rows, idx, table, epi, m,
                                      idx.shape[1])
        dot = wd.walk_score_reference(q, rows, idx, None, wd.DOT, m,
                                      idx.shape[1])
        assert torch.equal(dot[idx < 0],
                           torch.full_like(dot[idx < 0], wd.MAX_DIST))
        assert torch.equal(dot[idx >= 0], torch.einsum(
            "qd,qcd->qc", q, x[safe])[idx >= 0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", list(MODES))
def test_walk_distance_matches_the_jax_package(mode, metric):
    """The same seeded numpy inputs through the JAX package's distance
    functions: equal within float32 tolerance, -1 slots MAX_DIST."""
    q, x, idx = _inputs("f32", D=100, seed=7, Q=11, N=90, C=17)
    m = MODES[mode]
    sq = dist_ops.row_sqnorms(x)
    got = _fused(q, x, idx, metric, 1, m, sq).numpy()
    jm = JMethod(int(metric))
    if m == wd.SHARED:
        want = np.asarray(JD.pairwise_distance(q.numpy(), x.numpy(), jm))
    else:
        safe = idx.clamp_min(0).numpy()
        want = np.asarray(JD.batched_gathered_distance(
            q.numpy(), x.numpy()[safe], jm, 1, sq.numpy()[safe]))
        want = np.where(idx.numpy() >= 0, want, np.float32(wd.MAX_DIST))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_walk_dots_plain_version_and_no_launch_on_the_cpu():
    q, x, idx = _inputs("f32", seed=1)
    before = wd.launch_counts()
    assert set(before) == set(wd.KERNELS)
    sq = wd.row_sqnorms(x)
    assert torch.equal(sq, (x * x).sum(-1))
    got = wd.walk_score(q, x, idx, sq, wd.DOT, wd.GATHER, idx.shape[1])
    want = torch.einsum("qd,qcd->qc", q, x[idx.clamp_min(0)])
    assert torch.equal(got, torch.where(idx >= 0, want, wd.MAX_DIST))
    assert torch.equal(wd.walk_seed(q, x, sq, wd.DOT), q @ x.T)
    for metric in METRICS:
        wd.walk_distance(q, x, metric, 1, wd.GATHER, idx=idx, x_sqnorm=sq)
        wd.walk_distance(q, x, metric, 1, wd.SHARED, x_sqnorm=sq)
    assert wd.launch_counts() == before


def test_engine_caches_the_pivot_norms_for_every_snapshot():
    """The seeding reads the pivots' squared norms cached on the engine;
    every engine a BKT index builds (the first search, after adds, after
    a delete + refine_index compaction) holds its own pivots' norms."""
    import sptag_tpu_torch as tsp

    rng = np.random.default_rng(3)
    data = rng.integers(-8, 9, (600, 8)).astype(np.float32)
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "4"),
                        ("CEF", "64"), ("MaxCheckForRefineGraph", "128"),
                        ("FinalRefineSearchMode", "same")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    q = data[:5] + 0.5

    def held():
        idx.search_batch(q, 5, search_mode="beam")
        eng = idx._get_engine()
        assert torch.equal(eng.pivot_sqnorm,
                           dist_ops.row_sqnorms(eng.pivot_vecs))
        assert eng.device_bytes()["pivots"] == (
            eng.pivot_ids.nbytes + eng.pivot_vecs.nbytes
            + eng.pivot_sqnorm.nbytes)
        return eng

    first = held()
    idx.add(rng.integers(-8, 9, (40, 8)).astype(np.float32))
    assert held() is not first
    idx.delete(data[:60])
    assert idx.refine_index() == tsp.ErrorCode.Success
    assert held().n < first.n + 40
