"""The port's cost ledger (sptag_tpu_torch/utils/costmodel.py) against the
JAX package's (sptag_tpu/utils/costmodel.py).

The port registers the same 43 families; every formula gives the JAX
package's (flops, bytes) exactly at three shapes; and where the
contraction dominates the formula, the ledger agrees with
``FlopCounterMode``'s count of the plain PyTorch work within the ledger's
15% tolerance.
"""

import importlib

import numpy as np
import pytest
import torch

from sptag_tpu.utils import costmodel as jcm
from sptag_tpu_torch.utils import costmodel as tcm
from sptag_tpu_torch.utils import metrics as tmetrics

_JAX_MODULES = ("sptag_tpu.ops.pallas_kernels", "sptag_tpu.ops.kmeans",
                "sptag_tpu.ops.distance", "sptag_tpu.ops.topk_bins",
                "sptag_tpu.ops.cascade", "sptag_tpu.ops.graph",
                "sptag_tpu.algo.flat", "sptag_tpu.algo.engine",
                "sptag_tpu.algo.dense", "sptag_tpu.parallel.sharded",
                "sptag_tpu.parallel.mesh_engine")
_PORT_MODULES = ("sptag_tpu_torch.ops.block_dots", "sptag_tpu_torch.ops.kmeans",
                 "sptag_tpu_torch.ops.distance",
                 "sptag_tpu_torch.ops.topk_bins",
                 "sptag_tpu_torch.ops.cascade", "sptag_tpu_torch.ops.graph",
                 "sptag_tpu_torch.algo.flat", "sptag_tpu_torch.algo.engine",
                 "sptag_tpu_torch.algo.dense",
                 "sptag_tpu_torch.parallel.sharded",
                 "sptag_tpu_torch.parallel.mesh_engine")
for _m in _JAX_MODULES + _PORT_MODULES:
    importlib.import_module(_m)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_family_set_equals_the_jax_ledger():
    assert len(jcm.families()) == 43
    assert tcm.families() == jcm.families()
    # every family names the port function that does its work
    for fam in tcm.families():
        assert tcm.entry(fam).kernel_name, fam
    assert len(tcm.registered_kernel_names()) > 20


# three shapes: every key any formula reads; the second turns the binned
# and int8-scoring terms on, the third the composed-out / flag-off forms
_BASE = dict(Q=32, N=4096, D=64, k=10, itemsize=4, W=3, R=256, S=16, B=8,
             P=48, K=16, restarts=2, num_candidates=32, C=64, U=12, m=16,
             X=128, L=96, nprobe=6, G=8, NG=4, Pb=56, M_chunks=3,
             N_local=2048, k_local=10, k_final=10, n_dev=2, b1=512, b2=64,
             score_itemsize=4, merge_bins=0, score_scale=0, rerank=True,
             use_sketch=True, use_int8=True, bins=64, binned_bins=0)
SHAPES = [
    _BASE,
    dict(_BASE, Q=1024, N=200064, D=128, k=100, W=4, R=8192, X=512,
         L=256, merge_bins=512, score_scale=0.01, binned_bins=128,
         itemsize=1, score_itemsize=1, n_dev=4, k_local=25, k_final=100,
         N_local=50016, b1=8192, b2=1024, bins=256, C=894, Pb=256),
    dict(_BASE, Q=7, N=333, D=16, k=3, rerank=False, use_sketch=False,
         use_int8=False, n_dev=8, k_local=3, k_final=3, N_local=42,
         M_chunks=1, U=3, G=2, NG=3),
]


@pytest.mark.parametrize("family", sorted(jcm.families()))
def test_every_formula_equals_the_jax_formula(family):
    for shape in SHAPES:
        t = tcm.estimate(family, **shape)
        j = jcm.estimate(family, **shape)
        assert (t.flops, t.hbm_bytes) == (j.flops, j.hbm_bytes), \
            (family, shape)
        assert t.intensity == j.intensity


def test_shared_constants_equal_the_jax_ledger():
    for name in ("SCAN_MATRIX_TRAFFIC", "WALK_SORT_FLOPS",
                 "WALK_SORT_TRAFFIC", "WALK_BINNED_FLOPS",
                 "WALK_BINNED_TRAFFIC", "DEFAULT_TOLERANCE"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    assert tcm.matmul_flops(3, 5, 7) == jcm.matmul_flops(3, 5, 7)
    assert tcm.topk_flops(9, 11) == jcm.topk_flops(9, 11)


def _flat_scan(Q, N, D, k):
    from sptag_tpu_torch.algo.flat import _flat_search_kernel
    from sptag_tpu_torch.ops import distance as dist_ops

    g = torch.Generator().manual_seed(0)
    data = torch.randn((N, D), generator=g)
    q = torch.randn((Q, D), generator=g)
    sq = dist_ops.row_sqnorms(data)
    inv = torch.zeros(N, dtype=torch.bool)
    return tcm.count_flops(_flat_search_kernel, data, sq, inv, q, k, 0, 1)


def _probe_dots(Q, nprobe, P, D):
    from sptag_tpu_torch.ops import block_dots

    g = torch.Generator().manual_seed(1)
    blocks = torch.randn((16, P, D), generator=g)
    q = torch.randn((Q, D), generator=g)
    ids = torch.randint(0, 16, (Q, nprobe), generator=g,
                        dtype=torch.int32)
    return tcm.count_flops(block_dots.probe_block_dots, blocks, q, ids)


def _group_dots(NG, U, G, P, D):
    from sptag_tpu_torch.ops import block_dots

    g = torch.Generator().manual_seed(2)
    blocks = torch.randn((16, P, D), generator=g)
    q = torch.randn((NG * G, D), generator=g)
    union = torch.randint(0, 16, (NG, U), generator=g, dtype=torch.int32)
    return tcm.count_flops(block_dots.group_block_dots, blocks, q, union)


def _seed(Q, P, D, L):
    from sptag_tpu_torch.algo.engine import _seed_from_pivots
    from sptag_tpu_torch.ops import distance as dist_ops

    g = torch.Generator().manual_seed(3)
    pvecs = torch.randn((P, D), generator=g)
    q = torch.randn((Q, D), generator=g)
    pids = torch.arange(P, dtype=torch.int64)
    return tcm.count_flops(_seed_from_pivots, pids, pvecs,
                           dist_ops.row_sqnorms(pvecs), q, L, 0, 4 * P)


# (family, shape, counter): the families whose contraction dominates the
# formula at the shape tested (utils/costmodel.py's docstring)
CROSSCHECKS = [
    ("flat.scan", dict(Q=32, N=4096, D=64, k=10), _flat_scan),
    ("flat.scan", dict(Q=16, N=2048, D=128, k=5), _flat_scan),
    ("pallas.probe_block_dots", dict(Q=24, nprobe=5, P=40, D=64),
     _probe_dots),
    ("pallas.group_block_dots", dict(NG=4, U=6, G=8, P=32, D=96),
     _group_dots),
    ("beam.seed", dict(Q=32, P=512, D=256, L=64, W=65), _seed),
]


@pytest.mark.parametrize("family,shape,counter", CROSSCHECKS,
                         ids=[c[0] + "-" + str(i)
                              for i, c in enumerate(CROSSCHECKS)])
def test_crosscheck_with_flop_counter_within_tolerance(family, shape,
                                                       counter):
    args = {k: v for k, v in shape.items() if k != "W"}
    counted, _ = counter(**args)
    assert counted > 0
    before = tmetrics.counter_value("costmodel.xla_mismatch")
    rel = tcm.crosscheck(family, counted, **shape)
    assert abs(rel["flops_rel"]) <= tcm.DEFAULT_TOLERANCE, rel
    assert rel["bytes_rel"] == 0.0           # bytes were not counted
    assert tmetrics.counter_value("costmodel.xla_mismatch") == before


def test_rerank_is_outside_the_counter_and_a_drift_is_counted():
    """cascade.rerank's fitted FP_RERANK_FLOPS (4.2 an element) prices
    materialised copies a contraction count never sees, so it is not
    cross-checked: the counter sits about half below it.  A crosscheck
    outside the tolerance bumps costmodel.xla_mismatch."""
    from sptag_tpu_torch.ops import cascade as tc
    from sptag_tpu_torch.ops import walk_dots as wd

    Q, b2, D, k = 16, 64, 128, 10
    g = torch.Generator().manual_seed(4)
    q = torch.randn((Q, D), generator=g)
    x = torch.randn((512, D), generator=g)
    ids = torch.randint(0, 512, (Q, b2), generator=g)
    counted, _ = tcm.count_flops(tc.rerank_gathered, q, x, ids, k, 0, 1,
                                 wd.GATHER)
    before = tmetrics.counter_value("costmodel.xla_mismatch")
    rel = tcm.crosscheck("cascade.rerank", counted, Q=Q, D=D, b2=b2, k=k)
    if counted:
        assert rel["flops_rel"] > tcm.DEFAULT_TOLERANCE
    else:
        assert rel["flops_rel"] == 0.0
    # a (flops, bytes) count off by half on the bytes trips the counter
    est = tcm.estimate("flat.scan", Q=4, N=64, D=8, k=2)
    tcm.crosscheck("flat.scan", (est.flops, est.hbm_bytes * 2.0), Q=4, N=64,
                   D=8, k=2)
    assert tmetrics.counter_value("costmodel.xla_mismatch") >= before + 1


def test_estimate_of_an_unregistered_family_raises():
    with pytest.raises(KeyError, match="no cost-ledger entry"):
        tcm.estimate("no.such.family", Q=1)
    assert np.isclose(tcm.CostEstimate("x", 8.0, 2.0).intensity, 4.0)
    assert tcm.CostEstimate("x", 8.0, 0.0).intensity == 0.0
