"""The walk's fixed-order distances (ops/walk_dots.py) on the CPU.

On the card they are the kernel of csrc/walk_dots.cu (tests/
test_torch_cuda.py holds it against this plain version and shows its bits
do not depend on the batch).  On the CPU `walk_distance` must compute
exactly what ops/distance.py computed for the walk before, so the port's
walk keeps the JAX package's results there: the plain version is checked
for equality with those formulas, in every mode, metric and dtype.
"""

import numpy as np
import pytest
import torch

from sptag_tpu_torch.core.types import DistCalcMethod
from sptag_tpu_torch.ops import distance as dist_ops
from sptag_tpu_torch.ops import walk_dots as wd


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        q = torch.from_numpy(rng.standard_normal((9, 24)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((70, 24)).astype(np.float32))
    else:
        q = torch.from_numpy(rng.integers(-128, 128, (9, 24)).astype(np.int8))
        x = torch.from_numpy(rng.integers(-128, 128, (70, 24)).astype(np.int8))
    idx = torch.from_numpy(rng.integers(0, 70, (9, 13)))
    return q, x, idx


@pytest.mark.parametrize("dtype", ["f32", "i8"])
@pytest.mark.parametrize("metric", [DistCalcMethod.L2, DistCalcMethod.Cosine])
def test_walk_distance_equals_the_walks_former_formulas(dtype, metric):
    q, x, idx = _inputs(dtype)
    base = 1 if dtype == "f32" else 127
    sq = dist_ops.row_sqnorms(x)
    got = wd.walk_distance(q, x, metric, base, wd.GATHER, idx=idx,
                           x_sqnorm=sq[idx])
    want = dist_ops.batched_gathered_distance(q, x[idx], metric, base,
                                              sq[idx])
    assert torch.equal(got, want)
    rows = x[idx].reshape(-1, x.shape[1])
    got = wd.walk_distance(q, rows, metric, base, wd.ROWS,
                           x_sqnorm=sq[idx], C=idx.shape[1])
    assert torch.equal(got, want)
    got = wd.walk_distance(q, x, metric, base, wd.SHARED)
    assert torch.equal(got, dist_ops.pairwise_distance(q, x, metric))


def test_walk_dots_plain_version_and_no_launch_on_the_cpu():
    q, x, idx = _inputs("f32", seed=1)
    before = wd.launches
    got = wd.walk_dots(q, x, idx, wd.GATHER, idx.shape[1])
    assert torch.equal(got, torch.einsum("qd,qcd->qc", q, x[idx]))
    assert torch.equal(wd.walk_dots(q, x, None, wd.SHARED, x.shape[0]),
                       q @ x.T)
    assert wd.launches == before
