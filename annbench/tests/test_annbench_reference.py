"""The reference and the metric arithmetic against plain numpy."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from annbench import arith, data, judge, reference, spec
from annbench.tests.helpers import CPU, ROOT, small_data


def brute_force(x, q, k, metric):
    x = x.astype(np.float64)
    q = q.astype(np.float64)
    if metric == "Cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1.0 - q @ x.T
    else:
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
@pytest.mark.parametrize("dim", [16, 100])
def test_exact_topk_equals_numpy_brute_force(metric, dim):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((500, dim)).astype(np.float32)
    q = rng.standard_normal((37, dim)).astype(np.float32)
    want_d, want_ids = brute_force(x, q, 10, metric)
    d, ids = reference.exact_topk(reference.prepare(x, metric, CPU),
                                  reference.prepare(q, metric, CPU), 10,
                                  metric, block=16)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-4, atol=1e-4)


def test_round_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -3.0 - 2.0 ** -12, 1.0 + 2.0 ** -23])
    got = reference.round_to_tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -3.0, 1.0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_pair_distances_are_float64_exact(metric):
    rng = np.random.default_rng(3)
    q = reference.prepare(rng.standard_normal((4, 8)), metric, CPU)
    x = reference.prepare(rng.standard_normal((12, 8)), metric, CPU)
    d, scale = reference.pair_distances(q, x.reshape(4, 3, 8), metric)
    qq = q.double().numpy()[:, None, :]
    xx = x.double().numpy().reshape(4, 3, 8)
    if metric == "L2":
        want = ((qq - xx) ** 2).sum(-1)
    else:
        want = 1.0 - (qq * xx).sum(-1)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, atol=1e-12)
    assert (scale.numpy() >= np.abs(want)).all()


def test_tf32_control_reads_above_float32():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2000, 128)).astype(np.float32) + 4
    q = rng.standard_normal((50, 128)).astype(np.float32) + 4
    xp, qp = reference.prepare(x, "L2", CPU), reference.prepare(q, "L2", CPU)
    gaps = {}
    for precision in ("float32", "tf32"):
        d, ids = reference.exact_topk(xp, qp, 10, "L2", precision=precision)
        exact, scale = reference.pair_distances(qp, xp[ids], "L2")
        gaps[precision] = float(((d.double() - exact).abs() / scale).max())
    assert gaps["float32"] < 1e-6 < 1e-5 < gaps["tf32"]


def test_bad_entries():
    ids = np.array([[0, 1, 2], [3, 3, 4], [5, -1, 6], [7, 8, 99],
                    [1, 2, 0]], np.int32)
    d = np.array([[0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1, 2], [2, 1, 3]],
                 np.float32)
    d[0, 2] = np.nan
    assert judge.bad_entries(d, ids, 10).tolist() == [1, 1, 1, 1, 1]


def test_rate_and_percentile_take_every_sample():
    assert arith.rate(300, 2.0) == 150.0
    samples = list(range(1, 101))
    assert arith.percentile(samples, 95) == pytest.approx(95.05)
    assert arith.percentile(samples, 50) == pytest.approx(50.5)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert arith.union_seconds(spans) == pytest.approx(5.0)
    assert list(arith.gaps(spans, -1, 10)) == [(-1, 0), (3, 5), (6, 8),
                                               (9, 10)]
    assert arith.union_seconds([]) == 0.0


@pytest.mark.parametrize("samples,dim,centers", [(1000, 20, 10),
                                                 (10000, 20, 100)])
def test_blobs_are_the_data_sets_own(samples, dim, centers):
    """The rewrite gives scikit-learn's make_blobs and train_test_split
    bit for bit, as ann-benchmarks' random-* data sets call them."""
    datasets = pytest.importorskip("sklearn.datasets")
    selection = pytest.importorskip("sklearn.model_selection")
    x, _ = datasets.make_blobs(n_samples=samples, n_features=dim,
                               centers=centers, random_state=1)
    want_train, want_test = selection.train_test_split(
        x, test_size=0.1, random_state=1)
    train, test = data.blobs({"samples": samples, "dimension": dim,
                              "centers": centers, "cluster_std": 1.0,
                              "center_box": [-10.0, 10.0],
                              "random_state": 1,
                              "test_size": samples // 10})
    np.testing.assert_array_equal(train, want_train.astype(np.float32))
    np.testing.assert_array_equal(test, want_test.astype(np.float32))


def test_the_seed_orders_the_query_set_and_nothing_else():
    config = small_data(spec.load_cell(ROOT, "rs100-l2.beam.all").config,
                        rows=900, queries=100)
    c1, q1 = data.make(config, 2**33 + 1)
    c2, q2 = data.make(config, 2**33 + 2)
    c3, q3 = data.make(config, 2**33 + 1)
    np.testing.assert_array_equal(c1, c2)
    assert c1.shape == (900, 100) and q1.shape == (100, 100)
    np.testing.assert_array_equal(q1, q3)
    assert not np.array_equal(q1, q2)
    np.testing.assert_array_equal(np.sort(q1, axis=0), np.sort(q2, axis=0))
