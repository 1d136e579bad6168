"""Distance functions of the PyTorch port against the JAX package's.

The same seeded numpy inputs go through ``sptag_tpu.ops.distance`` (JAX on
the CPU) and ``sptag_tpu_torch.ops.distance`` (torch on the CPU), for the
four value types and both metrics, in the style of tests/test_distance.py.

Tolerances: integer value types compute exact integer dots in both
packages and combine them with the same float32 operations, so their
distances must be EQUAL (int16 L2 included: three exact partials, one
float32 rounding each, in the same order).  Float32: rtol 1e-5, atol 1e-3
— the matrix products are summed in different orders, and the expanded
L2 form cancels near 0 (the absolute floor of tests/test_distance.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sptag_tpu.core.types import DistCalcMethod, VectorValueType, base_of
from sptag_tpu.ops import distance as JD
from sptag_tpu_torch.ops import distance as TD

VALUE_TYPES = [VectorValueType.Float, VectorValueType.Int8,
               VectorValueType.UInt8, VectorValueType.Int16]
METRICS = [DistCalcMethod.L2, DistCalcMethod.Cosine]


def _rand(value_type, shape, rng):
    if value_type == VectorValueType.Float:
        return rng.standard_normal(shape).astype(np.float32)
    if value_type == VectorValueType.Int8:
        return rng.integers(-127, 128, shape, dtype=np.int8)
    if value_type == VectorValueType.UInt8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.integers(-3000, 3000, shape, dtype=np.int16)


def _check(got, want, value_type):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    if value_type == VectorValueType.Float:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def _prepared(value_type, metric, shape, rng):
    """Cosine rows are base-normalized at ingest, as the index does."""
    x = _rand(value_type, shape, rng)
    if metric == DistCalcMethod.Cosine:
        x = JD.normalize(x, base_of(value_type))
    return x


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("value_type", VALUE_TYPES)
def test_pairwise_distance_matches_jax(value_type, metric):
    rng = np.random.default_rng(int(value_type) * 7 + int(metric))
    q = _prepared(value_type, metric, (9, 100), rng)
    x = _prepared(value_type, metric, (33, 100), rng)
    want = JD.pairwise_distance(jnp.asarray(q), jnp.asarray(x), metric,
                                value_type)
    got = TD.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x),
                               metric, value_type)
    _check(got, want, value_type)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("value_type", VALUE_TYPES)
def test_batched_gathered_distance_matches_jax(value_type, metric):
    rng = np.random.default_rng(int(value_type) * 11 + int(metric))
    q = _prepared(value_type, metric, (6, 128), rng)
    cand = _prepared(value_type, metric, (6 * 21, 128), rng).reshape(
        6, 21, 128)
    base = base_of(value_type)
    want = JD.batched_gathered_distance(jnp.asarray(q), jnp.asarray(cand),
                                        metric, base)
    got = TD.batched_gathered_distance(torch.from_numpy(q),
                                       torch.from_numpy(cand), metric, base)
    _check(got, want, value_type)
    # with cached candidate norms (the dense search's path)
    sq = np.array(JD.row_sqnorms(jnp.asarray(cand.reshape(-1, 128))))
    want = JD.batched_gathered_distance(
        jnp.asarray(q), jnp.asarray(cand), metric, base,
        jnp.asarray(sq.reshape(6, 21)))
    got = TD.batched_gathered_distance(
        torch.from_numpy(q), torch.from_numpy(cand), metric, base,
        torch.from_numpy(sq.reshape(6, 21)))
    _check(got, want, value_type)


@pytest.mark.parametrize("value_type", VALUE_TYPES)
def test_row_sqnorms_matches_jax(value_type):
    rng = np.random.default_rng(int(value_type))
    x = _rand(value_type, (40, 77), rng)
    _check(TD.row_sqnorms(torch.from_numpy(x)),
           JD.row_sqnorms(jnp.asarray(x)), value_type)


@pytest.mark.parametrize("value_type", VALUE_TYPES)
def test_normalize_is_the_same_function(value_type):
    """Host-side ingest normalization is bit-identical (zero rows too)."""
    rng = np.random.default_rng(3)
    x = _rand(value_type, (20, 31), rng)
    x[3] = 0
    base = base_of(value_type)
    np.testing.assert_array_equal(TD.normalize(x, base), JD.normalize(x, base))


def test_int16_cosine_near_base_squared_is_exact():
    """Rows at length 32767: base^2 - dot must not cancel (int32 combine)."""
    rng = np.random.default_rng(5)
    x = JD.normalize(_rand(VectorValueType.Int16, (12, 64), rng), 32767)
    q = x[:4].copy()
    want = JD.pairwise_distance(jnp.asarray(q), jnp.asarray(x),
                                DistCalcMethod.Cosine, VectorValueType.Int16)
    got = TD.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x),
                               DistCalcMethod.Cosine, VectorValueType.Int16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = 32767 ** 2 - q.astype(np.int64) @ x.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def test_batch_topk_tie_rule():
    """All-equal rows return indices 0..k-1, as lax.top_k does."""
    d = torch.zeros((3, 50))
    vals, idx = TD.batch_topk(d, 7)
    assert idx.dtype == torch.int32
    assert (idx == torch.arange(7, dtype=torch.int32)).all()
    jv, ji = JD.batch_topk(jnp.zeros((3, 50)), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_batch_topk_matches_jax_with_ties():
    """Integer-valued distances (many ties) select the same indices in the
    same order in both packages."""
    rng = np.random.default_rng(8)
    d = rng.integers(0, 6, (16, 200)).astype(np.float32)
    jv, ji = JD.batch_topk(jnp.asarray(d), 25)
    tv, ti = TD.batch_topk(torch.from_numpy(d), 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# the largest D whose int8 / uint8 contraction runs in float32, and the
# next D up, which takes the integer path
INT_CONTRACT_EDGES = [(np.int8, 1023), (np.int8, 1024),
                      (np.uint8, 258), (np.uint8, 259)]


@pytest.mark.parametrize("dtype,d", INT_CONTRACT_EDGES)
def test_int_contract_exact_at_float32_edge(dtype, d):
    """int_contract equals the int64 product on both sides of the float32
    edge, on rows of the largest products (every partial sum of the last
    row pair is D * 128^2 or D * 255^2) and on random rows."""
    info = np.iinfo(dtype)
    extreme = info.min if dtype == np.int8 else info.max
    bound = int(extreme) * int(extreme)
    edge = max(e for t, e in INT_CONTRACT_EDGES if t == dtype and
               bound * e < (1 << 24))
    assert (bound * d < (1 << 24)) == (d == edge)
    rng = np.random.default_rng(d)
    a = rng.integers(info.min, info.max + 1, (5, d), dtype=dtype)
    b = rng.integers(info.min, info.max + 1, (7, d), dtype=dtype)
    a[-1], b[-1] = extreme, extreme
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = TD.int_contract("qd,nd->qn", torch.from_numpy(a),
                          torch.from_numpy(b))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[-1, -1] == bound * d
