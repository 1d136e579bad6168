"""The port's bin-reduction top-k (sptag_tpu_torch/ops/topk_bins.py)
against the JAX package's (sptag_tpu/ops/topk_bins.py).

The rule functions are host math and must agree exactly over a grid of
(k, width, mode, target).  The tensor functions must return the same ids
and distances as ``binned_topk_kernel`` on the CPU, near ties included:
rows of small integers (many exact ties) and MAX_DIST padding.
"""

import itertools

import numpy as np
import pytest
import torch

from sptag_tpu.ops import topk_bins as jbins
from sptag_tpu_torch.ops import topk_bins as tbins

KS = (1, 2, 5, 10, 32, 100)
WIDTHS = (1, 7, 64, 100, 640, 1000, 4096, 100_000)
TARGETS = (0.5, 0.9, 0.95, 0.99, 1.0)
MODES = ("off", "on", "auto", "1", "0", "", " ON ", None)


@pytest.mark.parametrize("mode", MODES)
def test_rule_functions_match_jax(mode):
    for k, width, rt in itertools.product(KS, WIDTHS, TARGETS):
        assert tbins.bins_for(k, width, rt) == jbins.bins_for(k, width, rt)
        assert tbins.auto_bins(k, width, rt) == jbins.auto_bins(k, width, rt)
        assert tbins.resolve_bins(mode, k, width, rt) == \
            jbins.resolve_bins(mode, k, width, rt)
        assert tbins.walk_merge_bins(mode, k, width) == \
            jbins.walk_merge_bins(mode, k, width)
        assert tbins.seed_spare_keep(mode, k, width) == \
            jbins.seed_spare_keep(mode, k, width)
    assert tbins.normalize_mode(mode) == jbins.normalize_mode(mode)


def test_small_rules_and_errors_match_jax():
    for x in range(-2, 1100):
        assert tbins.pow2ceil(x) == jbins.pow2ceil(x)
    for rt in (0.0, -0.1, 1.01, 2.0):
        with pytest.raises(ValueError):
            tbins.validate_recall_target(rt)
        with pytest.raises(ValueError):
            jbins.validate_recall_target(rt)
    for bad in ("maybe", "2"):
        with pytest.raises(ValueError):
            tbins.normalize_mode(bad)
        with pytest.raises(ValueError):
            jbins.normalize_mode(bad)
    assert tbins.DEFAULT_RECALL_TARGET == jbins.DEFAULT_RECALL_TARGET
    assert tbins.AUTO_WIDTH_FACTOR == jbins.AUTO_WIDTH_FACTOR


def _rows(seed, q, w, levels):
    """Rows of small integers (exact ties everywhere) with some MAX_DIST
    padding, or float noise when levels == 0."""
    rng = np.random.default_rng(seed)
    if levels:
        d = rng.integers(0, levels, (q, w)).astype(np.float32)
    else:
        d = rng.standard_normal((q, w)).astype(np.float32)
    d[rng.random((q, w)) < 0.1] = np.float32(3.4e38)
    return d


@pytest.mark.parametrize("w,k,bins,levels", [
    (100, 10, 32, 5), (100, 10, 32, 0), (257, 16, 64, 3), (64, 8, 64, 2),
    (1000, 10, 256, 50), (33, 4, 8, 0), (2048, 32, 128, 1000),
    (10, 10, 16, 3),                    # bins wider than the row
])
def test_binned_topk_matches_jax(w, k, bins, levels):
    d = _rows(w * 7 + bins, 24, w, levels)
    jd, ji = jbins.binned_topk_kernel(d, k, bins)
    td, ti = tbins.binned_topk(torch.from_numpy(d), k, bins)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jv, jc = jbins.bin_shortlist(d, bins)
    tv, tc = tbins.bin_shortlist(torch.from_numpy(d), bins)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_binned_topk_is_exact_without_collisions():
    """With every true top-k in its own bin the select is exact."""
    d = np.full((3, 64), 100.0, np.float32)
    d[:, [0, 9, 18, 27]] = [[1, 2, 3, 4]] * 3
    td, ti = tbins.binned_topk(torch.from_numpy(d), 4, 8)
    np.testing.assert_array_equal(ti.numpy(), [[0, 9, 18, 27]] * 3)
    np.testing.assert_array_equal(td.numpy(), [[1, 2, 3, 4]] * 3)
