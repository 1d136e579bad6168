"""The port's block-dot functions against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs ``probe_block_dots`` / ``group_block_dots`` in Pallas interpret
mode, as tests/test_pallas.py does.  Tolerances: float32 dots within
rtol 1e-5, atol 1e-4 on unit-normal data (as test_pallas.py); int8 dots
exactly equal.  The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py compares them with the plain versions there, and
``python3 chip_smoke.py`` does the same at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from sptag_tpu.ops import pallas_kernels
from sptag_tpu_torch.ops import block_dots


def _inputs(rng, C, P, D, Q, int8):
    if int8:
        blocks = rng.integers(-127, 128, (C, P, D)).astype(np.int8)
        queries = rng.integers(-127, 128, (Q, D)).astype(np.int8)
    else:
        blocks = rng.standard_normal((C, P, D)).astype(np.float32)
        queries = rng.standard_normal((Q, D)).astype(np.float32)
    return blocks, queries


def _compare(got, want, int8):
    if int8:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


# (C, P, D, Q, nprobe): aligned, ragged P (not a multiple of 8), D=16
PROBE_SHAPES = [(7, 32, 128, 4, 3), (5, 13, 128, 6, 2), (9, 40, 16, 5, 4)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,P,D,Q,nprobe", PROBE_SHAPES)
def test_probe_block_dots_matches_pallas(C, P, D, Q, nprobe, int8):
    rng = np.random.default_rng(C * 100 + P + D)
    blocks, queries = _inputs(rng, C, P, D, Q, int8)
    topc = rng.integers(0, C, (Q, nprobe)).astype(np.int32)
    want = pallas_kernels.probe_block_dots(blocks, queries, topc,
                                           interpret=True)
    got = block_dots.probe_block_dots(torch.from_numpy(blocks),
                                      torch.from_numpy(queries),
                                      torch.from_numpy(topc))
    assert tuple(got.shape) == (Q, nprobe, P)
    _compare(got, want, int8)


# (C, P, D, NG, U, G)
GROUP_SHAPES = [(9, 32, 128, 4, 5, 8), (5, 13, 128, 2, 3, 32),
                (6, 40, 16, 3, 4, 4)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C,P,D,NG,U,G", GROUP_SHAPES)
def test_group_block_dots_matches_pallas(C, P, D, NG, U, G, int8):
    rng = np.random.default_rng(C * 100 + P + D + G)
    blocks, queries = _inputs(rng, C, P, D, NG * G, int8)
    union = rng.integers(0, C, (NG, U)).astype(np.int32)
    want = pallas_kernels.group_block_dots(blocks, queries, union,
                                           interpret=True)
    got = block_dots.group_block_dots(torch.from_numpy(blocks),
                                      torch.from_numpy(queries),
                                      torch.from_numpy(union))
    assert tuple(got.shape) == (NG, U, G, P)
    _compare(got, want, int8)


def test_int8_extremes_are_exact():
    """-128 * -128 * D sums well past int16 and float16 range stay exact."""
    blocks = torch.full((2, 4, 128), -128, dtype=torch.int8)
    queries = torch.full((3, 128), -128, dtype=torch.int8)
    topc = torch.zeros((3, 2), dtype=torch.int32)
    out = block_dots.probe_block_dots(blocks, queries, topc)
    assert (out == 128 * 128 * 128).all()
    union = torch.ones((1, 2), dtype=torch.int32)
    out = block_dots.group_block_dots(blocks, queries, union)
    assert (out == 128 * 128 * 128).all()


def test_cpu_tensors_use_the_plain_version_and_never_count():
    block_dots.reset_launch_counts()
    blocks = torch.randn(3, 8, 16)
    queries = torch.randn(4, 16)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    torch.testing.assert_close(
        block_dots.probe_block_dots(blocks, queries, ids),
        block_dots.probe_block_dots_reference(blocks, queries, ids))
    union = torch.zeros((2, 2), dtype=torch.int32)
    torch.testing.assert_close(
        block_dots.group_block_dots(blocks, queries, union),
        block_dots.group_block_dots_reference(blocks, queries, union))
    assert set(block_dots.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["dtype_mix", "int64_ids", "dim", "groups",
                                 "float64"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    blocks = torch.randn(3, 8, 16)
    queries = torch.randn(4, 16)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    if bad == "dtype_mix":
        queries = queries.to(torch.int8)
    elif bad == "int64_ids":
        ids = ids.long()
    elif bad == "dim":
        queries = torch.randn(4, 15)
    elif bad == "float64":
        blocks, queries = blocks.double(), queries.double()
    if bad == "groups":
        with pytest.raises(ValueError):
            block_dots.group_block_dots(blocks, queries,
                                        torch.zeros((3, 2),
                                                    dtype=torch.int32))
        return
    with pytest.raises((TypeError, ValueError)):
        block_dots.probe_block_dots(blocks, queries, ids)
