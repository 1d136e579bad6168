"""`correct` on the card at a small size: the port's kernels pass, and
the control and the walk or scan cut short fail, at the committed
limits.  Marked `cuda`; without a card each test skips.  On the card:

    python -m pytest -m cuda annbench/tests/test_annbench_card.py
"""

from __future__ import annotations

import time

import pytest
import torch

from annbench import program, session
from annbench.tests.helpers import small_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def run_on(card, cell, build):
    return session.run(cell, 2**33 + 9, 1.0, False, card,
                       time.perf_counter(), build)


@pytest.mark.parametrize("name", ["rs100-l2.dense.all",
                                  "rs100-cos.beam.all"])
def test_the_port_is_correct_on_the_card(card, name):
    cell = small_cell(name, rows=20000, queries=2000, batch=512,
                      graph={})
    r = run_on(card, cell, program.build)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["rs100-l2.dense.all",
                                  "rs100-cos.beam.all"])
def test_the_control_is_not_correct_on_the_card(card, name):
    cell = small_cell(name, rows=20000, queries=2000, batch=512,
                      graph={})
    r = run_on(card, cell, session.build_control)
    assert r["correct"] is False
    assert r["checks"]["dist_gap"]["value"] > cell.limits["dist_gap"]


@pytest.mark.parametrize("name", ["rs100-l2.dense.all",
                                  "rs100-l2.beam.one"])
def test_a_walk_or_scan_cut_short_is_not_correct_on_the_card(card, name):
    cell = small_cell(name, rows=20000, queries=2000, batch=512,
                      graph={})
    cell.config["index_params"]["MaxCheck"] = "16"
    r = run_on(card, cell, program.build)
    assert r["correct"] is False
    assert r["checks"]["recall_miss"]["value"] > cell.limits["recall_miss"]
    assert r["checks"]["dist_gap"]["value"] < cell.limits["dist_gap"]
