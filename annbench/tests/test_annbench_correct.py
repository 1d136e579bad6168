"""`correct` on the CPU at a small size: the port's answers pass, and the
comparison fails the control (the reference in TF32 in the program's
place) and the program broken underneath its entry, once for each fault a
search cell can have.  The limits are the committed cells' own.

The faults are planted in `pad_results` as the BKT index calls it, the
last step of every search below `search_batch`'s front end, and in the
walk's and the scan's budget (`MaxCheck` forced low: rows with their
exact distances, but not the nearest ones).  A search on one chip
exchanges nothing between chips, so that fault has no test."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from annbench import control, program, session
from annbench.tests.helpers import ROOT, run, small_cell


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def dense(name="rs100-l2.dense.all"):
    return small_cell(name, rows=3000, queries=400, batch=128)


@pytest.mark.parametrize("cell_name", ["rs100-l2.dense.all",
                                       "rs100-l2.beam.one"])
def test_the_port_is_correct(cell_name):
    cell = small_cell(cell_name, rows=2000, queries=300, batch=64)
    r = run(cell, program.build, seconds=0.5)
    assert r["correct"], r["checks"]
    assert r["checks"]["dist_gap"]["value"] < cell.limits["dist_gap"] / 10
    assert r["checks"]["recall_miss"]["value"] <= cell.limits["recall_miss"]


@pytest.mark.parametrize("cell_name", ["rs100-l2.dense.all",
                                       "rs100-cos.beam.all"])
def test_the_control_is_not_correct(cell_name):
    cell = small_cell(cell_name, rows=3000, queries=400, batch=128)
    r = run(cell, session.build_control, seconds=0.3)
    assert r["correct"] is False
    assert r["checks"]["dist_gap"]["value"] > cell.limits["dist_gap"]
    assert r["checks"]["bad_answers"]["value"] == 0


def stale(pad):
    """Every call after the first returns the first call's answers: the
    search's state never moves on."""
    first = []

    def broken(d, ids, k):
        out = pad(d, ids, k)
        if not first:
            first.append(out)
        return first[0] if len(first[0][1]) == len(out[1]) else out
    return broken


def half_left_out(pad):
    """The second half of each batch is never searched: its rows carry the
    first half's answers."""
    def broken(d, ids, k):
        d, ids = pad(d, ids, k)
        h = len(ids) // 2
        d, ids = d.copy(), ids.copy()
        d[h:2 * h], ids[h:2 * h] = d[:h], ids[:h]
        return d, ids
    return broken


def altered(pad):
    """One answer of each batch names another row, where it is produced."""
    def broken(d, ids, k):
        d, ids = pad(d, ids, k)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 1) % 3000
        return d, ids
    return broken


def padded(pad):
    """The last answer of each row left as padding."""
    def broken(d, ids, k):
        d, ids = pad(d, ids, k)
        d, ids = d.copy(), ids.copy()
        d[:, -1], ids[:, -1] = np.float32(3.4e38), -1
        return d, ids
    return broken


@pytest.mark.parametrize("fault", [stale, half_left_out, altered, padded],
                         ids=lambda f: f.__name__)
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    from sptag_tpu_torch.algo import bkt

    monkeypatch.setattr(bkt, "pad_results", fault(bkt.pad_results))
    r = run(dense(), program.build, seconds=0.3)
    assert r["correct"] is False, r["checks"]


def cut_short(cell):
    """The scan forced to 16 checks: rows with their exact distances, but
    not the nearest ones (on blobs this small the walk's seeds alone find
    nearly all)."""
    cell.config["index_params"]["MaxCheck"] = "16"
    return program.build


def far_rows(cell):
    """Every answer's rows drawn at random, with exact distances in
    order: a walk that never leaves its seeds, at worst."""
    return control.far_rows(program.build)


@pytest.mark.parametrize("cell_name,fault", [
    ("rs100-l2.dense.all", cut_short), ("rs100-l2.beam.all", far_rows),
    ("rs100-l2.beam.one", far_rows)], ids=["dense-cut", "beam-far",
                                           "one-far"])
def test_a_walk_or_scan_cut_short_is_not_correct(cell_name, fault):
    """Only the recall check fails."""
    cell = small_cell(cell_name, rows=2000, queries=300, batch=64)
    r = run(cell, fault(cell), seconds=0.3)
    assert r["correct"] is False
    checks = r["checks"]
    assert checks["recall_miss"]["value"] > cell.limits["recall_miss"]
    assert checks["dist_gap"]["value"] < cell.limits["dist_gap"]
    assert checks["bad_answers"]["value"] == 0


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "annbench/run.py", "--workload",
         "rs100-l2.dense.all", "--seed", str(2**33), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_the_bench_folder_alone_cannot_run(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder has
    no program to run."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "annbench"), tmp_path / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path[0] = '.'; "
         "from annbench import program, session, spec; import torch; "
         "cell = spec.load_cell('.', 'rs100-l2.dense.all'); "
         "program.build(cell.config, cell.traffic, None, "
         "torch.device('cpu'))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "No module named 'sptag_tpu_torch'" in out.stderr
