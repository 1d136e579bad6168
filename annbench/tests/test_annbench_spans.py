"""The per-layer metrics that read the program's own spans and counters
(`annbench/spans.py`), and the traced window's naming of idle gaps by the
program's spans."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from annbench import devtrace, program, spec
from annbench.tests.helpers import ROOT, run, small_cell

NEW = ("tree_build_s", "graph_build_s", "front_end_ms",
       "walk_bodies_per_batch", "host_ms_per_batch")


@pytest.fixture(autouse=True)
def fresh_registries():
    from sptag_tpu_torch.utils import metrics, trace

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    metrics.reset()
    yield
    trace.reset()
    metrics.reset()
    torch.set_num_threads(before)


def readers():
    return {name: spec.load_reader(ROOT, name) for name in NEW}


def test_idle_gaps_are_named_by_the_innermost_port_span():
    """A gap where the host runs Python between operators is named by the
    port's span open at its start, not by the benchmark's call range."""
    host = [(0, 100, devtrace.BATCH), (5, 95, "search.call"),
            (10, 80, "search.dispatch"), (20, 70, "walk.iterate"),
            (30, 40, "walk.merge"), (32, 34, "aten::cat"),
            (82, 90, "search.readback")]
    gaps = [(33, 35), (36, 38), (45, 50), (75, 78), (85, 88), (96, 99)]
    idle = devtrace._idle_by_host(gaps, host)
    assert idle == pytest.approx({
        "aten::cat": 2e-9, "walk.merge": 2e-9, "walk.iterate": 5e-9,
        "search.dispatch": 3e-9, "search.readback": 3e-9,
        devtrace.BATCH: 3e-9})


def test_the_readers_read_a_populated_registry_and_nothing_without():
    from sptag_tpu_torch.utils import trace

    read = readers()
    assert {n: r(None) for n, r in read.items()} == dict.fromkeys(NEW)
    cell = small_cell("rs100-l2.beam.one", rows=1500, queries=100,
                      batch=4)
    built = program.build(cell.config, cell.traffic,
                          np.random.default_rng(3).standard_normal(
                              (1500, 100)).astype(np.float32),
                          torch.device("cpu"))
    queries = np.random.default_rng(4).standard_normal(
        (8, 100)).astype(np.float32)
    for lo in (0, 4):
        built.search(queries[lo:lo + 4])
    got = {n: r(None) for n, r in read.items()}
    assert None not in got.values(), got
    rep = trace.report()
    assert got["tree_build_s"] == rep["build.bkt_tree"]["total_s"] > 0
    assert got["graph_build_s"] == rep["build.rng_graph"]["total_s"] > 0
    assert got["walk_bodies_per_batch"] > 0
    assert 0 < got["front_end_ms"] < rep["search.call"]["total_s"] * 1e3
    # the host's part of a call holds the front end's and lies within it
    call_ms = (rep["search.call"]["total_s"] / rep["search.call"]["count"]
               * 1e3)
    assert got["front_end_ms"] <= got["host_ms_per_batch"] <= call_ms
    # without the port's modules loaded, nothing
    saved = {m: sys.modules.pop(m) for m in
             ("sptag_tpu_torch.utils.trace",
              "sptag_tpu_torch.utils.metrics")}
    try:
        assert {n: r(None) for n, r in read.items()} == dict.fromkeys(NEW)
    finally:
        sys.modules.update(saved)


def test_a_dense_only_index_has_no_graph_and_no_walk_to_read():
    read = readers()
    cell = small_cell("rs100-l2.dense.all", rows=1500, queries=100,
                      batch=4)
    built = program.build(cell.config, cell.traffic,
                          np.random.default_rng(3).standard_normal(
                              (1500, 100)).astype(np.float32),
                          torch.device("cpu"))
    built.search(np.zeros((4, 100), np.float32))
    got = {n: r(None) for n, r in read.items()}
    assert got["graph_build_s"] is None
    assert got["walk_bodies_per_batch"] is None
    assert got["tree_build_s"] > 0 and got["front_end_ms"] > 0


def test_a_traced_run_reports_the_new_metrics_in_its_cells():
    cell = small_cell("rs100-l2.beam.one", rows=1500, queries=100,
                      batch=4)
    cell.traffic["trace_seconds"] = 0.2
    r = run(cell, program.build, seconds=0.4, trace=True)
    assert r["correct"], r["checks"]
    for name in NEW:
        assert name in r["metrics"], name
    assert r["metrics"]["walk_bodies_per_batch"]["unit"] == "bodies/batch"


def test_the_new_metrics_are_reported_in_their_cells_only():
    bench = spec._load_json(f"{ROOT}/{spec.BENCH_FILE}")
    listed = {m["name"]: m["workloads"] for m in bench["per_layer"]
              if m["name"] in NEW}
    walks = ["rs100-l2.beam.all", "rs100-cos.beam.all", "rs100-l2.beam.one"]
    assert listed == {
        "tree_build_s": walks[:2] + ["rs100-l2.dense.all", walks[2]],
        "graph_build_s": walks, "front_end_ms": walks[2:],
        "walk_bodies_per_batch": walks[2:], "host_ms_per_batch": walks[2:]}
