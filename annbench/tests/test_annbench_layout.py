"""The harness finds a cell's parts by name, and BENCHMARK.json keeps to
the benchmark's contract."""

from __future__ import annotations

import json
import os
import re
import shutil
import time

import pytest
import torch

from annbench import session, spec
from annbench.tests.helpers import CPU, ROOT, small_data
from annbench.tests.test_annbench_window import exact_searcher

BENCH = json.load(open(os.path.join(ROOT, spec.BENCH_FILE)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_new_cell_configuration_traffic_and_metric_are_found_by_name(
        tmp_path):
    """Files written beside a copy of the harness, and entries in its
    BENCHMARK.json, make a new cell run, with no edit to code."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "annbench"), root / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    config = small_data(json.load(open(os.path.join(
        ROOT, "annbench/configs/random-s-100-euclidean-bkt.json"))),
        rows=300, queries=40)
    config.update(name="tiny-l2", dimension=8)
    (root / "annbench/configs/tiny-l2.json").write_text(json.dumps(config))
    (root / "annbench/traffic/exact.b8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 8,
         "warmup_batches": 1}))
    (root / "annbench/workloads/tiny.exact.b8.json").write_text(json.dumps(
        {"limits": {"dist_gap": 1e-5, "recall_miss": 0.0, "bad_answers": 0,
                    "unanswered": 0}}))
    (root / "annbench/metrics/batches_done.py").write_text(
        "def read(run):\n    return len(run.latencies_s)\n")
    bench["configs"].append({"name": "tiny-l2", "source": "test",
                             "file": "annbench/configs/tiny-l2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.exact.b8", "config": "tiny-l2",
                               "traffic": "exact.b8", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "batches_done", "unit": "batches",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny.exact.b8"]})
    (root / spec.BENCH_FILE).write_text(json.dumps(bench))

    cell = spec.load_cell(str(root), "tiny.exact.b8")
    assert cell.config["rows"] == 300 and cell.traffic["batch"] == 8
    names = [m.name for m in cell.end_to_end]
    assert names == ["recall_at_10", "setup_s", "batches_done"]
    torch.set_num_threads(1)
    r = session.run(cell, 11, 0.2, False, CPU, time.perf_counter(),
                    exact_searcher())
    assert r["correct"]
    assert r["metrics"]["batches_done"]["value"] == r["batches"] > 1
    assert r["metrics"]["batches_done"]["unit"] == "batches"
    with pytest.raises(KeyError):
        spec.load_cell(str(root), "no.such.cell")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["annbench"]
    assert BENCH["command"] == ["python3", "annbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound",
                                       "source"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves"})):
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in BENCH["end_to_end"] +
                    BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configurations_are_files_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("annbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        config = json.load(open(os.path.join(ROOT, c["file"])))
        assert config["name"] == c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in config
            assert not key.endswith(("_dim", "_rank"))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files_and_metrics(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert w["chips"] == 1
    c = spec.load_cell(ROOT, cell)
    e2e = [m.name for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e or cell not in m.get("workloads", [cell])
    assert set(c.limits) == {"dist_gap", "recall_miss", "bad_answers",
                             "unanswered"}
    assert 0 < c.limits["recall_miss"] < 1
    assert c.limits["bad_answers"] == c.limits["unanswered"] == 0
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
        for cell in m["workloads"]:
            assert cell in CELLS
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in by_layer:
        assert f"**{layer}**" in perf, layer
