"""Finding a cell's parts by name.

`BENCHMARK.json`, at the root of the checkout, names each cell's
configuration and traffic and the metrics it reports.  Everything else is
a file of its own under the benchmark's folder, found by name, so a later
cell, configuration, traffic mix or metric is added as files and entries
with no edit to code:

* a configuration: the file its `BENCHMARK.json` entry names (under
  ``annbench/configs/``), the deployment's sizes and index parameters;
* a traffic mix: ``annbench/traffic/<traffic>.json``, the parameters the
  one closed-loop generator (`session.py`) reads;
* a cell's limits: ``annbench/workloads/<cell>.json``, the limit of each
  number `correct` compares, with the readings it was set from;
* a metric: ``annbench/metrics/<metric>.py``, whose ``read(run)`` returns
  the value or None when the run has nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_FILE = "BENCHMARK.json"
FOLDER = "annbench"


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


def load_reader(root: str, name: str) -> Callable:
    """``read`` of ``annbench/metrics/<name>.py``."""
    path = os.path.join(root, FOLDER, "metrics", name + ".py")
    modname = "annbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of ``<root>/BENCHMARK.json`` with its parts; raises
    KeyError for a cell the benchmark does not name."""
    bench = _load_json(os.path.join(root, BENCH_FILE))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {BENCH_FILE}")
    work = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[work["config"]]["file"]))
    traffic = _load_json(os.path.join(root, FOLDER, "traffic",
                                      work["traffic"] + ".json"))
    limits = _load_json(os.path.join(root, FOLDER, "workloads",
                                     name + ".json"))["limits"]

    def metrics(kind: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"], load_reader(root, m["name"]))
                for m in bench[kind] if _applies(m, name)]

    return Cell(name=name, chips=int(work["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))
