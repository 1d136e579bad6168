"""Small CPU versions of the benchmark's cells for the tests."""

from __future__ import annotations

import copy
import dataclasses
import os
import time

import torch

from annbench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")
# graph settings that build a few thousand rows in seconds on the CPU
SMALL_GRAPH = {"TPTNumber": "2", "CEF": "64", "MaxCheckForRefineGraph": "128",
               "MaxCheck": "256"}


def small_data(config: dict, rows: int, queries: int) -> dict:
    """`config` at `rows` and `queries`: the data set's generator with as
    many samples around each centre as the full one has."""
    config = copy.deepcopy(config)
    spec_ = config["data"]
    per_centre = spec_["samples"] // spec_["centers"]
    samples = rows + queries
    spec_.update(samples=samples, test_size=queries,
                 centers=max(1, samples // per_centre))
    config.update(rows=rows, queries=queries)
    return config


def small_cell(name: str, rows: int = 2000, queries: int = 300,
               batch: int = 64, graph: dict = SMALL_GRAPH) -> spec.Cell:
    """The benchmark's cell `name`, its limits and metrics as committed,
    at a size the CPU runs in seconds (the card keeps the cell's index
    parameters with `graph={}`)."""
    cell = spec.load_cell(ROOT, name)
    config = small_data(cell.config, rows, queries)
    config["index_params"].update(graph)
    traffic = dict(cell.traffic, batch=batch, warmup_batches=1)
    return dataclasses.replace(cell, config=config, traffic=traffic)


def run(cell: spec.Cell, build, seconds: float = 0.5, trace: bool = False,
        seed: int = 2**33 + 5, wrap=None) -> dict:
    from annbench import session

    return session.run(cell, seed, seconds, trace, CPU, time.perf_counter(),
                       build, wrap=wrap)
