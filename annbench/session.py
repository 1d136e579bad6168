"""One run of one cell: data, set-up, warm-up, the window, the judgement
and the metrics.

The traffic is a closed loop with one client: batches of the traffic's
`batch` queries cut in order from the configuration's query set (in the
seed's order), wrapping around, each sent when the previous answer is
back.  Every call is timed
on the host clock from the call to the numpy answers; the window runs
from the first timed call until the call that ends past `seconds`, and
its length is the time to the end of that call.

The searcher is built by a `build` function: `program.build` (the port)
in every run of the benchmark, `build_control` (the reference in the
program's place, in TF32) in the control runs of `control.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from annbench import arith, data, devtrace, judge, reference
from annbench.spec import Cell

# the host and card session of a traced run lasts from one call until the
# call that ends this many seconds later (one call of a whole query set,
# some tens of single queries)
HOST_TRACE_S = 0.25


@dataclasses.dataclass
class Built:
    """A searcher and how long it took to build."""

    search: Callable[[np.ndarray], tuple]
    build_s: Optional[float] = None
    build_stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    guard: Any = None          # held while the profiler turns on and off


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader reads."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    build_s: Optional[float]
    latencies_s: List[float]
    answered: int
    window_s: float
    recall: float
    trace: Optional[devtrace.TraceReading]


def build_control(config: dict, traffic: dict, corpus: np.ndarray,
                  device: torch.device) -> Built:
    """The control: the reference's exact search, its dot products in TF32,
    in the program's place."""
    metric, k = config["distance"], int(config["k"])
    x = reference.prepare(corpus, metric, device)

    def search(queries: np.ndarray):
        q = reference.prepare(queries, metric, device)
        d, ids = reference.exact_topk(x, q, k, metric, precision="tf32")
        return d.cpu().numpy(), ids.to(torch.int32).cpu().numpy()

    return Built(search=search)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        build: Callable[..., Built],
        wrap: Optional[Callable] = None, log=sys.stderr) -> dict:
    """One run; the result object the last line prints.  `wrap`, when
    given, wraps the built search function (the tests plant faults with
    it)."""
    config, traffic = cell.config, cell.traffic
    if traffic.get("loop") != "closed" or int(traffic.get("clients")) != 1:
        raise ValueError("the generator drives a closed loop of one client")
    marks = {"start": time.perf_counter() - t_start}
    reference.set_full_float32()
    corpus, queries = data.make(config, seed)
    marks["data"] = time.perf_counter() - t_start
    built = build(config, traffic, corpus, device)
    marks["build"] = time.perf_counter() - t_start
    if built.build_stages:
        print("annbench build_stages", built.build_stages, file=log)
    search = wrap(built.search) if wrap is not None else built.search

    B, nq = int(traffic["batch"]), len(queries)
    if B > nq:
        raise ValueError("a batch larger than the query set")
    # the query set with its head repeated, so every batch is one slice
    ring = np.concatenate([queries, queries[:B]])
    for i in range(int(traffic.get("warmup_batches", 1))):
        s = (i * B) % nq
        search(ring[s:s + B])
    _sync(device)
    marks["warmup"] = time.perf_counter() - t_start
    print("annbench set-up, seconds since start at the end of each step:",
          {k: round(v, 3) for k, v in marks.items()}, file=log)

    cuda = device.type == "cuda"
    dev_tw = devtrace.DeviceWindow(cuda, built.guard) if trace else None
    host_tw = devtrace.HostWindow(cuda, built.guard) if trace else None
    trace_s = float(traffic.get("trace_seconds", seconds))
    answers = judge.Answers()
    latencies: List[float] = []
    unanswered = attempted = i = 0
    setup_s = time.perf_counter() - t_start
    tracing = dev_tw                  # the session open, if any
    if tracing is not None:
        tracing.start()
    w0 = time.perf_counter()
    while True:
        s = (i * B) % nq
        t0 = time.perf_counter()
        try:
            with tracing.batch() if tracing is not None else \
                    contextlib.nullcontext():
                d, ids = search(ring[s:s + B])
        except Exception as e:                      # noqa: BLE001
            d = ids = None
            print(f"annbench: call {i} raised {e!r}", file=log)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        attempted += B
        if ids is None:
            unanswered += B
        else:
            answers.add(s, d, ids)
        i += 1
        if tracing is not None and tracing is dev_tw and t1 - w0 >= trace_s:
            dev_tw.stop()
            tracing = host_tw
            host_tw.start()
            h0 = time.perf_counter()
        elif tracing is not None and tracing is host_tw \
                and t1 - h0 >= HOST_TRACE_S:
            host_tw.stop()
            tracing = None
        if t1 - w0 >= seconds and tracing is None:
            break
    window_s = t1 - w0

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if cuda else 0)
    reading = None
    if trace:
        reading = dev_tw.read()
        if reading is not None:
            reading.idle_by_host = host_tw.read()
        del dev_tw, host_tw, tracing
    # the program's state goes before the reference runs
    build_s = built.build_s
    del built, search
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge.judge(answers, unanswered, corpus, queries,
                          config["distance"], int(config["k"]), device)
    answered = answers.rows
    del answers

    record = RunRecord(cell=cell.name, config=config, traffic=traffic,
                       setup_s=setup_s, build_s=build_s,
                       latencies_s=latencies,
                       answered=answered, window_s=window_s,
                       recall=verdict.recall, trace=reading)
    metrics = {}
    for m in cell.metrics(trace):
        value = m.read(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": verdict.correct(cell.limits),
              "attempted": attempted, "failed": unanswered,
              "metrics": metrics, "device": dev}
    if reading is not None:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
        result["breakdown"] = reading.breakdown()
    # the median call beside the tail; in a traced run, a traced call's
    # mean, which gives the tracing's cost
    result["diag"] = {"p50_ms": arith.percentile(latencies, 50) * 1e3}
    if reading is not None:
        result["diag"]["traced_batch_ms"] = \
            reading.window_s / reading.batches * 1e3
    result["judged_rows"] = verdict.judged_rows
    result["batches"] = len(latencies)
    result["checks"] = verdict.checks(cell.limits)
    return result
