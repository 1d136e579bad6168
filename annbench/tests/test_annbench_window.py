"""The window's end-to-end metrics follow what happens inside it, and the
trace reading adds up the card's busy time and names its idle gaps."""

from __future__ import annotations

import re
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from annbench import devtrace, reference, session
from annbench.tests.helpers import run, small_cell

STEP_S = 0.004


def exact_searcher(stall_at=None, stall_s=0.0):
    """A build function whose searcher answers exactly and takes STEP_S a
    call; the call `stall_at` stalls `stall_s` more."""

    def build(config, traffic, corpus, device):
        metric, k = config["distance"], int(config["k"])
        x = reference.prepare(corpus, metric, device)
        calls = [0]

        def search(queries):
            q = reference.prepare(queries, metric, device)
            d, ids = reference.exact_topk(x, q, k, metric)
            time.sleep(STEP_S)
            if calls[0] == stall_at:
                time.sleep(stall_s)
            calls[0] += 1
            return d.numpy(), ids.to(torch.int32).numpy()

        return session.Built(search=search, build_s=0.0)

    return build


def metric(result, name):
    return result["metrics"][name]["value"]


@pytest.fixture(scope="module")
def steady_and_stalled():
    torch.set_num_threads(1)
    cell = small_cell("rs100-l2.beam.one", rows=500, queries=200,
                      batch=16)
    # the window's second call stalls (one warm-up call comes first)
    steady = run(cell, exact_searcher(), seconds=1.0)
    stalled = run(cell, exact_searcher(stall_at=2, stall_s=0.4),
                  seconds=1.0)
    return steady, stalled


def test_a_stall_in_the_window_lowers_qps(steady_and_stalled):
    steady, stalled = steady_and_stalled
    assert steady["correct"] and stalled["correct"]
    assert metric(stalled, "qps") < 0.8 * metric(steady, "qps")


def test_a_stall_raises_the_tail_once_enough_calls_stall():
    torch.set_num_threads(1)
    # the tail is reported where single queries are timed one by one
    cell = small_cell("rs100-l2.beam.one", rows=500, queries=200,
                      batch=16)
    stalls = set(range(2, 400, 10))        # one call in ten

    def build(config, traffic, corpus, device):
        inner = exact_searcher()(config, traffic, corpus, device)
        calls = [0]

        def search(queries):
            out = inner.search(queries)
            if calls[0] in stalls:
                time.sleep(0.05)
            calls[0] += 1
            return out

        return session.Built(search=search, build_s=0.0)

    steady = run(cell, exact_searcher(), seconds=1.0)
    stalled = run(cell, build, seconds=1.0)
    assert metric(stalled, "batch_p95_ms") > metric(steady,
                                                    "batch_p95_ms") + 30
    assert metric(stalled, "qps") < metric(steady, "qps")


def test_recall_of_exact_answers_is_one(steady_and_stalled):
    steady, _ = steady_and_stalled
    assert metric(steady, "recall_at_10") == 1.0
    assert steady["checks"]["dist_gap"]["value"] < 1e-6
    assert steady["failed"] == 0
    assert steady["attempted"] == steady["judged_rows"]


def test_a_call_that_raises_is_unanswered_and_not_correct():
    torch.set_num_threads(1)
    cell = small_cell("rs100-l2.beam.all", rows=500, queries=200,
                      batch=16)

    def wrap(search):
        calls = [0]

        def broken(queries):
            calls[0] += 1
            if calls[0] == 5:
                raise RuntimeError("planted")
            return search(queries)
        return broken

    r = run(cell, exact_searcher(), seconds=0.3, wrap=wrap)
    assert r["failed"] == 16 and r["checks"]["unanswered"]["value"] == 16
    assert r["correct"] is False


class FakeEvent:
    """A kineto event as torch versions without `activity_type` show it."""

    def __init__(self, name, start, end, device=DeviceType.CUDA, thread=1):
        self._n, self._s, self._e = name, start, end
        self._d, self._t = device, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def start_thread_id(self):
        return self._t


def test_device_ops_union_and_idle_names():
    cpu = DeviceType.CPU
    events = [
        FakeEvent(devtrace.WINDOW, 0, 100, cpu),
        FakeEvent(devtrace.BATCH, 0, 60, cpu),
        FakeEvent("aten::sort", 5, 30, cpu),
        FakeEvent("cudaLaunchKernel", 10, 12, cpu),
        FakeEvent("cudaLaunchKernel", 40, 41, cpu, thread=2),
        FakeEvent(devtrace.BATCH, 0, 60),           # the card's copy of it
        FakeEvent("void walk_score_kernel<0>(float*)", 12, 20),
        FakeEvent("Memcpy DtoH (Device -> Pinned)", 18, 25),
        FakeEvent("void block_major_f32_kernel(float*)", 70, 80),
    ]
    ops = devtrace.device_ops(events)
    assert [op.kind for op in ops] == ["kernel", "gpu_memcpy", "kernel"]
    assert devtrace.arith.union_seconds(
        (op.start_ns, op.end_ns) for op in ops) == 23
    idle = devtrace.idle_by_host(events)
    # gaps 0-12 (the batch range open), 25-70 (inside aten::sort, open
    # until 30), 80-100 (nothing open); the other thread's launch and the
    # card's copy of the batch range are no host of this window
    assert idle == pytest.approx({
        devtrace.BATCH: 12 / 1e9, "aten::sort": 45 / 1e9,
        "host outside any operator": 20 / 1e9})


def test_trace_reading_per_layer(monkeypatch):
    ops = [devtrace.DeviceOp("kernel", "void walk_seed_kernel<1>()", 0,
                             2_000_000),
           devtrace.DeviceOp("kernel", "void at::native::sort()", 0, 100),
           devtrace.DeviceOp("gpu_memcpy", "Memcpy HtoD", 0, 100)]
    reading = devtrace.TraceReading(window_s=1.0, busy_s=0.25, batches=2,
                                    ops=ops, idle_by_host={"x": 0.75})
    from annbench import layers

    run_ = SimpleNamespace(trace=reading)
    assert layers.kernels_per_batch(reading, layers.WALK) == 1.0
    assert layers.kernel_ms_per_batch(reading, layers.WALK) == 1.0
    # a layer that ran no kernel in the window reads nothing
    assert layers.kernels_per_batch(
        reading, re.compile(r"block_major_\w*kernel")) is None
    assert layers.kernel_ms_per_batch(None, layers.WALK) is None
    from annbench import spec
    from annbench.tests.helpers import ROOT

    idle = spec.load_reader(ROOT, "device_idle_share")
    assert idle(run_) == pytest.approx(0.75)
    bd = reading.breakdown()
    assert [name for name, _ in bd["device_ops"]][0].startswith(
        "void walk_seed")
    assert bd["idle_gaps"] == [["x", 0.75]]


def test_traced_run_on_the_cpu_reads_a_window():
    torch.set_num_threads(1)
    cell = small_cell("rs100-l2.beam.one", rows=500, queries=200,
                      batch=16)
    cell.traffic["trace_seconds"] = 0.2
    r = run(cell, exact_searcher(), seconds=0.5, trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] >= 0.2
    # no card: nothing busy, and the walk's metrics find nothing to read
    assert r["metrics"]["device_idle_share"]["value"] == 1.0
    assert "walk_kernel_ms" not in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert np.isfinite(r["metrics"]["build_s"]["value"])
