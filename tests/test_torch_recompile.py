"""The port's recompile guard and trace/transfer sentinel
(sptag_tpu_torch/utils/recompile_guard.py), and the device-time sampling
and roofline attribution of the engine and the slot scheduler.

On the card a "compile" is a CUDA-graph capture or an nvcc build; here a
capture is rehearsed through the scheduler's capture hook with a fake
graph whose replay re-runs the captured segment (the card tests capture
real graphs), and a build through a stubbed nvcc.  An implicit sync needs
a CUDA tensor: here a Tensor subclass that reports ``is_cuda`` stands in
for one (tests/test_torch_cuda.py flags a real one).
"""

import os

import numpy as np
import pytest
import torch

import sptag_tpu_torch as tsp
from sptag_tpu_torch import _build
from sptag_tpu_torch.algo.engine import STATE_KEYS
from sptag_tpu_torch.algo.scheduler import BeamSlotScheduler
from sptag_tpu_torch.utils import flightrec, metrics
from sptag_tpu_torch.utils import recompile_guard as rg
from sptag_tpu_torch.utils import roofline

D = 8


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("SPTAG_TRACESAN", "")
    rg.reset_tracesan()
    yield
    rg.reset_tracesan()
    torch.set_num_threads(n)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    cent = np.random.default_rng(99).standard_normal((8, D)) * 4.0
    return np.round((cent[rng.integers(0, 8, n)]
                     + rng.standard_normal((n, D))) * 2).astype(np.float32)


DATA = _rows(400, 1)
QUERIES = _rows(12, 2)


@pytest.fixture(scope="module")
def index():
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    for name, value in (("DistCalcMethod", "L2"), ("TPTNumber", "2"),
                        ("CEF", "32"), ("MaxCheckForRefineGraph", "64"),
                        ("NeighborhoodSize", "8"), ("BKTKmeansK", "8"),
                        ("FinalRefineSearchMode", "same"),
                        ("RefineIterations", "1"), ("SearchMode", "beam")):
        assert idx.set_parameter(name, value), name
    assert idx.build(DATA) == tsp.ErrorCode.Success
    yield idx
    idx.close()


class _FakeGraph:
    def __init__(self, fn):
        self.replay = fn


class _CapturingScheduler(BeamSlotScheduler):
    """A scheduler whose 'capture' records the segment as a closure and
    whose replay re-runs it over the static buffers (the card captures a
    CUDA graph of the same closure)."""

    def _capture(self, pool):
        engine = self._engine
        bufs = {n: a.clone() for n, a in pool.state.items() if a is not None}
        t_in = pool.t_limit.clone()
        alive_out = torch.zeros(pool.capacity, dtype=torch.bool)

        def segment():
            state = {n: bufs.get(n) for n in pool.state}
            new, alive = engine.run_segment(
                state, t_in, pool.k_eff, pool.L, pool.B, pool.nbp_limit,
                pool.seg_iters, inject=pool.inject, check_alive=False)
            for n in STATE_KEYS:
                if new[n] is not bufs[n]:
                    bufs[n].copy_(new[n])
            alive_out.copy_(alive)
        return _FakeGraph(segment), bufs, t_in, alive_out


def test_capture_counted_inside_track_compiles(index):
    rg.enable_tracesan()
    engine = index._get_engine()
    want_d, want_i = engine.search(QUERIES, 5, max_check=128)
    sched = _CapturingScheduler(engine, slots=16, segment_iters=2)
    sched._graph_max_slots = 256
    try:
        with rg.track_compiles("warm") as warm:
            for _ in range(2):           # a key is captured at its second run
                d, i = sched.search_batch(QUERIES, 5, 128)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_array_equal(d, want_d)
        assert warm.count >= 1 and warm.kinds == {rg.CAPTURE: warm.count}
        assert sched.stats()["segments_replayed"] > 0
        counts = rg.compile_counts()
        assert counts.get("scheduler.cycle", 0) == warm.count
        rg.set_compile_budget("scheduler.cycle", warm.count)
        with rg.no_recompiles("steady"):
            d2, i2 = sched.search_batch(QUERIES, 5, 128)
        np.testing.assert_array_equal(i2, want_i)
        assert rg.tracesan_counters()["budget_trips"] == 0
        assert rg.violation_count() == 0
    finally:
        sched.stop()
    with pytest.raises(rg.RecompileError, match="compile"):
        with rg.no_recompiles("tripped"):
            rg.note_compile(rg.CAPTURE, 0.01)
    assert "cuda.compile[warm]" in __import__(
        "sptag_tpu_torch.utils.trace", fromlist=["x"]).report()


def test_budget_trip_raises_in_strict_mode():
    rg.enable_tracesan(strict=True, compile_budget=0)
    with rg.hot_section("scheduler.seed"):
        with pytest.raises(rg.CompileBudgetError, match="scheduler.seed"):
            rg.note_compile(rg.BUILD, 0.5)
    assert rg.tracesan_counters()["budget_trips"] == 1
    # non-strict: counted and logged, not raised
    rg.reset_tracesan()
    rg.enable_tracesan(strict=False)
    rg.set_compile_budget("fam", 1)
    with rg.hot_section("fam"):
        rg.note_compile(rg.CAPTURE, 0.1)
        rg.note_compile(rg.CAPTURE, 0.1)
    assert rg.compile_counts() == {"fam": 2}
    assert rg.tracesan_counters()["budget_trips"] == 1
    # outside any section a compile is counted by windows only
    with rg.track_compiles("w") as log:
        rg.note_compile(rg.BUILD, 0.2)
    assert log.count == 1 and rg.compile_counts() == {"fam": 2}
    assert rg.warmup_then_guard(lambda x: x + 1, 1) == 2


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_device_get_is_blessed_and_implicit_syncs_are_flagged():
    t = torch.arange(4).as_subclass(_OnCard)
    rg.enable_tracesan(strict=False)
    with rg.hot_section("scheduler.cycle"):
        got = rg.device_get((t, {"x": t}))
        assert rg.violation_count() == 0
        assert isinstance(got[0], np.ndarray)
        np.testing.assert_array_equal(got[1]["x"], np.arange(4))
        t[1].item()
        bool(t[1])
        t.tolist()
    assert rg.violation_count() == 3
    assert [v["kind"] for v in rg.violations()] == ["item", "bool", "tolist"]
    assert rg.violations()[0]["section"] == "scheduler.cycle"
    t[2].item()                          # no hot section: not a violation
    torch.arange(3)[0].item()            # a CPU tensor never counts
    assert rg.violation_count() == 3
    rg.enable_tracesan(strict=True)
    with rg.hot_section("engine.walk"):
        with pytest.raises(rg.TransferSyncError, match="engine.walk"):
            int(t[0])
        rg.device_get(t)


def test_shims_gone_after_reset_and_off_when_disarmed():
    orig = {attr: getattr(torch.Tensor, attr) for _, attr in rg._SHIMMED}
    in_dict = {attr for _, attr in rg._SHIMMED
               if attr in torch.Tensor.__dict__}
    with rg.hot_section("x"):            # disarmed: nothing installed
        pass
    assert not rg.shims_installed()
    rg.enable_tracesan()
    with rg.hot_section("x"):
        pass
    assert rg.shims_installed()
    assert torch.Tensor.item is not orig["item"]
    rg.reset_tracesan()
    assert not rg.shims_installed()
    for attr, fn in orig.items():
        assert getattr(torch.Tensor, attr) is fn, attr
    assert {attr for _, attr in rg._SHIMMED
            if attr in torch.Tensor.__dict__} == in_dict
    rg.enable_tracesan()
    with rg.hot_section("x"):
        pass
    rg.disable_tracesan()
    assert not rg.shims_installed() and not rg.tracesan_enabled()


def test_nvcc_build_is_counted(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")

    class _Done:
        returncode, stdout, stderr = 0, "ptxas info", ""

    def fake_run(cmd, capture_output, text):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")
        return _Done()

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    with rg.track_compiles("build") as log:
        path, _ = _build.build("sketch_dots")
        _build.build("sketch_dots")      # built already: no compile
    assert os.path.exists(path)
    assert log.kinds == {rg.BUILD: 1}


def test_sampled_segments_set_the_roofline_gauges(index, monkeypatch):
    monkeypatch.setattr(roofline, "run_probe", lambda device=None: {
        "peak_flops_f32": 1e15, "hbm_gbps": 1e6})
    monkeypatch.setenv("SPTAG_TPU_ROOFLINE_CACHE_S", "0")
    monkeypatch.setattr(roofline, "PROBE_CACHE_S", 0.0)
    roofline.reset()
    metrics.reset()
    for name, value in (("FlightDeviceSampleRate", "1"),
                        ("RooflineProbe", "1"), ("BeamSegmentIters", "2")):
        assert index.set_parameter(name, value)
    try:
        index.search_batch(QUERIES, 5, max_check=128)
        assert metrics.histogram_or_none(
            "engine.segment_device_ns").count > 0
        assert metrics.gauge_value("engine.achieved_gflops") > 0
        assert metrics.gauge_value("engine.achieved_gbps") > 0
        pct = metrics.gauge_value("engine.roofline_pct_peak")
        assert 0 < pct <= 100
    finally:
        for name, value in (("FlightDeviceSampleRate", "0"),
                            ("RooflineProbe", "0"),
                            ("BeamSegmentIters", "0")):
            index.set_parameter(name, value)
        roofline.reset()


def test_retired_queries_carry_their_roofline_attribution(index,
                                                          monkeypatch):
    monkeypatch.setattr(roofline, "run_probe", lambda device=None: {
        "peak_flops_f32": 1e10, "hbm_gbps": 100.0})
    monkeypatch.setattr(roofline, "PROBE_CACHE_S", 0.0)
    roofline.reset()
    flightrec.reset()
    assert index.set_parameter("RooflineProbe", "1")
    try:
        engine = index._get_engine()
        assert engine._capability.source == "probe"
        sched = BeamSlotScheduler(engine, slots=8, segment_iters=2)
        try:
            futs = [sched.submit(QUERIES[i], 5, 128, rid=f"r{i}")
                    for i in range(4)]
            for f in futs:
                f.result(timeout=60)
        finally:
            sched.stop()
        for i in range(4):
            st = flightrec.query_stats(f"r{i}")
            assert st["gflops"] > 0 and 0 < st["pct_peak"] <= 100, st
            assert st["iters"] >= 1 and st["t_budget"] >= st["iters"]
    finally:
        index.set_parameter("RooflineProbe", "0")
        roofline.reset()
