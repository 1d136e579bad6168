"""The port's host observability against the JAX package's copies.

The same operation sequence through both packages' modules gives equal
results: the Prometheus text of ``metrics``, the flight recorder's
Perfetto JSON (timestamps, durations and thread ids normalised), a lock
sanitizer order violation and the contention ledger, a ``faultinject``
decision stream, the ticks of ``timeline``, ``qualmon``'s recall and
``trace.report()``.  Then a port subset of tests/test_mutation.py's crash
matrix runs the storage faults on the port's WAL and snapshot saves, and
the scheduler / thread pool / index hooks are held to the JAX package's
metric names.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.utils import faultinject as jfi
from sptag_tpu.utils import flightrec as jflight
from sptag_tpu.utils import locksan as jlock
from sptag_tpu.utils import metrics as jmetrics
from sptag_tpu.utils import qualmon as jqual
from sptag_tpu.utils import timeline as jtime
from sptag_tpu.utils import trace as jtrace
from sptag_tpu_torch.io import atomic as tatomic
from sptag_tpu_torch.io import wal as twal
from sptag_tpu_torch.utils import faultinject as tfi
from sptag_tpu_torch.utils import flightrec as tflight
from sptag_tpu_torch.utils import locksan as tlock
from sptag_tpu_torch.utils import metrics as tmetrics
from sptag_tpu_torch.utils import qualmon as tqual
from sptag_tpu_torch.utils import threadpool as tpool
from sptag_tpu_torch.utils import timeline as ttime
from sptag_tpu_torch.utils import trace as ttrace

def _reset_port():
    for mod in (tmetrics, tflight, tqual, tfi, ttime, ttrace):
        mod.reset()
    tlock.reset_contention()


@pytest.fixture(autouse=True)
def _clean():
    """The port's registries are process-global like the JAX package's
    (which tests/conftest.py resets): start and end every test empty."""
    _reset_port()
    yield
    _reset_port()
    tlock.reset_config()
    jlock.reset_config()


def _ops_metrics(m):
    m.inc("server.requests")
    m.inc("server.requests", 4)
    m.set_gauge("scheduler.occupancy", 0.75)
    for v in (0.0004, 0.002, 0.002, 0.03, 1.5):
        m.observe("scheduler.slot_wait", v)
    m.inc("mutation.wal_appends", 2)
    return m.render_prometheus(), m.snapshot()


def test_prometheus_text_equals_jax():
    jmetrics.reset()
    assert _ops_metrics(tmetrics) == _ops_metrics(jmetrics)


def test_request_id_log_factory_keeps_an_earlier_stamp(monkeypatch):
    """Both packages stamp `record.request_id` through the process-wide
    log-record factory.  The port's factory, installed over another one
    that already stamped a request id (the JAX package's, when a process
    hosts both), keeps that id unless the port has a request id of its
    own, so neither package's stamps are lost to the other's."""
    import logging

    base = logging.getLogRecordFactory()

    def outer(*a, **kw):
        record = base(*a, **kw)
        record.request_id = "outer-rid"
        return record

    monkeypatch.setattr(tmetrics, "_factory_installed", False)
    logging.setLogRecordFactory(outer)
    try:
        tmetrics.install_request_id_logging()
        make = logging.getLogRecordFactory()
        args = ("t", logging.INFO, "p", 1, "m", (), None)
        assert make(*args).request_id == "outer-rid"
        token = tmetrics.set_request_id("port-rid")
        try:
            assert make(*args).request_id == "port-rid"
        finally:
            tmetrics.reset_request_id(token)
    finally:
        logging.setLogRecordFactory(base)


def _ops_flight(f):
    f.configure(enabled=True, max_events=64)
    f.record("server", "decode", "r1", dur_ns=1500)
    f.record("scheduler", "slot_assign", "r1", dur_ns=20_000)
    f.record("scheduler", "segment", payload={"live": 3, "capacity": 4})
    f.record("server", "request", "r1", dur_ns=90_000,
             payload={"status": 0})
    f.record("index", "swap_publish", payload={"rows": 5, "epoch": 2})
    f.note_query_stats("r1", slot_wait_ms=0.02, segments=1)
    # only this thread's events: the recorder is process-wide, and a
    # thread another test left running in this worker may record into it
    me = threading.get_ident()
    trace = f.export_chrome_trace(
        events=[e for e in f.collect() if e["tid"] == me])
    for ev in trace["traceEvents"]:
        for key in ("ts", "dur", "tid"):
            if key in ev:
                ev[key] = 0
        ev.get("args", {}).pop("t_ns", None)
    for ev in trace.get("flightEvents", []):
        ev["t_ns"] = ev["tid"] = 0
    stats = f.query_stats("r1")
    f.configure(enabled=False)
    return json.dumps(trace, sort_keys=True), stats


def test_flight_recorder_perfetto_json_equals_jax():
    jflight.reset()
    assert _ops_flight(tflight) == _ops_flight(jflight)


def _ops_locks(lk, tag):
    lk.enable()
    lk.enable_contention()
    a = lk.make_lock(f"obs.{tag}.A")
    b = lk.make_lock(f"obs.{tag}.B")
    before = lk.inversion_count()
    with a:
        with b:
            pass
    with b:
        with a:                   # the inverted order
            pass
    inv = [{k: r[k] for k in ("held", "acquiring", "established_order")}
           for r in lk.inversions()[before:]]
    ledger = {name: {"acquires": row["acquires"],
                     "contended": row["contended"]}
              for name, row in lk.contention_snapshot().items()
              if name.startswith(f"obs.{tag}.")}
    return (type(a).__name__, lk.inversion_count() - before,
            json.dumps(inv).replace(tag, "*"),
            json.dumps(ledger, sort_keys=True).replace(tag, "*"))


@pytest.mark.locksan_ok
def test_lock_order_violation_and_contention_ledger_equal_jax():
    got = _ops_locks(tlock, "port")
    want = _ops_locks(jlock, "jax")
    assert got == want
    assert got[0] == "SanLock" and got[1] == 1


SPECS = ["drop:p=0.3;delay@server.respond:ms=5,p=0.5",
         "garble@a:p=0.5,n=3;disconnect@b:after=2",
         "torn_write@wal.append:after=1;short_read@wal.read"]


@pytest.mark.parametrize("spec", SPECS)
def test_faultinject_decisions_equal_jax(spec):
    def stream(fi):
        inj = fi.Injector(spec, seed=42)
        out = []
        for i in range(60):
            site = ("server.respond", "a", "b", "wal.append",
                    "wal.read")[i % 5]
            f = inj.decide(site)
            out.append(None if f is None else (f.kind, f.delay_s))
        return out, inj.snapshot()
    assert stream(tfi) == stream(jfi)


def _ops_timeline(m, tl):
    m.reset()
    tl.reset()
    tl.configure(enabled=True, interval_ms=1000.0, capacity=16)
    seen = []
    tl.add_tick_listener(seen.append)
    for step in range(4):
        m.inc("server.requests", 10 * (step + 1))
        m.set_gauge("server.queue_depth", float(step))
        m.observe("server.request", 0.001 * (step + 1))
        tl.sample_now(now=100.0 + step)
    tl.record("canary.recall", 0.9, label="main", now=103.5)
    snap = tl.snapshot()
    tl.remove_tick_listener(seen.append)
    tl.configure(enabled=False)
    # the registry's series (the JAX package also samples labeled
    # families of modules the port does not have yet)
    series = {k: v for k, v in snap["series"].items()
              if k.startswith(("server.", "canary."))}
    return seen, snap["config"], json.dumps(series, sort_keys=True)


def test_timeline_ticks_equal_jax():
    assert _ops_timeline(tmetrics, ttime) == _ops_timeline(jmetrics, jtime)


def test_recall_equals_jax():
    rng = np.random.default_rng(3)
    truth = rng.integers(0, 50, (20, 10))
    ids = np.where(rng.random((20, 10)) < 0.7, truth,
                   rng.integers(0, 50, (20, 10)))
    dists = rng.random((20, 10)).astype(np.float32)
    for k in (1, 5, 10):
        assert tqual.recall_at_k(ids, truth, k) == \
            jqual.recall_at_k(ids, truth, k)
        for r in range(20):
            args = (ids[r], truth[r], k)
            kw = dict(dists=dists[r], truth_dists=np.sort(dists[r]))
            assert tqual.recall_row(*args) == jqual.recall_row(*args)
            assert tqual.recall_row(*args, **kw) == \
                jqual.recall_row(*args, **kw)


def test_trace_report_equals_jax():
    def ops(tr, m):
        m.reset()
        tr.reset()
        for name, secs in (("server.queue_wait", 0.002),
                           ("server.request", 0.010),
                           ("server.queue_wait", 0.004)):
            tr.record(name, secs)
        return tr.report()
    assert ops(ttrace, tmetrics) == ops(jtrace, jmetrics)


def test_trace_span_marks_a_torch_profile(tmp_path):
    """A live trace turns spans into record_function ranges of the Chrome
    trace `stop_trace` writes."""
    ttrace.start_trace(str(tmp_path))
    with ttrace.span("server.execute_batch"):
        torch.ones(4).sum()
    path = ttrace.stop_trace()
    with open(path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "server.execute_batch" in names
    assert ttrace.report()["server.execute_batch"]["count"] == 1
    assert ttrace.stop_trace() is None


def test_profiler_turns_on_and_off_under_the_capture_lock(tmp_path,
                                                           monkeypatch):
    """start_trace / stop_trace start and stop the profiler holding the
    one capture lock the walk's graph captures take, so no capture runs
    while the profiler's state changes."""
    import torch.profiler

    from sptag_tpu_torch.algo import engine as teng

    assert teng.capture_lock is ttrace.capture_lock
    seen = []

    class Profile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            seen.append(("enter", ttrace.capture_lock.locked()))

        def __exit__(self, *exc):
            seen.append(("exit", ttrace.capture_lock.locked()))

        def export_chrome_trace(self, path):
            open(path, "w").close()

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    ttrace.start_trace(str(tmp_path))
    assert ttrace.tracing() and not ttrace.capture_lock.locked()
    ttrace.stop_trace()
    assert seen == [("enter", True), ("exit", True)]
    assert not ttrace.tracing() and not ttrace.capture_lock.locked()
    # without CUDA there is nothing to prepare, and no lock is left held
    ttrace.prepare_device_trace()
    assert seen == [("enter", True), ("exit", True)]
    assert not ttrace.tracing() and not ttrace.capture_lock.locked()


def test_no_graph_is_captured_while_a_trace_runs(tmp_path):
    """While a trace holds the profiler, the walk's whole-walk capture
    and the scheduler's segment capture decline (None: the caller runs
    eagerly) before they touch the card; after it they capture again."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.algo import scheduler as tsched

    ttrace.start_trace(str(tmp_path))
    try:
        assert teng.GraphSearchEngine._capture(None, None, None, None) \
            is None
        assert tsched.BeamSlotScheduler._capture(None, None) is None
    finally:
        ttrace.stop_trace()
    with pytest.raises(AttributeError):
        teng.GraphSearchEngine._capture(None, None, None, None)


# ---- the crash matrix on the port's WAL (tests/test_mutation.py) ---

RNG = np.random.default_rng(0xA5)
D = 8
DATA = RNG.standard_normal((48, D)).astype(np.float32)


def _flat():
    idx = tsp.create_instance("FLAT", "Float", device="cpu")
    idx.set_parameter("DistCalcMethod", "L2")
    idx.set_parameter("WalEnabled", "1")
    assert idx.build(DATA) == tsp.ErrorCode.Success
    return idx


def _saved_flat(folder):
    idx = _flat()
    assert idx.save_index(str(folder)) == tsp.ErrorCode.Success
    return idx


def _expect_crash(fn):
    with pytest.raises(tfi.InjectedCrash):
        fn()
    tfi.configure("")


def test_crash_matrix_mid_wal_append(tmp_path):
    folder = tmp_path / "idx"
    idx = _saved_flat(folder)
    r1 = RNG.standard_normal((1, D)).astype(np.float32)
    r2 = RNG.standard_normal((1, D)).astype(np.float32)
    assert idx.add(r1) == tsp.ErrorCode.Success          # acked
    tfi.configure("torn_write@wal.append")
    _expect_crash(lambda: idx.add(r2))                   # not acked
    loaded = tsp.load_index(str(folder), device="cpu")
    assert loaded.num_samples == 49
    _, ids = loaded.search_batch(r1, 1)
    assert ids[0, 0] == 48
    assert tatomic.verify_manifest(str(folder)) > 0
    assert tmetrics.counter_value("mutation.wal_torn_tails") == 1


def test_crash_matrix_mid_snapshot_blob(tmp_path):
    folder = tmp_path / "idx"
    idx = _saved_flat(folder)
    idx.add(RNG.standard_normal((1, D)).astype(np.float32))
    tfi.configure("torn_write@snapshot.write:after=1")
    _expect_crash(lambda: idx.save_index(str(folder)))
    assert tsp.load_index(str(folder), device="cpu").num_samples == 49


def test_crash_matrix_pre_rename(tmp_path):
    folder = tmp_path / "idx"
    idx = _saved_flat(folder)
    idx.add(RNG.standard_normal((1, D)).astype(np.float32))
    tfi.configure("crash@save.pre_rename")
    _expect_crash(lambda: idx.save_index(str(folder)))
    assert tsp.load_index(str(folder), device="cpu").num_samples == 49


def test_crash_matrix_post_rename(tmp_path):
    folder = tmp_path / "idx"
    idx = _saved_flat(folder)
    idx.add(RNG.standard_normal((1, D)).astype(np.float32))
    tfi.configure("crash@save.post_rename")
    _expect_crash(lambda: idx.save_index(str(folder)))
    # the swap landed: the add is in the snapshot and the log is fresh,
    # so the replay must not apply it twice
    loaded = tsp.load_index(str(folder), device="cpu")
    assert loaded.num_samples == 49
    assert loaded.mutation_state()["acked_writes"] == 0
    records, _ = twal.replay(str(folder / twal.WAL_NAME))
    assert records == []


def test_crash_matrix_fresh_save_interrupted(tmp_path):
    folder = tmp_path / "fresh"
    idx = _flat()
    tfi.configure("crash@save.pre_rename")
    _expect_crash(lambda: idx.save_index(str(folder)))
    assert not os.path.exists(str(folder / "indexloader.ini"))
    loaded = tsp.load_index(str(folder), device="cpu")    # heals
    assert loaded.num_samples == 48


def test_short_read_of_the_manifest_fails_the_load(tmp_path):
    folder = tmp_path / "idx"
    _saved_flat(folder)
    tfi.configure("short_read@snapshot.read")
    with pytest.raises(tatomic.ManifestError):
        tsp.load_index(str(folder), device="cpu")


# ---- the hooks in the port's classes -------------------------------

def test_threadpool_lock_is_sanitized_and_leaks_are_counted():
    tlock.enable()
    pool = tpool.ThreadPool("obs-pool")
    assert type(pool._lock).__name__ == "SanLock"
    tlock.reset_config()
    release = threading.Event()
    pool.init(1)
    pool.add(lambda: release.wait(10))
    pool.stop(join_timeout_s=0.05)
    assert tmetrics.counter_value("threadpool.leaked_workers") == 1
    release.set()


def test_index_scheduler_and_delta_are_race_tracked():
    from sptag_tpu_torch.algo.scheduler import BeamSlotScheduler
    from sptag_tpu_torch.core.delta import DeltaShard
    from sptag_tpu_torch.core.index import VectorIndex

    for cls in (VectorIndex, BeamSlotScheduler, DeltaShard):
        assert cls in tlock._race_classes
    tlock.enable_racesan()
    try:
        assert "__setattr__" in VectorIndex.__dict__
        assert "__setattr__" in BeamSlotScheduler.__dict__
    finally:
        tlock.disable_racesan()
    assert "__setattr__" not in VectorIndex.__dict__


def _graph_index(pkg, data, **kw):
    idx = pkg.create_instance("BKT", "Float", **kw)
    for name, value in [("DistCalcMethod", "L2"), ("TPTNumber", "2"),
                        ("TPTLeafSize", "200"), ("CEF", "32"),
                        ("MaxCheckForRefineGraph", "64"),
                        ("NeighborhoodSize", "8"), ("BKTKmeansK", "4"),
                        ("MaxCheck", "256"), ("RefineIterations", "1"),
                        ("FinalRefineSearchMode", "same"),
                        ("ContinuousBatching", "1")]:
        assert idx.set_parameter(name, value)
    idx.build(data)
    return idx


def test_scheduler_metrics_and_quality_health_match_jax():
    """A continuous-batching search emits the scheduler metrics the
    serving layer reads, under the JAX package's names, and both
    packages publish the same index health under the same series."""
    rng = np.random.default_rng(9)
    data = np.round(rng.standard_normal((400, 8)) * 3).astype(np.float32)
    names = ("scheduler.submitted", "scheduler.segments",
             "scheduler.retired")
    out = {}
    for name, pkg, m, q in (("jax", jsp, jmetrics, jqual),
                            ("port", tsp, tmetrics, tqual)):
        kw = {} if pkg is jsp else {"device": "cpu"}
        idx = _graph_index(pkg, data, **kw)
        q.configure(sample_rate=1.0)
        idx.publish_quality_health(shard="main")
        idx.search_batch(data[:5], 3, search_mode="beam")
        snap = m.snapshot()
        out[name] = (
            {n: snap["counters"].get(n, 0) > 0 for n in names},
            sorted(k for k in snap["gauges"] if k.startswith("scheduler")),
            sorted(k for k in snap["histograms"]
                   if k.startswith("scheduler")),
            {shard: (h["samples"], h["deleted"], sorted(h))
             for shard, h in q.snapshot()["health"].items()})
        idx.close()
        q.reset()
    assert out["port"] == out["jax"]
    assert all(out["port"][0].values())
    assert "scheduler.slot_wait" in out["port"][2]
