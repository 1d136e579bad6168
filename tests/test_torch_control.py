"""The serving control plane of the PyTorch port against the JAX package's:
admission control, the SLO burn-rate engine, the canary prober, the
online controller and its decision audit, plus the card-memory ledger.

The control-plane modules are host code, so the same signal and clock
sequences must give the same decisions, the same metrics text and the
same audit records in both packages: each scenario below runs once over
each package's modules and the two records are compared whole.  The
ledger holds the JAX package's component names, and its bytes equal the
JAX package's for the same index wherever both hold the same array.
"""

import gc
import time
import types

import numpy as np
import pytest
import torch

import sptag_tpu as jsp
import sptag_tpu_torch as tsp
from sptag_tpu.core import params as jparams
from sptag_tpu.serve import (admission as jadmission, canary as jcanary,
                             controller as jcontroller,
                             ctlaudit as jctlaudit, slo as jslo,
                             wire as jwire)
from sptag_tpu.serve import service as jservice
from sptag_tpu.utils import (devmem as jdevmem, flightrec as jflightrec,
                             metrics as jmetrics, timeline as jtimeline)
from sptag_tpu_torch.core import params as tparams
from sptag_tpu_torch.serve import (admission as tadmission,
                                   canary as tcanary,
                                   controller as tcontroller,
                                   ctlaudit as tctlaudit, slo as tslo,
                                   wire as twire)
from sptag_tpu_torch.serve import service as tservice
from sptag_tpu_torch.utils import (devmem as tdevmem,
                                   flightrec as tflightrec,
                                   metrics as tmetrics, qualmon as tqualmon,
                                   timeline as ttimeline, trace as ttrace)

JAX = types.SimpleNamespace(
    name="jax", pkg=jsp, kw={}, params=jparams, admission=jadmission,
    slo=jslo, controller=jcontroller, ctlaudit=jctlaudit, canary=jcanary,
    wire=jwire, service=jservice, devmem=jdevmem, flightrec=jflightrec,
    metrics=jmetrics, timeline=jtimeline)
PORT = types.SimpleNamespace(
    name="port", pkg=tsp, kw={"device": "cpu"}, params=tparams,
    admission=tadmission, slo=tslo, controller=tcontroller,
    ctlaudit=tctlaudit, canary=tcanary, wire=twire, service=tservice,
    devmem=tdevmem, flightrec=tflightrec, metrics=tmetrics,
    timeline=ttimeline)


def _reset_port():
    ttrace.reset()
    tctlaudit.reset()
    tmetrics.reset()
    tflightrec.reset()
    tdevmem.reset()
    tqualmon.reset()
    ttimeline.reset()


@pytest.fixture(autouse=True)
def _fresh_registries():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset_port()
    yield
    _reset_port()
    torch.set_num_threads(n)


def _both(scenario):
    """Run `scenario(ns)` over each package's modules, each from fresh
    registries (the JAX ones reset here too: a scenario runs twice in one
    test); the two records."""
    from sptag_tpu.utils import trace as jtrace

    out = []
    for ns in (JAX, PORT):
        for m in (ns.ctlaudit, ns.metrics, ns.flightrec, ns.timeline,
                  ns.devmem):
            m.reset()
        if ns is JAX:
            jtrace.reset()
        out.append(scenario(ns))
    return out


def _lines(text, *needles):
    return sorted(ln for ln in text.splitlines()
                  if any(n in ln for n in needles))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---- admission --------------------------------------------------------------

def _admission_ladder(ns):
    a = ns.admission
    clock = FakeClock()
    c = a.AdmissionController(a.AdmissionConfig(recover_hold_ms=1000.0),
                              clock=clock)
    seq = [c.state]
    for frac, dt in ((0.6, 0), (0.95, 0), (0.0, 0), (0.0, 0.5), (0.0, 0.6),
                     (0.0, 0.5), (0.0, 0.6), (0.6, 0), (0.6, 0.9),
                     (0.0, 0.9)):
        clock.advance(dt)
        seq.append(c.observe(queue_frac=frac))
    for kw in ({"slot_wait_p99_ms": 60.0}, {"slot_wait_p99_ms": 300.0},
               {"occupancy": 0.99}, {"mesh_shards": 4.0}):
        seq.append(c.observe(**kw))
    return {"states": seq, "snapshot": c.snapshot(),
            "metrics": _lines(ns.metrics.render_prometheus(), "admission")}


def _admission_fairness(ns):
    a = ns.admission
    clock = FakeClock()
    c = a.AdmissionController(
        a.AdmissionConfig(fair_share=0.5, fair_min_clients=2), clock=clock)
    decisions = []
    for i in range(90):
        decisions.append(c.admit("hot"))
        clock.advance(0.01)
    for i in range(10):
        decisions.append(c.admit("quiet"))
        clock.advance(0.01)
    c.observe(queue_frac=0.6)
    for i in range(20):
        decisions.append((c.admit("hot"), c.admit("quiet"),
                          c.admit("probe", canary=True)))
        clock.advance(0.01)
    c.observe(queue_frac=0.95)
    decisions.append(c.admit("quiet"))
    return {"decisions": decisions, "snapshot": c.snapshot(),
            "clients": sorted(c._clients),
            "metrics": _lines(ns.metrics.render_prometheus(), "admission")}


def _admission_from_settings(ns):
    s = ns.service.ServiceSettings(
        admission_control=True, admission_degrade_queue_frac=0.3,
        admission_shed_queue_frac=0.7, admission_fair_share=0.25,
        admission_recover_hold_ms=50.0, degrade_max_check_floor=1024)
    cfg = ns.admission.config_from_settings(s)
    c = ns.admission.AdmissionController(
        cfg, signals=lambda: {"queue_frac": 0.5}, clock=FakeClock())
    return {"config": repr(cfg), "admit": c.admit("x"),
            "state": c.state, "snapshot": c.snapshot()}


@pytest.mark.parametrize("scenario", [_admission_ladder, _admission_fairness,
                                      _admission_from_settings],
                         ids=["ladder", "fairness", "settings"])
def test_admission_decisions_equal_jax(scenario):
    jax_rec, port_rec = _both(scenario)
    assert port_rec == jax_rec
    if scenario is _admission_ladder:
        assert port_rec["states"][:3] == ["normal", "degrade", "shed"]
    if scenario is _admission_fairness:
        assert "probe" not in port_rec["clients"]


def _slow_spell(ns, tier):
    """A tier with admission whose p99 signal saw a slow spell past the
    shed threshold: the admit decisions over the next 30 s, in which no
    request is admitted (so none records a latency), then after fast
    traffic."""
    from sptag_tpu.serve import aggregator as jagg, server as jserver
    from sptag_tpu_torch.serve import aggregator as tagg, server as tserver

    srv_mod, agg_mod = ((jserver, jagg) if ns is JAX else (tserver, tagg))
    clock = FakeClock()
    ctl = ns.admission.AdmissionController(
        ns.admission.AdmissionConfig(recover_hold_ms=1000.0), clock=clock)
    if tier == "server":
        srv_mod.SearchServer(ns.service.ServiceContext(
            ns.service.ServiceSettings(), **ns.kw), admission=ctl)
        name = "scheduler.slot_wait"
    else:
        agg_mod.AggregatorService(agg_mod.AggregatorContext(),
                                  admission=ctl)
        name = "aggregator.request"
    for _ in range(50):
        ns.metrics.observe(name, 0.5)      # 500 ms: past the 250 ms shed
    decisions = [ctl.admit("client")]
    for _ in range(30):
        clock.advance(1.0)
        decisions.append(ctl.admit("client"))
    for _ in range(50):
        ns.metrics.observe(name, 0.001)
    clock.advance(1.0)
    decisions.append(ctl.admit("client"))
    return decisions


@pytest.mark.parametrize("tier", ["server", "aggregator"])
def test_admission_recovers_after_a_slow_spell_where_jax_latches(tier):
    """The port's tiers read their p99 over admission.SIGNAL_WINDOW_S: after
    a slow spell they admit again once it has left the window (one state a
    recovery hold), and fast traffic keeps them admitting.  The JAX
    package's tiers read lifetime p99s and, since a shed request records
    no latency, shed every request from the spell on (its public API
    only; no JAX file changes)."""
    jax_dec, port_dec = _both(lambda ns: _slow_spell(ns, tier))
    window = int(tadmission.SIGNAL_WINDOW_S)
    assert jax_dec == ["shed"] * len(jax_dec)
    assert port_dec[0] == "shed"
    # the spell leaves the window, then two recovery holds of 1 s
    assert "admit" in port_dec[:window + 6]
    first = port_dec.index("admit")
    assert set(port_dec[first:]) == {"admit"}
    assert "degrade" in port_dec[:first]


# ---- the SLO engine -----------------------------------------------------------

def _flight(ns, kind):
    return [(e["tier"], e["kind"], e.get("payload"))
            for e in ns.flightrec.collect() if e["kind"] == kind]


def _slo_availability(ns):
    ns.timeline.configure(enabled=True, capacity=256)
    ns.flightrec.configure(enabled=True)
    cfg = ns.slo.SloConfig(availability_target=0.95, fast_window_s=10.0,
                           slow_window_s=30.0, warn_burn=1.0, page_burn=4.0)
    eng = ns.slo.SloEngine(cfg, tier="server", clock=lambda: 0.0)
    states = []
    for lo, hi, ok, now in ((0, 30, 1.0, 29.0), (30, 34, 0.0, 33.0),
                            (34, 46, 0.0, 45.0), (46, 90, 1.0, 89.0)):
        for t in range(lo, hi):
            ns.timeline.record("canary.ok", ok, now=float(t))
        eng.evaluate(now=now)
        states.append(eng.worst())
    return {"states": states, "snapshot": eng.snapshot(),
            "flight": _flight(ns, "slo_transition"),
            "families": _lines(ns.metrics.render_provider_families(),
                               "slo_"),
            "metrics": _lines(ns.metrics.render_prometheus(), "slo")}


def _slo_latency_and_recall(ns):
    ns.timeline.configure(enabled=True, capacity=512)
    cfg = ns.slo.SloConfig(p99_ms=50.0, recall_floor=0.9, qps_floor=0.0,
                           fast_window_s=5.0, slow_window_s=20.0,
                           budget=0.1)
    eng = ns.slo.SloEngine(cfg, tier="aggregator", clock=lambda: 0.0)
    states = []
    for t in range(40):
        lat = 20.0 if t < 20 else 90.0
        rec = 1.0 if t < 30 else 0.5
        ns.timeline.record("canary.latency_ms", lat, now=float(t))
        ns.timeline.record("canary.recall", rec, now=float(t))
        eng.evaluate(now=float(t))
        states.append(eng.worst())
    return {"states": states, "snapshot": eng.snapshot(),
            "families": _lines(ns.metrics.render_provider_families(),
                               "slo_")}


def _slo_from_settings(ns):
    s = ns.service.ServiceSettings(slo_p99_ms=125.0, slo_fast_window_s=5.0,
                                   slo_recall_floor=0.8)
    cfg = ns.slo.config_from_settings(s)
    return {"config": repr(cfg), "armed": ns.slo.armed(cfg),
            "off": ns.slo.armed(ns.slo.config_from_settings(
                ns.service.ServiceSettings()))}


@pytest.mark.parametrize("scenario", [_slo_availability,
                                      _slo_latency_and_recall,
                                      _slo_from_settings],
                         ids=["availability", "latency_recall", "settings"])
def test_slo_engine_equals_jax(scenario):
    jax_rec, port_rec = _both(scenario)
    assert port_rec == jax_rec
    if scenario is _slo_availability:
        assert [s[0] for s in port_rec["states"]] == [
            "ok", "warn", "page", "ok"]


# ---- the controller and its audit ---------------------------------------------

class _StubSlo:
    def __init__(self, ns):
        self.state, self.objective, self.burn = ns.slo.OK, "latency_p99", 0.0

    def worst(self):
        return self.state, self.objective, self.burn


class _StubIndex:
    def __init__(self, ns, max_check=8192):
        self.params = ns.params.FlatParams()
        assert self.params.set_param("MaxCheck", str(max_check))

    def set_parameter(self, name, value):
        return self.params.set_param(name, value)


def _mk_controller(ns, recall=None, **overrides):
    cfg = ns.controller.ControllerConfig(
        enabled=True, cooldown_ms=1000.0, hold_ms=2000.0,
        revert_window_ms=500.0, recall_floor=0.0, max_check_floor=256)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    eng = _StubSlo(ns)
    idx = _StubIndex(ns)
    ctl = ns.controller.Controller(cfg, tier="server",
                                   canary_recall=(recall or (lambda: None)))
    ctl.bind_slo(eng)
    ctl.bind_index("main", idx)
    return ctl, eng, idx


def _controller_record(ns, ctl, steps):
    return {"steps": steps, "epoch": ctl.epoch, "snapshot": ctl.snapshot(),
            "audit": ns.ctlaudit.snapshot(),
            "counters": ns.ctlaudit.counters(),
            "flight": _flight(ns, "controller_actuation"),
            "metrics": _lines(ns.metrics.render_prometheus(), "controller")}


def _ctl_cycle(ns):
    """warn -> step down -> kept -> hold -> restore."""
    ns.flightrec.configure(enabled=True)
    ns.timeline.configure(enabled=True)
    ctl, eng, idx = _mk_controller(ns)
    steps = []
    for state, burn, now in (("warn", 2.0, 0.0), ("warn", 2.0, 0.6),
                             ("warn", 2.0, 1.2), ("ok", 0.0, 2.0),
                             ("ok", 0.0, 3.0), ("ok", 0.0, 4.1),
                             ("ok", 0.0, 6.2), ("ok", 0.0, 8.3)):
        eng.state, eng.burn = state, burn
        ctl.evaluate(now=now)
        steps.append(idx.params.max_check)
    return _controller_record(ns, ctl, steps)


def _ctl_revert(ns):
    ctl, eng, idx = _mk_controller(ns)
    steps = []
    for state, burn, now in (("warn", 2.0, 0.0), ("warn", 5.0, 1.0),
                             ("page", 9.0, 2.5), ("page", 9.0, 3.6)):
        eng.state, eng.burn = state, burn
        ctl.evaluate(now=now)
        steps.append(idx.params.max_check)
    return _controller_record(ns, ctl, steps)


def _ctl_recall_floor(ns):
    reading = {"v": 0.5}
    ctl, eng, idx = _mk_controller(ns, recall=lambda: reading["v"],
                                   recall_floor=0.9)
    steps = []
    for state, burn, v, now in (("page", 9.0, 0.5, 0.0),
                                ("page", 9.0, 0.5, 0.1),
                                ("page", 9.0, None, 2.0),
                                ("page", 9.0, 0.95, 4.0),
                                ("ok", 0.0, 0.5, 4.1)):
        eng.state, eng.burn = state, burn
        reading["v"] = v
        ctl.evaluate(now=now)
        steps.append(idx.params.max_check)
    return _controller_record(ns, ctl, steps)


def _ctl_tier_knob(ns):
    box = {"v": 95.0}
    ctl, eng, idx = _mk_controller(ns, max_check_floor=4096,
                                   cooldown_ms=100.0,
                                   revert_window_ms=50.0)
    errors = []
    try:
        ctl.bind_tier_knob("MaxCheck", read=lambda: box["v"],
                           apply=lambda v: box.update(v=v))
    except ValueError as e:
        errors.append(str(e))
    ctl.bind_tier_knob("HedgePercentile", read=lambda: box["v"],
                       apply=lambda v: box.update(v=v))
    steps = []
    eng.state, eng.burn = "warn", 2.0
    for now in (0.0, 1.2, 2.4, 3.6, 4.8, 6.0, 7.2):
        ctl.evaluate(now=now)
        steps.append((idx.params.max_check, box["v"]))
    rec = _controller_record(ns, ctl, steps)
    rec["errors"] = errors
    return rec


def _ctl_registry(ns):
    p = ns.params
    out = {name: repr(spec) for name, spec in p.LIVE_ACTUATIONS.items()}
    out["clamps"] = [p.clamp_actuation(k, v) for k, v in (
        ("MaxCheck", 3000), ("MaxCheck", 1), ("MaxCheck", 1 << 30),
        ("HedgePercentile", 120.0), ("ApproxRecallTarget", 0.93),
        ("TierBudgetSketch", 0), ("DegradeMaxCheckFloor", 700))]
    errors = []
    for call in (lambda: p.actuation_spec("BKTKmeansK"),
                 lambda: p.clamp_actuation("NumberOfThreads", 4)):
        try:
            call()
        except p.UnknownActuationError as e:
            errors.append(repr(e))
    idx = ns.pkg.create_instance("FLAT", "Float", **ns.kw)
    out["applied"] = p.actuate_index(idx, "MaxCheck", 3000)
    out["max_check"] = idx.params.max_check
    try:
        p.actuate_index(idx, "DegradeMaxCheckFloor", 512)
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    return out


def _ctlaudit_ring(ns):
    a = ns.ctlaudit
    a.configure(capacity=4)
    for i in range(10):
        a.record("at_floor_hold", outcome="held", now=float(i))
    e = a.record("burn_step_down", knob="main.MaxCheck", old=8192,
                 new=4096, outcome="applied", now=11.0)
    a.set_outcome(e, "reverted")
    out = {"snapshot": a.snapshot(), "counters": a.counters(),
           "metrics": _lines(ns.metrics.render_prometheus(), "controller")}
    a.configure()
    return out


def _ctl_settings(ns):
    s = ns.service.ServiceSettings(controller=True, slo_recall_floor=0.7,
                                   controller_cooldown_ms=123.0,
                                   controller_max_check_floor=512)
    cfg = ns.controller.config_from_settings(s)
    return {"config": repr(cfg), "armed": ns.controller.armed(cfg)}


@pytest.mark.parametrize("scenario", [
    _ctl_cycle, _ctl_revert, _ctl_recall_floor, _ctl_tier_knob,
    _ctl_registry, _ctlaudit_ring, _ctl_settings],
    ids=["cycle", "revert", "recall_floor", "tier_knob", "registry",
         "ctlaudit_ring", "settings"])
def test_controller_decisions_and_audit_equal_jax(scenario):
    jax_rec, port_rec = _both(scenario)
    assert port_rec == jax_rec
    if scenario is _ctl_cycle:
        assert port_rec["steps"][0] == 4096 and port_rec["epoch"] >= 2
    if scenario is _ctl_recall_floor:
        assert port_rec["steps"][:3] == [8192, 8192, 8192]


# ---- the canary ------------------------------------------------------------

def _canary_rows():
    rng = np.random.default_rng(4)
    return np.round(rng.standard_normal((50, 8)) * 3).astype(np.float32)


class _ScriptedClient:
    """A loopback client that answers each probe from a script."""

    def __init__(self, replies):
        self.replies = list(replies)
        self.seen = []

    def search(self, text, request_id="", timeout_s=None):
        self.seen.append((text, request_id))
        return self.replies.pop(0)

    def close(self):
        pass


def _canary_scenario(ns):
    idx = ns.pkg.create_instance("FLAT", "Float", **ns.kw)
    idx.set_parameter("DistCalcMethod", "L2")
    idx.build(_canary_rows())
    ctx = ns.service.ServiceContext(ns.service.ServiceSettings(), **ns.kw)
    ctx.add_index("main", idx)
    probes = ns.canary.probes_from_context(ctx, count=4, k=5)
    w = ns.wire
    good = [w.RemoteSearchResult(w.ResultStatus.Success, [
        w.IndexSearchResult("main", p.truth_ids, p.truth_dists, None)])
        for p in probes]
    half = w.RemoteSearchResult(w.ResultStatus.Success, [
        w.IndexSearchResult("main", probes[1].truth_ids[:2] + [-1, -1, -1],
                            probes[1].truth_dists[:2] + [3.4e38] * 3,
                            None)])
    fail = w.RemoteSearchResult(w.ResultStatus.Timeout, [])
    prober = ns.canary.CanaryProber("127.0.0.1", 1, probes,
                                    interval_ms=50.0, tier="server")
    client = _ScriptedClient([good[0], half, fail])
    prober._client = client
    outs = []
    for probe in probes[:3]:
        o = prober.probe_once(probe)
        o.pop("latency_ms")
        outs.append(o)
    snap = prober.snapshot()
    for st in snap["indexes"].values():
        st.pop("latency_ms_last")
    return {"probes": [(p.text, p.index_name, p.k, p.truth_ids,
                        p.truth_dists) for p in probes],
            "outs": outs, "seen": client.seen, "snapshot": snap,
            "families": _lines(ns.metrics.render_provider_families(),
                               "canary_recall", "canary_failures"),
            "counters": _lines(ns.metrics.render_prometheus(),
                               "canary_probes", "canary_failures"),
            "canary_rid": [ns.canary.is_canary_rid(r) for _, r in
                           client.seen]}


def test_canary_probes_and_scores_equal_jax():
    jax_rec, port_rec = _both(_canary_scenario)
    assert port_rec == jax_rec
    assert [o["recall"] for o in port_rec["outs"]] == [1.0, 0.4, None]
    assert all(port_rec["canary_rid"])


# ---- the card-memory ledger -----------------------------------------------

class _Owner:
    pass


@pytest.mark.parametrize("case", ["totals", "retrack", "owner_death",
                                  "disabled", "disable_drops", "rendering"])
def test_ledger_unit_semantics_equal_jax(case):
    """tests/test_memledger.py's unit cases, run over both ledgers."""
    def scenario(ns):
        d = ns.devmem
        a, b = _Owner(), _Owner()
        out = []
        if case == "totals":
            d.track("corpus", a, 1000)
            d.track("graph", a, 50)
            d.track("corpus", b, 200)
            out.append((d.component_bytes(), d.total_bytes()))
            d.untrack(a, "graph")
            out.append(d.component_bytes())
            d.untrack(a)
            out.append(d.component_bytes())
        elif case == "retrack":
            d.track("slot_pool", a, 100)
            d.track("slot_pool", a, 700)
            out.append(d.component_bytes())
        elif case == "owner_death":
            d.track("corpus", a, 4096)
            out.append(d.total_bytes())
            del a
            gc.collect()
            out.append(d.total_bytes())
        elif case == "disabled":
            d.configure(enabled=False)
            try:
                d.track("corpus", _Owner(), 123)
                out.append(d.component_bytes())
            finally:
                d.configure(enabled=True)
        elif case == "disable_drops":
            d.track("corpus", a, 4096)
            d.configure(enabled=False)
            try:
                out.append(d.snapshot(with_live_arrays=False))
            finally:
                d.configure(enabled=True)
        else:
            d.track("dense_blocks", a, 12345)
            d.track("slot_pool", b, 5000, host=True)
            out.append(d.render_prometheus())
            out.append(d.snapshot(with_live_arrays=False))
        return out

    jax_rec, port_rec = _both(scenario)
    assert port_rec == jax_rec


def test_ledger_without_a_card_reports_no_cross_check():
    """On the CPU the allocator cross-check is absent (no initialized
    CUDA device): the payload keeps the JAX package's ledger keys."""
    tdevmem.track("corpus", _Owner(), 10)
    snap = tdevmem.snapshot()
    assert set(snap) == {"enabled", "components", "ledger_total_bytes",
                         "ledger_device_bytes"}
    with pytest.raises(RuntimeError):
        tdevmem.live_arrays_bytes()


def _rows(n, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((n, d)) * 3).astype(np.float32)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """FLAT, BKT and KDT folders built by the JAX package."""
    out = {}
    data = _rows(300)
    for algo in ("FLAT", "BKT", "KDT"):
        idx = jsp.create_instance(algo, "Float")
        for p, v in (("DistCalcMethod", "L2"), ("TPTNumber", "2"),
                     ("TPTLeafSize", "32"), ("NeighborhoodSize", "8"),
                     ("CEF", "32"), ("RefineIterations", "1"),
                     ("MaxCheck", "64"), ("BKTKmeansK", "4"),
                     ("DenseClusterSize", "32")):
            idx.set_parameter(p, v)
        idx.build(data)
        path = str(tmp_path_factory.mktemp("ledger") / algo)
        idx.save_index(path)
        out[algo] = path
    return out, data


@pytest.mark.parametrize("algo", ["FLAT", "BKT", "KDT"])
def test_ledger_components_equal_jax_on_one_folder(folders, algo):
    """The same folder, loaded and searched (beam and dense) in both
    packages, registers the same components with the same bytes; only
    `tree` differs, because the port keeps other pivot arrays (int64 ids
    and a norm per pivot where the JAX package keeps a visited mask)."""
    paths, data = folders

    def scenario(ns):
        idx = ns.pkg.load_index(paths[algo], **ns.kw)
        for mode in ((None,) if algo == "FLAT" else ("beam", "dense")):
            idx.search_batch(data[:4], 3, search_mode=mode)
        comp = ns.devmem.component_bytes()
        eng = getattr(idx, "_engine", None)
        return comp, eng

    (jcomp, _), (tcomp, teng) = _both(scenario)
    assert set(tcomp) == set(jcomp)
    for name in jcomp:
        if name != "tree":
            assert tcomp[name] == jcomp[name], name
    if algo != "FLAT":
        assert tcomp["tree"] == (teng.pivot_ids.nbytes
                                 + teng.pivot_vecs.nbytes
                                 + teng.pivot_sqnorm.nbytes)
        assert tcomp["graph"] == teng.graph.nbytes


def _flat_corpus_bytes(idx):
    data_d, sqnorm_d, invalid_d = idx._snapshot()
    return data_d.nbytes + sqnorm_d.nbytes + invalid_d.nbytes


def test_flat_lifecycle_ledger_equals_jax(tmp_path):
    """The corpus component follows the live snapshot through build ->
    add -> delete -> save -> load -> DeviceBytesLedger off/on, in both
    packages alike."""
    def scenario(ns):
        rng = np.random.default_rng(1)
        data = np.round(rng.standard_normal((100, 16)) * 3).astype(
            np.float32)
        idx = ns.pkg.create_instance("FLAT", "Float", **ns.kw)
        idx.set_parameter("DistCalcMethod", "L2")
        idx.build(data)
        seen = []

        def look():
            idx.search_batch(data[:2], 3)
            gc.collect()
            seen.append((ns.devmem.component_bytes().get("corpus"),
                         _flat_corpus_bytes(idx)))

        look()
        idx.add(np.round(rng.standard_normal((40, 16)) * 3).astype(
            np.float32))
        look()
        idx.delete(data[3:4])
        look()
        folder = str(tmp_path / ns.name)
        idx.save_index(folder)
        del idx
        gc.collect()
        seen.append(ns.devmem.component_bytes().get("corpus"))
        idx = ns.pkg.load_index(folder, **ns.kw)
        look()
        idx.set_parameter("DeviceBytesLedger", "0")
        seen.append(ns.devmem.component_bytes())
        idx.set_parameter("DeviceBytesLedger", "1")
        seen.append(ns.devmem.component_bytes().get("corpus"))
        return seen

    jax_rec, port_rec = _both(scenario)
    assert port_rec == jax_rec
    assert all(a == b for a, b in port_rec[:3])
    assert port_rec[3] is None and port_rec[5] == {}


def test_slot_pool_bytes_retire_with_the_scheduler():
    """Scheduler slot pools appear in the ledger while resident and leave
    it when a retired scheduler drains; the port keeps them on the device,
    so they count in the device total."""
    data = _rows(120)
    idx = tsp.create_instance("BKT", "Float", device="cpu")
    for p, v in [("DistCalcMethod", "L2"), ("BKTKmeansK", "4"),
                 ("TPTNumber", "2"), ("TPTLeafSize", "16"),
                 ("NeighborhoodSize", "8"), ("CEF", "32"),
                 ("RefineIterations", "0"), ("SearchMode", "beam"),
                 ("MaxCheck", "64"), ("BeamSegmentIters", "2"),
                 ("ContinuousBatching", "1")]:
        assert idx.set_parameter(p, v), p
    idx.build(data)
    try:
        for f in idx.submit_batch(data[:4], 3):
            f.result()
        pool = tdevmem.component_bytes().get("slot_pool", 0)
        assert pool > 0
        assert tdevmem.device_bytes() >= pool
        idx._scheduler.retire()
        deadline = time.time() + 10
        while time.time() < deadline and \
                tdevmem.component_bytes().get("slot_pool", 0):
            time.sleep(0.05)
        assert tdevmem.component_bytes().get("slot_pool", 0) == 0
    finally:
        idx.close()


def test_delta_shard_and_int8_blocks_components():
    """The delta shard registers under `delta_shard` until it is folded
    in; int8 dense blocks register under `int8_blocks`, never
    `dense_blocks`."""
    rng = np.random.default_rng(2)
    data = rng.integers(-40, 40, (96, 16)).astype(np.int8)
    idx = tsp.create_instance("BKT", "Int8", device="cpu")
    for p, v in [("DistCalcMethod", "Cosine"), ("BKTKmeansK", "4"),
                 ("BuildGraph", "0"), ("BKTLeafSize", "16"),
                 ("DenseClusterSize", "32"), ("SearchMode", "dense")]:
        assert idx.set_parameter(p, v), p
    idx.build(data)
    idx.search_batch(data[:2], 3)
    comp = tdevmem.component_bytes()
    assert comp.get("int8_blocks", 0) > 0 and "dense_blocks" not in comp

    flat = tsp.create_instance("BKT", "Float", device="cpu")
    for p, v in [("DistCalcMethod", "L2"), ("BKTKmeansK", "4"),
                 ("TPTNumber", "2"), ("TPTLeafSize", "16"),
                 ("NeighborhoodSize", "8"), ("CEF", "32"),
                 ("RefineIterations", "0"), ("DeltaShardCapacity", "64"),
                 ("MaxCheck", "64")]:
        assert flat.set_parameter(p, v), p
    rows = _rows(100)
    flat.build(rows)
    flat.add(_rows(5, seed=9))
    flat.search_batch(rows[:2], 3)
    assert tdevmem.component_bytes().get("delta_shard", 0) > 0
    with flat._lock:
        flat._absorb_delta_locked()
    assert "delta_shard" not in tdevmem.component_bytes()
