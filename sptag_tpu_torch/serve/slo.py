"""SLO burn-rate engine — declared objectives judged over the timeline
(copy of ``sptag_tpu/serve/slo.py`` over the port's utils).

The observability stack measures everything
but JUDGES nothing — no component knows what the p99 is supposed to be,
so nothing can say "this deployment is burning its error budget" until
a human looks.  This module holds the declared objectives

* **availability** (`SloAvailabilityTarget`, e.g. ``0.99``) — fraction
  of canary probes answering Success (the ``canary.ok`` series; the
  canary exists precisely so availability is measured at zero live
  traffic);
* **p99 latency** (`SloP99Ms`) — canary end-to-end latency first (each
  probe is an instantaneous full-path sample, so the windows react
  promptly), falling back to the tier's own request p99
  (``server.request.p99_ms`` / ``aggregator.request.p99_ms``) when no
  canary runs — that histogram is process-lifetime cumulative, so its
  p99 lags fresh degradations and lingers after recovery;
* **recall floor** (`SloRecallFloor`) — canary exact recall (ground
  truth pinned at index load) and, when the quality monitor runs, the
  live window's Wilson LOWER bound (``quality.recall_at_k_lo`` — the
  CI floor, not the point estimate, so a thin window can't fake
  health);
* **QPS floor** (`SloQpsFloor`) — the tier's answered-responses rate.

and evaluates each with the MULTI-WINDOW BURN RATE rule (the SRE-book
construction): over a FAST window (`SloFastWindowS`) and a SLOW window
(`SloSlowWindowS`), compute the fraction of timeline samples violating
the objective, divide by the error budget (1 − target for
availability; `SloBudget` for threshold objectives) — that quotient is
the burn rate: 1.0 = exactly exhausting the budget over the window.
State is ``page`` when BOTH windows burn at ≥ `SloPageBurn`, ``warn``
when both ≥ `SloWarnBurn`, else ``ok`` — the fast window makes pages
prompt, the slow window keeps a single bad sample from flapping the
state.  Objectives with too few samples in the fast window stay in
their current state (no data is not good news, but it is not a page).

Every transition emits (a) a flight-recorder event (kind
``slo_transition``) so the page moment lands on the same timeline as
the queries that caused it, (b) a WARNING on the request-id-stamped log
stream, and (c) a point on the ``slo.state`` timeline series.  Current
state/burn per objective is published as labeled families
(``slo_state{objective=,tier=}`` etc.) on /metrics, and
``GET /debug/slo`` serves the full picture.

Off by default: no objective declared → no engine, no listener, serve
bytes byte-identical (the ci_check.sh standalone parity pass).
"""

from __future__ import annotations

import dataclasses
import logging
import time
import weakref
from typing import List, Optional

from sptag_tpu_torch.utils import flightrec, locksan, metrics, timeline

log = logging.getLogger(__name__)

OK = "ok"
WARN = "warn"
PAGE = "page"

_STATE_CODE = {OK: 0, WARN: 1, PAGE: 2}


@dataclasses.dataclass
class SloConfig:
    """Declared objectives + burn-rate policy (0 = objective off)."""

    availability_target: float = 0.0     # e.g. 0.99
    p99_ms: float = 0.0                  # latency ceiling per sample
    recall_floor: float = 0.0            # recall-CI floor
    qps_floor: float = 0.0               # answered-rate floor
    #: error budget for the threshold objectives (latency/recall/qps):
    #: the tolerated fraction of violating samples at burn rate 1.0
    budget: float = 0.05
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    warn_burn: float = 1.0
    page_burn: float = 4.0
    #: minimum fast-window samples before a verdict may change
    min_samples: int = 3


def config_from_settings(settings) -> SloConfig:
    """Duck-typed over ServiceSettings and AggregatorContext (the
    admission config_from_settings pattern)."""
    return SloConfig(
        availability_target=float(
            getattr(settings, "slo_availability_target", 0.0)),
        p99_ms=float(getattr(settings, "slo_p99_ms", 0.0)),
        recall_floor=float(getattr(settings, "slo_recall_floor", 0.0)),
        qps_floor=float(getattr(settings, "slo_qps_floor", 0.0)),
        budget=float(getattr(settings, "slo_budget", 0.05)) or 0.05,
        fast_window_s=float(
            getattr(settings, "slo_fast_window_s", 60.0)) or 60.0,
        slow_window_s=float(
            getattr(settings, "slo_slow_window_s", 300.0)) or 300.0,
        warn_burn=float(getattr(settings, "slo_warn_burn", 1.0)) or 1.0,
        page_burn=float(getattr(settings, "slo_page_burn", 4.0)) or 4.0,
    )


def armed(config: SloConfig) -> bool:
    return (config.availability_target > 0.0 or config.p99_ms > 0.0
            or config.recall_floor > 0.0 or config.qps_floor > 0.0)


class _Objective:
    """One declared objective: which series it reads, what a violating
    sample is, and its error budget."""

    __slots__ = ("name", "series", "bad", "budget", "target", "state",
                 "burn_fast", "burn_slow", "transitions", "last_detail")

    def __init__(self, name: str, series: List[str], bad, budget: float,
                 target: float):
        self.name = name
        self.series = series            # first series with data wins
        self.bad = bad                  # value -> violating?
        self.budget = max(budget, 1e-6)
        self.target = target
        self.state = OK
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.transitions = 0
        self.last_detail = ""


class SloEngine:
    """Burn-rate evaluator for one serving tier.  `evaluate(now)` is
    driven by the timeline sampler's tick listener in production and
    called directly with a fake clock in tests; `clock` only feeds the
    default `now`."""

    def __init__(self, config: SloConfig, tier: str = "server",
                 clock=time.monotonic):
        self.config = config
        self.tier = tier
        self.clock = clock
        self._lock = locksan.make_lock("SloEngine._lock")
        self._objectives: List[_Objective] = []
        c = config
        # registry series are named for the MODULE ("server.request"),
        # not the flight tier ("server_a" in multi-tier tests) — map
        # the tier onto its histogram/counter family
        base = "aggregator" if tier.startswith("aggregator") else "server"
        if c.availability_target > 0.0:
            self._objectives.append(_Objective(
                "availability", ["canary.ok"],
                lambda v: v < 1.0,
                1.0 - min(c.availability_target, 1.0 - 1e-6),
                c.availability_target))
        if c.p99_ms > 0.0:
            # canary latency FIRST: each probe is an instantaneous
            # full-path measurement, so the burn windows see real
            # change promptly.  The tier's request histogram is the
            # fallback — it is process-LIFETIME cumulative (the
            # registry never resets), so its p99 both lags a fresh
            # degradation and stays elevated after recovery; it only
            # carries the objective when no canary runs.
            self._objectives.append(_Objective(
                "latency_p99",
                ["canary.latency_ms", base + ".request.p99_ms"],
                lambda v: v > c.p99_ms, c.budget, c.p99_ms))
        if c.recall_floor > 0.0:
            self._objectives.append(_Objective(
                "recall", ["canary.recall", "quality.recall_at_k_lo"],
                lambda v: v < c.recall_floor, c.budget, c.recall_floor))
        if c.qps_floor > 0.0:
            # ANSWERED work, not arrivals: server.responses counts at
            # response send; the aggregator has no responses counter,
            # but its request HISTOGRAM observes exactly once per
            # completed request — its timeline count-rate is the
            # answered rate (aggregator.requests by contrast counts at
            # packet receipt, BEFORE the shed path, and would read
            # healthy while the tier sheds everything)
            self._objectives.append(_Objective(
                "qps", [base + ".responses.rate" if base == "server"
                        else "aggregator.request.rate"],
                lambda v: v < c.qps_floor, c.budget, c.qps_floor))
        _engines.add(self)

    # ------------------------------------------------------------ evaluate

    def _burn(self, obj: _Objective, window_s: float, now: float
              ) -> "tuple[float, int, str]":
        for name in obj.series:
            vals = timeline.window_values(name, window_s, now=now)
            if vals:
                bad = sum(1 for v in vals if obj.bad(v))
                return (bad / len(vals)) / obj.budget, len(vals), name
        return 0.0, 0, ""

    def evaluate(self, now: Optional[float] = None) -> None:
        """One evaluation round over every declared objective; safe to
        call from the sampler thread and from tests concurrently."""
        t = self.clock() if now is None else float(now)
        c = self.config
        with self._lock:
            for obj in self._objectives:
                fast, n_fast, src = self._burn(obj, c.fast_window_s, t)
                slow, n_slow, _ = self._burn(obj, c.slow_window_s, t)
                obj.burn_fast, obj.burn_slow = fast, slow
                if n_fast < c.min_samples:
                    continue            # not enough data to change state
                burn = min(fast, slow)
                new = (PAGE if burn >= c.page_burn
                       else WARN if burn >= c.warn_burn else OK)
                if new != obj.state:
                    self._transition(obj, new, src, t)
                self._publish(obj, t)

    def _transition(self, obj: _Objective, new: str, src: str,
                    t: float) -> None:
        old, obj.state = obj.state, new
        obj.transitions += 1
        obj.last_detail = (
            "series=%s burn_fast=%.2f burn_slow=%.2f target=%g"
            % (src or "-", obj.burn_fast, obj.burn_slow, obj.target))
        metrics.inc("slo.transitions")
        if flightrec.enabled():
            flightrec.record(self.tier, "slo_transition", payload={
                "objective": obj.name, "from": old, "to": new,
                "burn_fast": round(obj.burn_fast, 3),
                "burn_slow": round(obj.burn_slow, 3)})
        # the rid-stamped stream (the log-record factory stamps every
        # record): a page and the slow queries that caused it land in
        # one grep
        log.warning("SLO transition tier=%s objective=%s %s -> %s (%s)",
                    self.tier, obj.name, old, new, obj.last_detail)

    def _publish(self, obj: _Objective, t: float) -> None:
        timeline.record("slo.state", _STATE_CODE[obj.state],
                        label="objective=%s" % obj.name, now=t)
        # one registry gauge for the worst objective (quick /metrics
        # read + admission-style consumers); the per-objective picture
        # rides the labeled families below
        worst = max((_STATE_CODE[o.state] for o in self._objectives),
                    default=0)
        metrics.set_gauge("slo.worst_state", worst)

    # ------------------------------------------------------------- surface

    def worst(self) -> "tuple[str, str, float]":
        """(state, objective_name, burn_fast) of the worst objective —
        the online controller's primary input.  Worst = highest state
        code, burn_fast breaking ties, so the controller always reacts
        to the objective that is actually paging."""
        with self._lock:
            if not self._objectives:
                return OK, "", 0.0
            o = max(self._objectives,
                    key=lambda o: (_STATE_CODE[o.state], o.burn_fast))
            return o.state, o.name, o.burn_fast

    def snapshot(self) -> dict:
        """The /debug/slo payload."""
        c = self.config
        with self._lock:
            objectives = {
                o.name: {"state": o.state, "target": o.target,
                         "budget": o.budget,
                         "burn_fast": round(o.burn_fast, 3),
                         "burn_slow": round(o.burn_slow, 3),
                         "transitions": o.transitions,
                         "series": o.series, "detail": o.last_detail}
                for o in self._objectives}
        return {"enabled": True, "tier": self.tier,
                "policy": {"fast_window_s": c.fast_window_s,
                           "slow_window_s": c.slow_window_s,
                           "warn_burn": c.warn_burn,
                           "page_burn": c.page_burn,
                           "min_samples": c.min_samples},
                "objectives": objectives}

    def families(self) -> List[metrics.Family]:
        """``slo_state`` / ``slo_burn_fast`` / ``slo_burn_slow``
        labeled by (objective, tier) — the /metrics surface."""
        state = metrics.Family(
            "slo.state", help="0 ok / 1 warn / 2 page per objective")
        fast = metrics.Family("slo.burn_fast")
        slow = metrics.Family("slo.burn_slow")
        with self._lock:
            for o in self._objectives:
                labels = {"objective": o.name, "tier": self.tier}
                state.add(_STATE_CODE[o.state], labels)
                fast.add(round(o.burn_fast, 4), labels)
                slow.add(round(o.burn_slow, 4), labels)
        return [state, fast, slow]


#: live engines (weak — a stopped server's engine must not pin or keep
#: publishing); the module-level provider aggregates every tier in the
#: process, mirroring how qualmon merges shard windows
_engines: "weakref.WeakSet[SloEngine]" = weakref.WeakSet()


def _slo_families() -> List[metrics.Family]:
    out: List[metrics.Family] = []
    for eng in list(_engines):
        out.extend(eng.families())
    return out


metrics.register_family_provider("slo", _slo_families)
