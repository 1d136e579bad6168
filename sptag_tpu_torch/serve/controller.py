"""SLO-driven online controller — the closed loop over the observatory
(copy of ``sptag_tpu/serve/controller.py``; its knobs are the port's
``core/params.py`` live-actuation registry).

The observability stack judges (Wilson-CI recall, burn-rate SLO states,
ground-truth canary recall, timeline trends), but a serving knob is
otherwise hand-set; the only "actuation"
in the system was the static DegradeMaxCheckFloor ladder.  This module
closes the observe→decide→act loop: a rate-limited, hysteresis-guarded
state machine that rides the timeline sampler's tick (the SloEngine
pattern) and maps

    SLO engine state (ok/warn/page)  +  canary recall  +  burn trends

to live actuations of the knobs declared in the core/params
LIVE-ACTUATION REGISTRY — MaxCheck per index, the admission tier's
degraded-mode floor, the aggregator's hedge percentile.  The controller
NEVER touches a knob outside that registry (unregistered names raise,
they do not no-op) and never outside the registry's bounds.

Hard guardrails, in priority order:

1. **Canary recall floor is inviolable.**  Down-steps (which trade
   recall for latency) are vetoed while canary recall sits below the
   floor — and if recall falls below the floor while knobs are lowered,
   a rescue step back toward baseline fires immediately, bypassing the
   cooldown.  No canary data counts as "below floor" when a floor is
   declared: the controller does not guess.
2. **Every actuation is bounded and reversible.**  Values come from
   `clamp_actuation` (registry bounds ∧ the per-tier
   ControllerMaxCheckFloor), pow2 knobs stay pow2 (a non-pow2
   MaxCheck would capture fresh walk graphs mid-page), and the
   pre-actuation value is kept so one decision can undo it.
3. **Worse-after-actuation auto-reverts.**  Each down-step opens a
   revert window; if the driving objective's fast burn is MORE than
   `worse_ratio`× the pre-actuation burn when the window closes (and
   the tier is still not ok), the knob snaps back and the original
   entry's verdict flips to ``reverted``; otherwise it is ``kept``.
4. **Rate limiting + hysteresis.**  At most one actuation per
   `cooldown_ms`; recovery (stepping knobs back toward baseline) needs
   `hold_ms` of continuous ``ok`` first and restores ONE step at a
   time, LIFO — escalate fast, recover slowly, the admission-
   controller recovery discipline.

Every decision — including vetoes, rate-limit holds and at-floor holds —
lands in the ctlaudit ring (-> GET /debug/controller, flightrec
``controller_actuation`` events, ``controller.knob`` timeline series,
and the ``controller.epoch`` gauge the slow-query log stamps).

Off by default (`Controller=0`): no controller object, no tick
listener, serve bytes byte-identical — the ci_check.sh parity pass.
The controller also requires an armed SloEngine: without declared
objectives there is no judgement to act on, and the server logs a
warning and leaves the loop open.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

from sptag_tpu_torch.core import params as core_params
from sptag_tpu_torch.serve import ctlaudit, slo as slo_mod
from sptag_tpu_torch.utils import locksan, timeline

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ControllerConfig:
    """Control-loop policy; every field has a Controller* INI knob."""

    enabled: bool = False
    #: minimum interval between actuations (rate limit)
    cooldown_ms: float = 10000.0
    #: continuous-ok time required before a recovery step-up
    hold_ms: float = 30000.0
    #: how long after a down-step the worse-after-actuation check waits
    revert_window_ms: float = 15000.0
    #: inviolable canary recall floor (defaults to SloRecallFloor)
    recall_floor: float = 0.0
    #: tier-local lower bound for MaxCheck down-steps (the registry's
    #: own lo is the absolute bound; this is the deployment's)
    max_check_floor: int = 256
    #: revert when driving burn grew by this factor over the window
    worse_ratio: float = 1.25


def config_from_settings(settings) -> ControllerConfig:
    """Duck-typed over ServiceSettings and AggregatorContext (the
    admission/slo config_from_settings pattern).  The recall floor
    inherits the SLO's declared floor unless overridden."""
    floor = float(getattr(settings, "controller_recall_floor", 0.0))
    if floor <= 0.0:
        floor = float(getattr(settings, "slo_recall_floor", 0.0))
    return ControllerConfig(
        enabled=bool(getattr(settings, "controller", False)),
        cooldown_ms=float(
            getattr(settings, "controller_cooldown_ms", 10000.0))
        or 10000.0,
        hold_ms=float(getattr(settings, "controller_hold_ms", 30000.0))
        or 30000.0,
        revert_window_ms=float(
            getattr(settings, "controller_revert_window_ms", 15000.0))
        or 15000.0,
        recall_floor=floor,
        max_check_floor=int(
            getattr(settings, "controller_max_check_floor", 256)) or 256,
    )


def armed(config: ControllerConfig) -> bool:
    return bool(config.enabled)


class _Actuator:
    """One bounded, reversible knob binding: a live-actuation-registry
    spec + read/apply callables + the baseline it may never exceed and
    the floor it may never cross."""

    __slots__ = ("key", "spec", "read", "apply", "baseline", "floor")

    def __init__(self, key: str, knob: str,
                 read: Callable[[], float],
                 apply: Callable[[float], float],
                 floor: Optional[float] = None):
        self.key = key                       # audit/display name
        self.spec = core_params.actuation_spec(knob)
        self.read = read
        self.apply = apply                   # returns the applied value
        self.baseline = float(read())
        lo = self.spec.lo if floor is None else max(self.spec.lo,
                                                    float(floor))
        self.floor = min(lo, self.baseline)

    def _clamp(self, value: float) -> float:
        v = core_params.clamp_actuation(self.spec.name, value)
        return min(max(v, self.floor), self.baseline)

    def next_down(self) -> Optional[float]:
        """The next relief value below current, or None at the floor."""
        cur = float(self.read())
        nxt = cur / 2.0 if self.spec.pow2 else (
            cur - max((self.baseline - self.floor) / 4.0, 1e-9))
        nxt = self._clamp(nxt)
        return nxt if nxt < cur else None

    def next_up(self) -> Optional[float]:
        """The next step back toward baseline, or None at baseline."""
        cur = float(self.read())
        nxt = cur * 2.0 if self.spec.pow2 else (
            cur + max((self.baseline - self.floor) / 4.0, 1e-9))
        nxt = self._clamp(nxt)
        return nxt if nxt > cur else None

    def set(self, value: float) -> float:
        return float(self.apply(self._clamp(value)))


class Controller:
    """The per-tier control loop.  `evaluate(now)` rides the timeline
    tick listener in production (the SloEngine pattern) and is called
    directly with a fake clock in tests; `clock` only feeds the default
    `now`."""

    def __init__(self, config: ControllerConfig, tier: str = "server",
                 clock=time.monotonic,
                 canary_recall: Optional[Callable[[], Optional[float]]]
                 = None):
        self.config = config
        self.tier = tier
        self.clock = clock
        self._lock = locksan.make_lock("Controller._lock")
        self._slo: Optional[slo_mod.SloEngine] = None
        self._actuators: List[_Actuator] = []
        self._canary_recall = (canary_recall if canary_recall is not None
                               else self._timeline_canary_recall)
        self._last_actuation_t: Optional[float] = None
        self._calm_since: Optional[float] = None
        #: one in-flight worse-after-actuation check:
        #: {id, act, old, burn, deadline}
        self._pending: Optional[dict] = None
        #: per-rule throttle for non-moving audit entries so a veto
        #: held across many ticks lands once per cooldown, not per tick
        self._noted_t: dict = {}

    # ------------------------------------------------------------ binding

    def bind_slo(self, engine: slo_mod.SloEngine) -> None:
        self._slo = engine

    def bind_index(self, name: str, index) -> None:
        """Register the index's MaxCheck as an actuator (applied through
        `actuate_index`, i.e. the live-actuation registry)."""
        self._actuators.append(_Actuator(
            "%s.MaxCheck" % name, "MaxCheck",
            read=lambda: float(index.params.max_check),
            apply=lambda v: core_params.actuate_index(index, "MaxCheck", v),
            floor=float(self.config.max_check_floor)))

    def bind_tier_knob(self, knob: str,
                       read: Callable[[], float],
                       apply: Callable[[float], None],
                       floor: Optional[float] = None) -> None:
        """Register a tier-scoped knob (degrade floor, hedge
        percentile); bounds still come from the registry, the owner
        only provides the setter."""
        spec = core_params.actuation_spec(knob)
        if spec.scope != "tier":
            raise ValueError("knob %s is index-scoped; bind it via "
                             "bind_index" % spec.name)

        def _apply(v: float, _set=apply) -> float:
            _set(v)
            return v

        self._actuators.append(_Actuator(
            spec.name, knob, read=read, apply=_apply, floor=floor))

    # ----------------------------------------------------------- evaluate

    def _timeline_canary_recall(self) -> Optional[float]:
        return timeline.latest("canary.recall")

    def _throttle(self, rule: str, t: float) -> bool:
        """True when a non-moving decision under `rule` may be audited
        now — at most once per cooldown per rule (ring hygiene: a veto
        held for a minute must not flush the ring with 600 identical
        entries).  The ctlaudit.record call stays at the DECIDING call
        site with a literal rule name (GL609)."""
        last = self._noted_t.get(rule)
        if last is not None and (t - last) * 1000.0 < self.config.cooldown_ms:
            return False
        self._noted_t[rule] = t
        return True

    def evaluate(self, now: Optional[float] = None) -> None:
        """One decision round; safe from the sampler thread and tests."""
        t = self.clock() if now is None else float(now)
        with self._lock:
            self._evaluate_locked(t)

    def _evaluate_locked(self, t: float) -> None:
        cfg = self.config
        state, objective, burn = (self._slo.worst() if self._slo is not None
                                  else (slo_mod.OK, "", 0.0))
        recall = self._canary_recall()
        inputs = {"slo": state, "objective": objective,
                  "burn_fast": round(burn, 3),
                  "canary_recall": recall}

        # 1. resolve an open worse-after-actuation window
        if self._pending is not None and t >= self._pending["deadline"]:
            self._resolve_pending(t, state, burn, inputs)

        # 2. inviolable recall floor: rescue first, ask questions never
        if (cfg.recall_floor > 0.0 and recall is not None
                and recall < cfg.recall_floor):
            self._calm_since = None
            act = self._below_baseline()
            if act is not None:
                moved = self._apply_up(act, t)
                if moved is not None:
                    entry = ctlaudit.record(
                        "recall_rescue", tier=self.tier, knob=act.key,
                        old=moved[0], new=moved[1], outcome="restored",
                        inputs=inputs, now=t)
                    self._log_actuation("recall_rescue", act, moved,
                                        entry)
            elif state in (slo_mod.WARN, slo_mod.PAGE) \
                    and self._throttle("canary_floor_veto", t):
                # burning AND below the floor with every knob already at
                # baseline: the step-down the burn wants is vetoed, and
                # the trail must say so
                ctlaudit.record("canary_floor_veto", tier=self.tier,
                                outcome="vetoed", inputs=inputs, now=t)
            return

        if state in (slo_mod.WARN, slo_mod.PAGE):
            self._calm_since = None
            self._step_down_round(t, recall, inputs)
            return

        # 3. ok: hysteresis-guarded recovery toward baseline
        act = self._below_baseline()
        if act is None:
            self._calm_since = None
            return
        if self._calm_since is None:
            self._calm_since = t
            return
        if ((t - self._calm_since) * 1000.0 >= cfg.hold_ms
                and self._cooldown_ok(t) and self._pending is None):
            moved = self._apply_up(act, t)
            if moved is not None:
                entry = ctlaudit.record(
                    "calm_step_up", tier=self.tier, knob=act.key,
                    old=moved[0], new=moved[1], outcome="restored",
                    inputs=inputs, now=t)
                self._log_actuation("calm_step_up", act, moved, entry)
            self._calm_since = t          # a fresh hold per restore step

    # ------------------------------------------------------ decision arms

    def _cooldown_ok(self, t: float) -> bool:
        return (self._last_actuation_t is None
                or (t - self._last_actuation_t) * 1000.0
                >= self.config.cooldown_ms)

    def _below_baseline(self) -> Optional[_Actuator]:
        """Last-bound actuator still below baseline (LIFO restore)."""
        for act in reversed(self._actuators):
            if float(act.read()) < act.baseline:
                return act
        return None

    def _step_down_round(self, t: float, recall: Optional[float],
                         inputs: dict) -> None:
        cfg = self.config
        if self._pending is not None:
            return                       # one experiment at a time
        if cfg.recall_floor > 0.0 and (recall is None
                                       or recall < cfg.recall_floor):
            # no canary data counts as below-floor: don't trade away
            # recall you cannot measure
            if self._throttle("canary_floor_veto", t):
                ctlaudit.record("canary_floor_veto", tier=self.tier,
                                outcome="vetoed", inputs=inputs, now=t)
            return
        if not self._cooldown_ok(t):
            if self._throttle("rate_limit_hold", t):
                ctlaudit.record("rate_limit_hold", tier=self.tier,
                                outcome="rate_limited", inputs=inputs,
                                now=t)
            return
        for act in self._actuators:
            nxt = act.next_down()
            if nxt is None:
                continue
            old = float(act.read())
            entry = ctlaudit.record(
                "burn_step_down", tier=self.tier, knob=act.key,
                old=old, new=nxt, outcome="applied", inputs=inputs,
                now=t)
            applied = act.set(nxt)
            self._last_actuation_t = t
            self._pending = {
                "id": entry["id"], "act": act, "old": old, "burn":
                inputs["burn_fast"],
                "deadline": t + cfg.revert_window_ms / 1000.0}
            log.warning(
                "controller tier=%s rule=burn_step_down knob=%s "
                "%g -> %g (slo=%s objective=%s burn=%.2f epoch=%d)",
                self.tier, act.key, old, applied, inputs["slo"],
                inputs["objective"], inputs["burn_fast"],
                entry["epoch"])
            return
        if self._throttle("at_floor_hold", t):
            ctlaudit.record("at_floor_hold", tier=self.tier,
                            outcome="held", inputs=inputs, now=t)

    def _apply_up(self, act: _Actuator, t: float
                  ) -> "Optional[tuple[float, float]]":
        """One bounded step back toward baseline; returns (old,
        applied) or None at baseline.  The ctlaudit record stays at the
        deciding call site so the rule name is a literal there
        (GL609)."""
        nxt = act.next_up()
        if nxt is None:
            return None
        old = float(act.read())
        applied = act.set(nxt)
        self._last_actuation_t = t
        return old, applied

    def _log_actuation(self, rule: str, act: _Actuator,
                       moved: "tuple[float, float]",
                       entry: dict) -> None:
        log.warning("controller tier=%s rule=%s knob=%s %g -> %g "
                    "(epoch=%d)", self.tier, rule, act.key, moved[0],
                    moved[1], entry["epoch"])

    def _resolve_pending(self, t: float, state: str, burn: float,
                         inputs: dict) -> None:
        p, self._pending = self._pending, None
        worse = (state != slo_mod.OK
                 and burn > p["burn"] * self.config.worse_ratio)
        if not worse:
            ctlaudit.set_outcome(p["id"], "kept")
            return
        act: _Actuator = p["act"]
        cur = float(act.read())
        applied = act.set(p["old"])
        ctlaudit.set_outcome(p["id"], "reverted")
        entry = ctlaudit.record(
            "revert_on_worse", tier=self.tier, knob=act.key,
            old=cur, new=applied, outcome="applied",
            inputs=inputs, now=t)
        self._last_actuation_t = t
        log.warning("controller tier=%s rule=revert_on_worse knob=%s "
                    "back to %g (burn %.2f -> %.2f, epoch=%d)",
                    self.tier, act.key, applied, p["burn"],
                    inputs["burn_fast"], entry["epoch"])

    # ------------------------------------------------------------ surface

    @property
    def epoch(self) -> int:
        return ctlaudit.epoch()

    def snapshot(self) -> dict:
        """The /debug/controller payload."""
        cfg = self.config
        with self._lock:
            state, objective, burn = (
                self._slo.worst() if self._slo is not None
                else (slo_mod.OK, "", 0.0))
            actuators = {
                act.key: {"current": float(act.read()),
                          "baseline": act.baseline, "floor": act.floor,
                          "lo": act.spec.lo, "hi": act.spec.hi,
                          "pow2": act.spec.pow2}
                for act in self._actuators}
            return {
                "enabled": True, "tier": self.tier,
                "epoch": ctlaudit.epoch(),
                "slo": {"state": state, "objective": objective,
                        "burn_fast": round(burn, 3)},
                "canary_recall": self._canary_recall(),
                "policy": {"cooldown_ms": cfg.cooldown_ms,
                           "hold_ms": cfg.hold_ms,
                           "revert_window_ms": cfg.revert_window_ms,
                           "recall_floor": cfg.recall_floor,
                           "max_check_floor": cfg.max_check_floor,
                           "worse_ratio": cfg.worse_ratio},
                "pending_revert_check": self._pending is not None,
                "actuators": actuators,
                "audit": ctlaudit.snapshot(),
            }
