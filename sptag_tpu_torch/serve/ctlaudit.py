"""Bounded decision-audit ring for the serving control plane (copy of
``sptag_tpu/serve/ctlaudit.py`` over the port's utils).

The online controller (serve/controller.py) is only trustworthy if every
decision it takes — including the ones it declined to take — can be
reconstructed after the fact.  This module is the single sink for those
decisions: a bounded ring of audit entries (inputs snapshot, rule fired,
old -> new value, outcome verdict) served at ``GET /debug/controller``,
plus the cross-correlation surfaces that let a dashboard line a knob
change up against the p99/recall history it reacted to:

* a flight-recorder event (kind ``controller_actuation``) for every
  decision that actually moved a knob, so the actuation lands on the
  same rid-ordered timeline as the slow queries around it;
* ``controller.knob`` timeline points labeled by knob name (knob names
  come from the core/params live-actuation registry, so the label set
  is bounded by deployment — the flightrec tier-argument rationale);
* a monotonically increasing ``controller.epoch`` — bumped once per
  applied/reverted/restored actuation — exported as a registry gauge
  and stamped onto slow-query log lines so "which controller state was
  this query served under" is a grep.

Rule names are the GL609 lint surface: each ``record`` call site names
the decision rule with a string literal (obsnames.py pattern — the ring
is keyed and counted by rule, and a dynamic rule name would make the
audit trail unsearchable).  Outcome verdicts are a closed set:
``applied`` / ``restored`` (knob moved — down-step / back-toward-
baseline step), ``vetoed`` / ``rate_limited`` / ``held`` (knob
deliberately not moved), and the post-hoc verdicts ``kept`` /
``reverted`` that `set_outcome` stamps onto an ``applied`` entry once
the worse-after-actuation window has judged it.
"""

from __future__ import annotations

import collections
import itertools
from typing import Deque, Dict, Optional

from sptag_tpu_torch.utils import flightrec, locksan, metrics, timeline

#: outcomes that represent an actual knob movement (they bump the epoch
#: and emit flightrec/timeline points); everything else is a decision
#: that deliberately left the knob alone
ACTUATION_OUTCOMES = ("applied", "restored")

_DEFAULT_CAPACITY = 256

_lock = locksan.make_lock("ctlaudit._lock")
_ring: Deque[dict] = collections.deque(maxlen=_DEFAULT_CAPACITY)
_counters: Dict[str, int] = collections.Counter()
_epoch = 0
_ids = itertools.count(1)


def configure(capacity: int = _DEFAULT_CAPACITY) -> None:
    """Resize the ring (drops existing entries)."""
    global _ring
    with _lock:
        _ring = collections.deque(maxlen=max(int(capacity), 1))


def reset() -> None:
    """Drop all entries, counters and the epoch (tests)."""
    global _ring, _counters, _epoch, _ids
    with _lock:
        _ring = collections.deque(maxlen=_DEFAULT_CAPACITY)
        _counters = collections.Counter()
        _epoch = 0
        _ids = itertools.count(1)


def epoch() -> int:
    with _lock:
        return _epoch


def record(rule: str, *, tier: str = "server", knob: str = "",
           old=None, new=None, outcome: str = "applied",
           inputs: Optional[dict] = None, now: float = 0.0) -> dict:
    """Land one controller decision in the ring (and, for outcomes that
    moved a knob, on flightrec + the timeline + the epoch gauge).
    `rule` must be a string literal at the call site (GL609).  Returns
    the entry so the caller can later amend its verdict via
    `set_outcome` (e.g. "applied" -> "reverted" after the
    worse-after-actuation check)."""
    global _epoch
    with _lock:
        actuated = outcome in ACTUATION_OUTCOMES
        if actuated:
            _epoch += 1
        entry = {
            "id": next(_ids),
            "t": round(float(now), 3),
            "tier": tier,
            "rule": rule,
            "knob": knob,
            "old": old,
            "new": new,
            "outcome": outcome,
            "inputs": dict(inputs or {}),
            "epoch": _epoch,
        }
        _ring.append(entry)
        _counters[outcome] += 1
        ep = _epoch
    metrics.inc("controller.decisions")
    if actuated:
        metrics.set_gauge("controller.epoch", ep)
        timeline.record("controller.knob", float(new),
                        label="knob=%s" % (knob or "-"))
        timeline.record("controller.epoch", float(ep))
        if flightrec.enabled():
            flightrec.record(tier, "controller_actuation", payload={
                "rule": rule, "knob": knob, "old": old, "new": new,
                "outcome": outcome, "epoch": ep})
    return entry


def set_outcome(entry_id: int, outcome: str) -> None:
    """Amend a prior entry's verdict in place (the ring keeps the
    original rule/values; only the outcome string changes).  Used by
    the worse-after-actuation check: the revert itself is a fresh
    `record`, but the original actuation's verdict flips from
    "applied" to the final judgement."""
    with _lock:
        for entry in reversed(_ring):
            if entry["id"] == entry_id:
                _counters[entry["outcome"]] -= 1
                entry["outcome"] = outcome
                _counters[outcome] += 1
                return


def counters() -> Dict[str, int]:
    with _lock:
        return {k: v for k, v in _counters.items() if v}


def snapshot(limit: int = 64) -> dict:
    """The ring's contribution to the /debug/controller payload."""
    with _lock:
        entries = list(_ring)[-max(int(limit), 1):]
        return {"epoch": _epoch, "capacity": _ring.maxlen,
                "decisions": sum(_counters.values()),
                "counters": {k: v for k, v in _counters.items() if v},
                "entries": entries}
