"""Runtime lock sanitizer — the dynamic complement of graftlint's GL7xx.

The static lock-order analysis (tools/graftlint/lockgraph.py) proves
properties about lock ACQUISITION SITES; this module checks the orders a
live process actually exercises.  Both build the same artifact — a lock
ORDER GRAPH with an edge A→B whenever lock B is acquired while A is held
— and tests/test_locksan.py cross-checks one against the other: a runtime
edge that the static graph can reach in reverse is a deadlock the lint
missed (or a baseline entry that lied).

Opt-in and zero-cost when off: `make_lock(name)` / `make_rlock(name)`
return plain `threading.Lock()` / `RLock()` unless the sanitizer is
enabled (env ``SPTAG_LOCKSAN=1`` — ``strict`` to make inversions raise —
or ini ``[Service] LockSanitizer``; see serve/service.py).  When enabled
they return `SanLock` / `SanRLock`, which

* record a per-thread stack of held lock names;
* on each nested acquisition, add the edge to the process-wide order
  graph; if the REVERSE order was ever observed (a path new→…→held
  already exists), that is a lock-order inversion: both stacks — the
  first witness of the established order and the acquisition at hand —
  are logged, the ``locksan.inversions`` counter bumps, and in strict
  mode the acquisition is refused with `LockOrderError` (the lock is NOT
  left held);
* optionally run a WATCHDOG: when a blocking acquire waits longer than
  the threshold (``SPTAG_LOCKSAN_WATCHDOG_MS`` / ini
  ``LockSanWatchdogMs``), every thread's held locks and current stack are
  dumped to the log (the same request-id-stamped stream the slow-query
  log uses) and ``locksan.watchdog_stalls`` bumps — the post-mortem for a
  stall that static analysis could not see coming.

Adopted by serve/client.py, core/index.py (and through it algo/bkt.py),
and utils/threadpool.py; tests/conftest.py enables the sanitizer for the
whole tier-1 suite, so every serve/index test doubles as an inversion
probe.

Contention ledger: a second opt-in — env
``SPTAG_LOCKSAN_CONTENTION=1`` or ini ``[Service] LockContentionLedger``
— makes every SanLock account per-lock wait and hold times (acquires,
contended count, total/max wait ms, total/max hold ms).  Counters are
instance-local and updated only while the lock is held, so the lock
itself serializes them; the exposition aggregates by lock NAME and
self-renders as ``lock_wait_ms{name=}`` / ``lock_hold_ms{name=}`` /
``lock_acquires{name=}`` / ``lock_contended{name=}`` gauges on /metrics
(serve/metrics_http.py), the per-lock complement to the host profiler's
stack samples (utils/hostprof.py): hostprof shows WHICH waits dominate,
the ledger shows WHOSE lock they are.

Race sanitizer: the Eraser-style lockset algorithm, the
runtime complement of graftlint's GL80x guarded-by inference.  Opt-in —
env ``SPTAG_RACESAN=1`` (``strict`` to raise), ini ``[Service]
RaceSanitizer``, sampled via ``RaceSanSampleRate``.  Hot classes carry
the ``@locksan.race_track`` decorator; ARMING installs a ``__setattr__``
shim on them (off = class completely untouched, zero overhead).  Every
sampled attribute write records (attr, writing thread, the held-lockset
from SanLock's per-thread stacks) per INSTANCE.  The first writer owns
the attribute exclusively (the init/publish handoff never fires — the
static side polices that as GL805); when a SECOND thread writes, the
candidate lockset starts at that write's held set and every later write
intersects into it.  An attribute whose intersection is empty while
writes from DIFFERENT threads interleave is a data race:
``racesan.races`` bumps, BOTH stacks (the previous write's and this
one's) are logged, and in strict mode `DataRaceError` is raised.  (The
interleaving requirement is the classic Eraser ownership-transfer
refinement: built on one thread then mutated by exactly one other
forever after is synchronized by the spawn edge, which no lockset can
see — the transition write and same-thread runs stay quiet.)
``observed_locksets()`` aggregates the
surviving per-(class, attr) intersections so tests/test_racesan.py can
cross-check them against the statically inferred guards.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional, Set

from sptag_tpu_torch.utils import metrics

log = logging.getLogger(__name__)


class LockOrderError(RuntimeError):
    """Raised (strict mode only) when an acquisition inverts the observed
    lock order.  The offending lock is released before raising."""


class DataRaceError(RuntimeError):
    """Raised (racesan strict mode only) when a tracked attribute's
    lockset intersection across writing threads goes empty.  The write
    itself has already landed — the raise is the bug report, not a
    rollback."""


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

_cfg_lock = threading.Lock()
_enabled_override: Optional[bool] = None
_strict_override: Optional[bool] = None
_watchdog_ms_override: Optional[float] = None
_contention_override: Optional[bool] = None
_racesan_override: Optional[bool] = None
_racesan_strict_override: Optional[bool] = None
_racesan_rate_override: Optional[float] = None


def _env_mode() -> str:
    return os.environ.get("SPTAG_LOCKSAN", "").strip().lower()


def _san_enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return _env_mode() in ("1", "true", "on", "log", "strict", "raise")


def contention_enabled() -> bool:
    """The opt-in lock-contention ledger: per-lock wait/hold
    accounting published as ``lock_wait_ms{name=}`` gauges on /metrics.
    Env ``SPTAG_LOCKSAN_CONTENTION=1`` or ini ``[Service]
    LockContentionLedger``."""
    if _contention_override is not None:
        return _contention_override
    return os.environ.get("SPTAG_LOCKSAN_CONTENTION", "").strip().lower() \
        in ("1", "true", "on", "yes")


def _racesan_env() -> str:
    return os.environ.get("SPTAG_RACESAN", "").strip().lower()


def racesan_enabled() -> bool:
    """The opt-in Eraser-style race sanitizer.  Env
    ``SPTAG_RACESAN=1`` (``strict``/``raise`` to make races raise) or
    ini ``[Service] RaceSanitizer``."""
    if _racesan_override is not None:
        return _racesan_override
    return _racesan_env() in ("1", "true", "on", "log", "strict", "raise")


def racesan_strict() -> bool:
    if _racesan_strict_override is not None:
        return _racesan_strict_override
    return _racesan_env() in ("strict", "raise")


def racesan_sample_rate() -> float:
    """Fraction of tracked attribute writes the sanitizer records
    (deterministic per-thread 1-in-round(1/rate) gate, the qualmon
    pattern).  1.0 records everything; 0 records nothing."""
    if _racesan_rate_override is not None:
        return _racesan_rate_override
    try:
        return float(os.environ.get("SPTAG_RACESAN_SAMPLE", "1"))
    except ValueError:
        return 1.0


def enabled() -> bool:
    """Wrap locks at creation?  True when ANY locksan feature wants
    them — the contention ledger rides the same SanLock wrappers, and
    the race sanitizer reads the per-thread held-stacks only SanLocks
    maintain (racesan over plain locks would see every lockset empty)."""
    return _san_enabled() or contention_enabled() or racesan_enabled()


def strict() -> bool:
    if _strict_override is not None:
        return _strict_override
    return _env_mode() in ("strict", "raise")


def watchdog_ms() -> float:
    if _watchdog_ms_override is not None:
        return _watchdog_ms_override
    try:
        return float(os.environ.get("SPTAG_LOCKSAN_WATCHDOG_MS", "0"))
    except ValueError:
        return 0.0


def enable(strict: Optional[bool] = None,
           watchdog_ms: Optional[float] = None) -> None:
    """Turn the sanitizer on for locks created FROM NOW ON (make_lock
    decides at creation time).  `strict`/`watchdog_ms` override the env;
    None keeps the env-derived value."""
    global _enabled_override, _strict_override, _watchdog_ms_override
    with _cfg_lock:
        _enabled_override = True
        if strict is not None:
            _strict_override = strict
        if watchdog_ms is not None:
            _watchdog_ms_override = watchdog_ms


def enable_contention() -> None:
    """Turn the contention ledger on for locks acquired from now on
    (pre-existing SanLocks join the ledger at their next acquire; plain
    locks created while every locksan feature was off stay unwrapped —
    like `enable()`, arm BEFORE building the structures to cover)."""
    global _contention_override
    with _cfg_lock:
        _contention_override = True


def disable_contention() -> None:
    global _contention_override
    with _cfg_lock:
        _contention_override = False


def disable() -> None:
    global _enabled_override, _strict_override, _watchdog_ms_override
    with _cfg_lock:
        _enabled_override = False
        _strict_override = None
        _watchdog_ms_override = None


def reset_config() -> None:
    """Drop every enable()/disable() override — the environment decides
    again (test hygiene)."""
    global _enabled_override, _strict_override, _watchdog_ms_override
    global _contention_override
    with _cfg_lock:
        _enabled_override = None
        _strict_override = None
        _watchdog_ms_override = None
        _contention_override = None


# --------------------------------------------------------------------------
# held-lock bookkeeping + order graph
# --------------------------------------------------------------------------

_tls = threading.local()

_graph_lock = threading.Lock()
#: observed canonical order: name -> set of names acquired while it was held
_order: Dict[str, Set[str]] = {}
#: (held, acquired) -> formatted stack of the FIRST observation of the edge
_edge_witness: Dict[tuple, str] = {}
_inversions: List[dict] = []
_seen_inversions: Set[tuple] = set()
#: thread id -> that thread's live held-stack (same list object as its TLS)
_thread_stacks: Dict[int, List[str]] = {}


def _stack() -> List[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
        with _graph_lock:
            _thread_stacks[threading.get_ident()] = s
    return s


def _has_path(src: str, dst: str) -> bool:
    """DFS over `_order` (caller holds `_graph_lock`)."""
    seen: Set[str] = set()
    todo = [src]
    while todo:
        n = todo.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        todo.extend(_order.get(n, ()))
    return False


#: hard cap on retained inversion records — detection (metric, strict
#: raise) is NEVER deduplicated, but a pathological retry loop must not
#: grow the record list without bound
_MAX_INVERSION_RECORDS = 1000


def _record_edges(held: List[str], name: str) -> Optional[dict]:
    """Record held→name edges; returns the first inversion found (if
    any).  EVERY occurrence of an inversion is detected, counted and
    recorded (strict mode must refuse repeats too, and the per-test
    probe must see an inversion no matter which test provoked the pair
    first) — only the stack-dump LOG is deduplicated per pair to avoid
    spam.  Stack formatting happens OUTSIDE `_graph_lock` so first-time
    edge bookkeeping does not convoy unrelated acquisitions."""
    new_edges: List[tuple] = []
    found: List[tuple] = []           # (held_lock, first_time, witness)
    with _graph_lock:
        for h in held:
            if h == name:
                continue
            edges = _order.setdefault(h, set())
            if name in edges:
                continue
            if _has_path(name, h):
                key = (name, h)
                first = key not in _seen_inversions
                _seen_inversions.add(key)
                found.append((h, first,
                              _edge_witness.get((name, h), "")))
            else:
                edges.add(name)
                new_edges.append((h, name))
    if not new_edges and not found:
        return None
    here = "".join(traceback.format_stack()[:-3])
    inversion: Optional[dict] = None
    with _graph_lock:
        for e in new_edges:
            _edge_witness.setdefault(e, here)
        for h, first, established in found:
            rec = {
                "held": h,
                "acquiring": name,
                "established_order": f"{name} -> {h}",
                "established_at": established,
                "stack": here,
                "first": first,
            }
            if len(_inversions) < _MAX_INVERSION_RECORDS:
                _inversions.append(rec)
            if inversion is None:
                inversion = rec
    for h, first, established in found:
        metrics.inc("locksan.inversions")
        if first:
            log.error(
                "lock-order inversion: acquiring %r while holding %r, "
                "but the order %s -> %s was already observed.\n"
                "--- established at ---\n%s--- inverted here ---\n%s",
                name, h, name, h,
                established or "(witness stack unavailable)\n", here)
    return inversion


def _watchdog_dump(name: str, waited_s: float) -> None:
    metrics.inc("locksan.watchdog_stalls")
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    with _graph_lock:
        stacks = {tid: list(s) for tid, s in _thread_stacks.items() if s}
    lines = [f"locksan watchdog: waited {waited_s * 1000.0:.0f} ms for "
             f"{name!r}; held locks by thread:"]
    for tid, held in stacks.items():
        lines.append(f"  thread {names.get(tid, '?')} ({tid}) holds {held}")
        frame = frames.get(tid)
        if frame is not None:
            lines.append("".join(traceback.format_stack(frame)))
    if not stacks:
        lines.append("  (no sanitized locks held — the owner is a plain "
                     "lock or another process)")
    log.warning("%s", "\n".join(lines))


# --------------------------------------------------------------------------
# contention ledger
# --------------------------------------------------------------------------

#: SanLock instances that recorded at least one acquire while the ledger
#: was on.  Weak so a retired scheduler's pool locks don't pin memory;
#: several instances may share a NAME (one VectorIndex._lock per index)
#: and the exposition aggregates by name.
_ledger_locks: "weakref.WeakSet[SanLock]" = weakref.WeakSet()


def _ledger_register(lock: "SanLock") -> None:
    with _cfg_lock:
        _ledger_locks.add(lock)


def contention_snapshot() -> Dict[str, Dict[str, float]]:
    """Per-lock-NAME wait/hold aggregate: acquires, contended count,
    total/max wait ms, total/max hold ms.  Instance counters are
    serialized by the lock they describe (updated while it is held), so
    this racy read is at worst one acquisition stale."""
    out: Dict[str, Dict[str, float]] = {}
    locks = list(_ledger_locks)
    for lk in locks:
        agg = out.setdefault(lk.name, {
            "acquires": 0, "contended": 0,
            "wait_ms": 0.0, "wait_ms_max": 0.0,
            "hold_ms": 0.0, "hold_ms_max": 0.0})
        agg["acquires"] += lk._c_acquires
        agg["contended"] += lk._c_contended
        agg["wait_ms"] += lk._c_wait_ms
        agg["wait_ms_max"] = max(agg["wait_ms_max"], lk._c_wait_max)
        agg["hold_ms"] += lk._c_hold_ms
        agg["hold_ms_max"] = max(agg["hold_ms_max"], lk._c_hold_max)
    for agg in out.values():
        for k in ("wait_ms", "wait_ms_max", "hold_ms", "hold_ms_max"):
            agg[k] = round(agg[k], 3)
    return out


def contention_families() -> List[metrics.Family]:
    """The contention ledger as labeled metric families (utils/
    metrics.py Family): ``lock_wait_ms{name=}`` /
    ``lock_wait_ms_max`` / ``lock_hold_ms`` / ``lock_hold_ms_max`` /
    ``lock_acquires`` / ``lock_contended``.  Bare names
    (``prefix=""``) — the ledger's historical exposition shape.  Empty
    when the ledger is off or has seen nothing, so the default
    exposition is unchanged."""
    snap = contention_snapshot()
    if not snap:
        return []
    series = (("lock_wait_ms", "wait_ms",
               "total milliseconds threads waited to acquire the lock"),
              ("lock_wait_ms_max", "wait_ms_max",
               "longest single wait in milliseconds"),
              ("lock_hold_ms", "hold_ms",
               "total milliseconds the lock was held"),
              ("lock_hold_ms_max", "hold_ms_max",
               "longest single hold in milliseconds"),
              ("lock_acquires", "acquires", "total acquisitions"),
              ("lock_contended", "contended",
               "acquisitions that found the lock already held"))
    fams: List[metrics.Family] = []
    for metric, key, help_text in series:
        fam = metrics.Family(metric, help=help_text, prefix="")
        for name in sorted(snap):
            fam.add(snap[name][key], {"name": name})
        fams.append(fam)
    return fams


def render_prometheus() -> str:
    """Self-rendered labeled series for the /metrics exposition — the
    families above through the shared formatter."""
    return metrics.render_families(contention_families())


metrics.register_family_provider("locksan", contention_families)


def reset_contention() -> None:
    """Zero the ledger and drop the enable_contention() override — the
    environment decides again (test isolation; wired into conftest's
    autouse telemetry reset).  Live locks keep recording if the env
    keeps the ledger on."""
    global _contention_override
    with _cfg_lock:
        _contention_override = None
    locks = list(_ledger_locks)
    for lk in locks:
        lk._c_acquires = 0
        lk._c_contended = 0
        lk._c_wait_ms = 0.0
        lk._c_wait_max = 0.0
        lk._c_hold_ms = 0.0
        lk._c_hold_max = 0.0
        # let the survivor RE-register at its next ledger'd acquire —
        # without this a long-lived lock (module fixture, process
        # singleton) would vanish from the exposition forever
        lk._c_registered = False
    with _cfg_lock:
        _ledger_locks.clear()


# --------------------------------------------------------------------------
# race sanitizer — Eraser-style lockset intersection
# --------------------------------------------------------------------------

#: classes that opted in via @race_track (strong refs: these are
#: long-lived type objects, a handful of them)
_race_classes: List[type] = []
#: class -> original __setattr__ from its OWN __dict__ (None = inherited)
_race_installed: Dict[type, Optional[object]] = {}
#: serializes per-instance record updates + the aggregates below
_race_lock = threading.Lock()
#: (class name, attr) -> {"threads": set, "lockset": set|None} — folded
#: from instance records once they turn multi-writer; the cross-check
#: surface for tests/test_racesan.py
_race_observed: Dict[tuple, dict] = {}
_race_records: List[dict] = []
_race_seen: Set[tuple] = set()            # (class, attr) log dedup
_race_writes_recorded = 0
#: per-write sampling stride, derived from racesan_sample_rate() at
#: arm time (0 = record nothing)
_race_every = 1

_MAX_RACE_RECORDS = 200


def _race_stride() -> int:
    rate = racesan_sample_rate()
    if rate <= 0.0:
        return 0
    if rate >= 1.0:
        return 1
    return max(1, round(1.0 / rate))


def _racesan_setattr(self, name, value):      # installed on tracked classes
    orig = None
    for k in type(self).__mro__:
        if k in _race_installed:
            orig = _race_installed[k]         # the class's own, pre-shim
            break
    if orig is not None:
        orig(self, name, value)
    else:
        object.__setattr__(self, name, value)
    if name.startswith("_racesan"):
        return
    _note_attr_write(self, name)


def _note_attr_write(obj, name: str) -> None:
    every = _race_every
    if every <= 0:
        return
    tick = getattr(_tls, "race_tick", 0) + 1
    _tls.race_tick = tick
    if tick % every:
        return
    held = frozenset(getattr(_tls, "stack", ()) or ())
    tid = threading.get_ident()
    tname = threading.current_thread().name
    # stack formatting OUTSIDE _race_lock (the _record_edges discipline);
    # trim only the shim frames (_racesan_setattr + this function) so
    # the writing statement itself stays on the record
    here = "".join(traceback.format_stack()[:-2])
    race: Optional[dict] = None
    cls_name = type(obj).__name__
    with _race_lock:
        global _race_writes_recorded
        _race_writes_recorded += 1
        state = obj.__dict__.get("_racesan_state")
        if state is None:
            state = {}
            object.__setattr__(obj, "_racesan_state", state)
        rec = state.get(name)
        if rec is None:
            # virgin -> exclusive: first writer owns the attribute; the
            # lockset is NOT refined until a second thread appears, so
            # the construct-then-publish handoff cannot false-positive
            # (escape DURING __init__ is the static side's GL805)
            state[name] = {"writers": {tid}, "lockset": set(held),
                           "last": (tid, tname, here), "raced": False}
            return
        shared_before = len(rec["writers"]) >= 2
        transition = False
        if tid not in rec["writers"]:
            rec["writers"].add(tid)
            if not shared_before:
                # exclusive -> shared-modified: candidate set restarts
                # at THIS write's held locks, then only intersects.
                # The transition itself is NOT checked — a one-way
                # ownership handoff (build on main, mutate on the loop/
                # worker thread forever after) is synchronized by the
                # spawn edge, which no lockset can see.
                rec["lockset"] = set(held)
                transition = True
            else:
                rec["lockset"] &= held
        elif shared_before:
            rec["lockset"] &= held
        else:
            rec["lockset"] = set(held)        # still exclusive: track
        prev = rec["last"]
        rec["last"] = (tid, tname, here)
        if len(rec["writers"]) >= 2:
            key = (cls_name, name)
            agg = _race_observed.setdefault(
                key, {"threads": set(), "lockset": None})
            agg["threads"] |= rec["writers"]
            agg["lockset"] = (set(rec["lockset"])
                              if agg["lockset"] is None
                              else agg["lockset"] & rec["lockset"])
            # a race needs INTERLEAVING: this write and the previous one
            # from different threads with an empty candidate set.  Same-
            # thread runs keep quiet, so post-handoff single-writer
            # phases never fire.
            if not rec["lockset"] and not rec["raced"] and \
                    not transition and prev[0] != tid:
                rec["raced"] = True
                race = {
                    "class": cls_name,
                    "attr": name,
                    "threads": sorted(rec["writers"]),
                    "prev_thread": prev[1],
                    "prev_stack": prev[2],
                    "thread": tname,
                    "stack": here,
                }
                if len(_race_records) < _MAX_RACE_RECORDS:
                    _race_records.append(race)
    if race is not None:
        metrics.inc("racesan.races")
        key = (race["class"], race["attr"])
        if key not in _race_seen:
            _race_seen.add(key)
            log.error(
                "data race: `%s.%s` written by thread %r and thread %r "
                "with an EMPTY lockset intersection — no lock protects "
                "it.\n--- previous write (thread %s) ---\n%s"
                "--- this write (thread %s) ---\n%s",
                race["class"], race["attr"], race["prev_thread"],
                race["thread"], race["prev_thread"], race["prev_stack"],
                race["thread"], race["stack"])
        if racesan_strict():
            raise DataRaceError(
                f"unguarded write to `{race['class']}.{race['attr']}`: "
                f"thread {race['thread']!r} and thread "
                f"{race['prev_thread']!r} share no lock")


def _install_racesan(cls: type) -> None:
    if cls in _race_installed:
        return
    _race_installed[cls] = cls.__dict__.get("__setattr__")
    cls.__setattr__ = _racesan_setattr


def _uninstall_racesan(cls: type) -> None:
    orig = _race_installed.pop(cls, None)
    if orig is not None:
        cls.__setattr__ = orig
    elif "__setattr__" in cls.__dict__:
        del cls.__setattr__


def race_track(cls: type) -> type:
    """Class decorator registering `cls` with the race sanitizer.  When
    the sanitizer is OFF (the default) the class is returned completely
    untouched — zero overhead, byte-identical behavior.  Arming (env /
    ini / enable_racesan) installs the ``__setattr__`` shim on every
    registered class; disarming removes it."""
    _race_classes.append(cls)
    if racesan_enabled():
        _install_racesan(cls)
    return cls


def enable_racesan(strict: Optional[bool] = None,
                   sample_rate: Optional[float] = None) -> None:
    """Arm the race sanitizer on every @race_track class (and those
    registered from now on).  Like enable(): arm BEFORE building the
    structures to cover — and note the lockset feed is SanLock's
    per-thread stacks, so locks created while EVERY locksan feature was
    off stay invisible."""
    global _racesan_override, _racesan_strict_override
    global _racesan_rate_override, _race_every
    with _cfg_lock:
        _racesan_override = True
        if strict is not None:
            _racesan_strict_override = strict
        if sample_rate is not None:
            _racesan_rate_override = float(sample_rate)
        _race_every = _race_stride()
    for cls in list(_race_classes):
        _install_racesan(cls)


def disable_racesan() -> None:
    global _racesan_override, _racesan_strict_override
    global _racesan_rate_override
    with _cfg_lock:
        _racesan_override = False
        _racesan_strict_override = None
        _racesan_rate_override = None
    for cls in list(_race_classes):
        _uninstall_racesan(cls)


def reset_racesan() -> None:
    """Observations dropped, overrides dropped — the environment decides
    again, and the shim install state is re-synced to it (test
    isolation; wired into conftest's autouse telemetry reset)."""
    global _racesan_override, _racesan_strict_override
    global _racesan_rate_override, _race_writes_recorded, _race_every
    with _cfg_lock:
        _racesan_override = None
        _racesan_strict_override = None
        _racesan_rate_override = None
    with _race_lock:
        _race_observed.clear()
        _race_records.clear()
        _race_seen.clear()
        _race_writes_recorded = 0
    on = racesan_enabled()
    with _cfg_lock:
        _race_every = _race_stride() if on else 1
    for cls in list(_race_classes):
        if on:
            _install_racesan(cls)
        else:
            _uninstall_racesan(cls)


def races() -> List[dict]:
    with _race_lock:
        return list(_race_records)


def race_count() -> int:
    with _race_lock:
        return len(_race_records)


def racesan_counters() -> Dict[str, int]:
    with _race_lock:
        return {
            "enabled": int(racesan_enabled()),
            "writes_recorded": _race_writes_recorded,
            "races": len(_race_records),
            "tracked_classes": len(_race_classes),
        }


def observed_locksets() -> Dict[tuple, dict]:
    """{(class name, attr): {"threads": set, "lockset": set}} for every
    tracked attribute that turned MULTI-WRITER — the lockset is the
    intersection the Eraser pass maintained, i.e. the locks every
    post-exclusive write held.  tests/test_racesan.py cross-checks these
    against guardedby.infer_guards()."""
    with _race_lock:
        return {k: {"threads": set(v["threads"]),
                    "lockset": set(v["lockset"] or ())}
                for k, v in _race_observed.items()}


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

class SanLock:
    """`threading.Lock` wrapper feeding the order graph + watchdog."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()
        # contention-ledger counters: instance-local, updated
        # only while THIS lock is held, so the lock itself serializes
        # them — no extra synchronization on the acquire path
        self._c_acquires = 0
        self._c_contended = 0
        self._c_wait_ms = 0.0
        self._c_wait_max = 0.0
        self._c_hold_ms = 0.0
        self._c_hold_max = 0.0
        self._c_registered = False

    @staticmethod
    def _make_inner():
        return threading.Lock()

    # ---- protocol ----------------------------------------------------

    def _acquire_inner(self, blocking: bool, timeout: float) -> bool:
        if not blocking:
            return self._inner.acquire(False)
        if timeout is not None and timeout >= 0:
            return self._inner.acquire(True, timeout)
        wd = watchdog_ms() / 1000.0
        if wd > 0:
            ok = self._inner.acquire(True, wd)
            if not ok:
                t0 = time.monotonic()
                _watchdog_dump(self.name, wd)
                self._inner.acquire()
                metrics.observe("locksan.stall_wait",
                                wd + time.monotonic() - t0)
            return True
        self._inner.acquire()
        return True

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        led = contention_enabled()
        if not led:
            ok = self._acquire_inner(blocking, timeout)
        else:
            # ledger path: a failed non-blocking probe marks the acquire
            # CONTENDED; the wait is whatever the real acquisition then
            # costs.  An uncontended acquire records ~µs of wait — the
            # probe itself — which keeps totals honest without a branch
            # in the common case.
            t0 = time.perf_counter()
            contended = False
            if blocking and self._inner.acquire(False):
                ok = True
            elif blocking:
                contended = True
                ok = self._acquire_inner(True, timeout)
            else:
                ok = self._inner.acquire(False)
                contended = not ok
            if ok:
                wait_ms = (time.perf_counter() - t0) * 1000.0
                self._c_acquires += 1
                if contended:
                    self._c_contended += 1
                self._c_wait_ms += wait_ms
                if wait_ms > self._c_wait_max:
                    self._c_wait_max = wait_ms
                if not self._c_registered:
                    self._c_registered = True
                    _ledger_register(self)
                # outermost hold starts now (reentrant re-acquires keep
                # the original timestamp)
                holds = getattr(_tls, "holds", None)
                if holds is None:
                    holds = _tls.holds = {}
                holds.setdefault(self.name, time.perf_counter())
        if ok:
            self._note_acquired()
        return ok

    def release(self) -> None:
        stack = getattr(_tls, "stack", None)
        still_held = False
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.name:
                    del stack[i]
                    break
            still_held = self.name in stack
        if not still_held:
            # outermost release: account the hold BEFORE dropping the
            # lock — the counters are serialized by holding it
            holds = getattr(_tls, "holds", None)
            t0 = holds.pop(self.name, None) if holds else None
            if t0 is not None and contention_enabled():
                hold_ms = (time.perf_counter() - t0) * 1000.0
                self._c_hold_ms += hold_ms
                if hold_ms > self._c_hold_max:
                    self._c_hold_max = hold_ms
        self._inner.release()

    def locked(self) -> bool:
        # RLock grew .locked() only in 3.12; fall back to _is_owned-style
        # probing for older interpreters
        probe = getattr(self._inner, "locked", None)
        if probe is not None:
            return probe()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"

    # ---- bookkeeping -------------------------------------------------

    def _note_acquired(self) -> None:
        stack = _stack()
        if self.name in stack:
            # reentrant re-acquisition (SanRLock): already ordered
            stack.append(self.name)
            return
        inversion = None
        if stack:
            held = list(dict.fromkeys(stack))
            inversion = _record_edges(held, self.name)
        stack.append(self.name)
        if inversion is not None and strict():
            stack.pop()
            self._inner.release()
            raise LockOrderError(
                f"acquiring {inversion['acquiring']!r} while holding "
                f"{inversion['held']!r} inverts the established order "
                f"{inversion['established_order']}")


class SanRLock(SanLock):
    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()


def make_lock(name: str):
    """A mutex named `name`: `SanLock` when the sanitizer is enabled,
    plain `threading.Lock` (zero overhead) otherwise."""
    return SanLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    return SanRLock(name) if enabled() else threading.RLock()


# --------------------------------------------------------------------------
# introspection (tests, cross-check against the static graph)
# --------------------------------------------------------------------------

def order_graph() -> Dict[str, Set[str]]:
    with _graph_lock:
        return {k: set(v) for k, v in _order.items()}


def inversions() -> List[dict]:
    with _graph_lock:
        return list(_inversions)


def inversion_count() -> int:
    with _graph_lock:
        return len(_inversions)


def held_locks() -> Dict[int, List[str]]:
    with _graph_lock:
        return {tid: list(s) for tid, s in _thread_stacks.items() if s}


def reset_observations() -> None:
    """Clear the order graph + inversion records (test isolation).  Live
    held-stacks are left alone — locks currently held stay accounted."""
    with _graph_lock:
        _order.clear()
        _edge_witness.clear()
        _inversions.clear()
        _seen_inversions.clear()
