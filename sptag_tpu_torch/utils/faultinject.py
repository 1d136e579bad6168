"""Deterministic wire-layer fault injection (opt-in, seedable).

The overload-defense subsystem (serve/admission.py, the aggregator's
hedging and deadline machinery) exists to survive slow, dead and hostile
shards — behaviors that are impossible to exercise in tier-1 without a
way to CREATE those shards on demand.  This module is that way: a tiny
rule engine that the serve tier consults at its wire send sites and that
answers "inject a fault here" according to an operator- or test-supplied
spec.

Faults (the matrix every resilience test drives):

* ``delay`` — sleep ``ms`` before the bytes go out (a slow shard; with
  ``ms`` past the aggregator's SearchTimeout, a timed-out shard);
* ``drop`` — swallow the response entirely (the connection stays up, the
  peer waits: a hung shard);
* ``disconnect`` — send a PREFIX of the payload then abort the transport
  (a shard dying mid-stream: the peer sees an incomplete read);
* ``garble`` — flip the first body byte (the serialized version
  prologue), so the framing stays aligned but the body reliably fails
  decode: the peer must count a malformed body and carry on, not crash.

Spec grammar (env ``SPTAG_FAULTINJECT`` / ini ``[Service] FaultInject``
or a per-server ctor override)::

    spec  := rule (';' rule)*
    rule  := kind ['@' site] [':' key '=' val (',' key '=' val)*]
    kind  := delay | drop | disconnect | garble
    keys  := p (probability, default 1) | ms (delay millis, default 100)
             | n (max fires, 0 = unlimited) | after (skip first N
             matching decisions at the site)

e.g. ``delay@server.respond:ms=2500,p=1`` or ``garble:p=0.1;drop:p=0.05``.
A rule without ``@site`` matches every site.

Storage faults (the crash-recovery matrix's other half): the
durability subsystem (io/wal.py write-ahead log, io/atomic.py snapshot
writers) exists to survive process death at ANY byte offset, and the
recovery tests need a deterministic way to die at chosen offsets:

* ``torn_write`` — the writer persists a PREFIX of the payload, then
  raises :class:`InjectedCrash` (power loss mid-write: the file carries
  a torn tail the reader must detect and truncate);
* ``short_read`` — a reader observes a PREFIX of the stored bytes (a
  truncated file / torn page at read time: checksums must fail loudly,
  never deserialize garbage);
* ``crash`` (alias ``crash_after``) — raise :class:`InjectedCrash`
  before the site does any work; sequence it with ``after=n`` to die at
  the n+1-th decision (``crash@save.post_rename:after=0`` dies at the
  first post-rename point — the classic pre-WAL-truncate window).

Storage sites consult the PROCESS-GLOBAL injector (persistence is not
per-server); the wire kinds never fire at storage sites and vice versa —
a rule's kind simply doesn't match the other family's application code.

Determinism: decisions consume draws from one ``random.Random(seed)``
(env ``SPTAG_FAULTINJECT_SEED`` / ini ``FaultInjectSeed``), so a fixed
spec + seed + call sequence replays the exact same fault schedule —
tests assert on behavior, not luck (``p=1`` rules are sequence-
independent outright).

Off by default: the module-level injector is disabled unless the env
spec is set, ``configure()`` is called, or a server was constructed with
a spec — and a disabled injector costs one attribute read per send
(``enabled`` is a plain bool), with serve wire bytes byte-identical
(the ci_check.sh off-parity pass covers this together with the
admission knobs).
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, List, Optional

from sptag_tpu_torch.utils import locksan, metrics

log = logging.getLogger(__name__)

KINDS = ("delay", "drop", "disconnect", "garble",
         # storage family (io/wal.py + io/atomic.py sites)
         "torn_write", "short_read", "crash")


class InjectedCrash(RuntimeError):
    """Simulated process death at a storage fault site.  Raised instead
    of killing the interpreter so the recovery tests can catch it,
    abandon the in-memory index, and reload from disk — the on-disk
    state at raise time is exactly what a real crash would leave."""


class Fault:
    """One injection decision, ready to apply at the wire site."""

    __slots__ = ("kind", "delay_s")

    def __init__(self, kind: str, delay_s: float = 0.0):
        self.kind = kind
        self.delay_s = delay_s

    def __repr__(self) -> str:              # pragma: no cover - debug aid
        return f"Fault({self.kind}, delay_s={self.delay_s})"


class _Rule:
    __slots__ = ("kind", "site", "p", "ms", "n", "after", "fired", "seen")

    def __init__(self, kind: str, site: str, p: float, ms: float,
                 n: int, after: int):
        self.kind = kind
        self.site = site
        self.p = p
        self.ms = ms
        self.n = n
        self.after = after
        self.fired = 0
        self.seen = 0


def _parse_spec(spec: str) -> List[_Rule]:
    rules: List[_Rule] = []
    for part in (s.strip() for s in spec.split(";")):
        if not part:
            continue
        head, _, params = part.partition(":")
        kind, _, site = head.partition("@")
        kind = kind.strip().lower()
        if kind == "crash_after":        # the spec-grammar alias: pair
            kind = "crash"               # with after=n to pick the point
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected one of {KINDS})")
        p, ms, n, after = 1.0, 100.0, 0, 0
        for kv in (t for t in params.split(",") if t):
            key, _, val = kv.partition("=")
            key = key.strip().lower()
            if key == "p":
                p = float(val)
            elif key == "ms":
                ms = float(val)
            elif key == "n":
                n = int(val)
            elif key == "after":
                after = int(val)
            else:
                raise ValueError(f"unknown fault param {key!r}")
        rules.append(_Rule(kind, site.strip(), p, ms, n, after))
    return rules


class Injector:
    """One independent fault plan (a server under test owns its own, so
    three shards in one process can fail three different ways)."""

    def __init__(self, spec: str = "", seed: int = 0):
        self._spec = spec or ""
        self._seed = int(seed)
        self._rules = _parse_spec(self._spec)
        self._rng = random.Random(self._seed)
        self._lock = locksan.make_lock("Injector._lock")
        #: plain bool so the hot-path off test is one attribute read
        self.enabled = bool(self._rules)
        if self.enabled:
            log.warning("fault injection ACTIVE: %s (seed %d)",
                        self._spec, self._seed)

    def decide(self, site: str) -> Optional[Fault]:
        """First matching rule that fires wins; each matching rule
        consumes exactly one deterministic draw."""
        if not self.enabled:
            return None
        with self._lock:
            for rule in self._rules:
                if rule.site and rule.site != site:
                    continue
                rule.seen += 1
                draw = self._rng.random()
                if rule.after and rule.seen <= rule.after:
                    continue
                if rule.n and rule.fired >= rule.n:
                    continue
                if draw >= rule.p:
                    continue
                rule.fired += 1
                fault = Fault(rule.kind, delay_s=rule.ms / 1000.0)
                self._count(rule.kind)
                return fault
        return None

    @staticmethod
    def _count(kind: str) -> None:
        # literal names per injected kind (GL602: the registry must never
        # see an interpolated name)
        if kind == "delay":
            metrics.inc("faultinject.delays")
        elif kind == "drop":
            metrics.inc("faultinject.drops")
        elif kind == "disconnect":
            metrics.inc("faultinject.disconnects")
        elif kind == "garble":
            metrics.inc("faultinject.garbles")
        elif kind == "torn_write":
            metrics.inc("faultinject.torn_writes")
        elif kind == "short_read":
            metrics.inc("faultinject.short_reads")
        elif kind == "crash":
            metrics.inc("faultinject.crashes")

    def snapshot(self) -> Dict:
        """Plain-data view for GET /debug/admission."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "spec": self._spec,
                "seed": self._seed,
                "rules": [{"kind": r.kind, "site": r.site or "*",
                           "p": r.p, "ms": r.ms, "n": r.n,
                           "after": r.after, "fired": r.fired,
                           "seen": r.seen} for r in self._rules],
            }


# ---------------------------------------------------------------------------
# process-global injector (env / configure surface)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[Injector] = None


def configure(spec: str = "", seed: int = 0) -> Injector:
    """Install the process-global injector (the env/ini surface); an
    empty spec disables it."""
    global _global
    with _global_lock:
        _global = Injector(spec, seed)
        return _global


def global_injector() -> Injector:
    """The process-global injector, lazily built from the environment
    (``SPTAG_FAULTINJECT`` / ``SPTAG_FAULTINJECT_SEED``); disabled when
    the env is unset."""
    global _global
    with _global_lock:
        if _global is None:
            spec = os.environ.get("SPTAG_FAULTINJECT", "")
            seed = int(os.environ.get("SPTAG_FAULTINJECT_SEED", "0") or 0)
            _global = Injector(spec, seed)
        return _global


def enabled() -> bool:
    return global_injector().enabled


def storage_fault(site: str) -> Optional[Fault]:
    """One injection decision at a STORAGE site (io/wal.py, io/atomic.py)
    against the process-global plan; None when disabled — the off cost
    is one attribute read, so durability paths stay fault-hook-free in
    production."""
    inj = global_injector()
    if not inj.enabled:
        return None
    return inj.decide(site)


def crash_point(site: str) -> None:
    """Die here if the plan says so — the seedable stand-in for `kill -9`
    between two filesystem operations.  Crash points sit BETWEEN writes
    (pre/post rename, pre-truncate), so only the ``crash`` kind is
    meaningful at them; a byte-level kind matching such a site is
    consumed and ignored (target byte-level kinds at the write/read
    sites instead)."""
    inj = global_injector()
    if not inj.enabled:
        return
    fault = inj.decide(site)
    if fault is not None and fault.kind == "crash":
        raise InjectedCrash(site)


def reset() -> None:
    """Drop the global injector (test isolation; the next access re-reads
    the environment)."""
    global _global
    with _global_lock:
        _global = None
