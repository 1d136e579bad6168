"""Ground-truth canary prober — silent-degradation detection at zero
live traffic (copy of ``sptag_tpu/serve/canary.py`` over the port's
utils, client and wire).

The quality monitor (§13) samples LIVE queries; an idle (or quietly
broken) deployment gives it nothing to sample, and an availability
objective (serve/slo.py) has no signal at all without traffic.  The
canary closes that hole: at index load it samples a small PROBE SET and
pins each probe's exact top-k via the oracle (`VectorIndex.exact_search
_batch` — the §13 always-exact scan), then a background worker replays
those probes through the **full serve path** — a loopback AnnClient, so
every probe pays the real wire framing, decode, admission, scheduler,
execute, encode and drain — and feeds end-to-end latency, availability
and EXACT recall into the timeline (``canary.latency_ms`` /
``canary.ok`` / ``canary.recall`` series) and the /metrics families
(``canary_recall{index=}``…).  A wrong answer is now detected in one
probe interval, with ground truth, before any user query sees it.

Canary isolation contract (DESIGN.md §21): probe requests carry a
``canary-`` request-id prefix and

* the admission controller EXCLUDES canary requests from per-client
  fair-share accounting (they must not distort tenant shares or be
  fairness-shed as the "hot client" on an idle server) while still
  passing through the real shed/degrade ladder — a shed canary is
  exactly the availability signal the SLO engine wants;
* the quality monitor's live windows EXCLUDE canary rids (the canary
  publishes its own exact recall; double-counting the same probes as
  "live" samples would bias the Wilson window toward the probe set).

Both tiers run one: the search server builds probes from its own
corpus rows (oracle ground truth); the aggregator — which has no
corpus — loads probe query lines from `CanaryProbeFile` and PINS THE
FIRST ANSWER as its reference (distance-based stability: a later drift
from the pinned merged top-k is exactly the silent-degradation signal
a merge/topology bug produces).  Off by default (`CanaryIntervalMs`
0): no thread, no probes, serve bytes byte-identical.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np

from sptag_tpu_torch.utils import locksan, metrics, qualmon, timeline

log = logging.getLogger(__name__)

#: request-id prefix marking canary traffic — the isolation contract's
#: wire-visible half (admission + qualmon key off it)
RID_PREFIX = "canary-"

#: default probe-set size per index
DEFAULT_PROBES = 8


def is_canary_rid(rid: str) -> bool:
    return rid.startswith(RID_PREFIX)


class CanaryProbe:
    """One pinned probe: the query text, the index it targets, and the
    ground truth (exact ids+dists from the oracle, or None until the
    first answer pins it in `pin_first` mode)."""

    __slots__ = ("text", "index_name", "k", "truth_ids", "truth_dists",
                 "pin_first")

    def __init__(self, text: str, index_name: str = "", k: int = 10,
                 truth_ids: Optional[List[int]] = None,
                 truth_dists: Optional[List[float]] = None,
                 pin_first: bool = False):
        self.text = text
        self.index_name = index_name
        self.k = k
        self.truth_ids = truth_ids
        self.truth_dists = truth_dists
        self.pin_first = pin_first


def probes_from_context(context, count: int = DEFAULT_PROBES,
                        k: int = 10) -> List[CanaryProbe]:
    """Sample `count` corpus rows per loaded index as self-queries and
    pin their exact top-k via the oracle.  Deterministic (evenly spaced
    live rows) so restarts probe the same set; indexes without an
    oracle or without rows contribute nothing."""
    out: List[CanaryProbe] = []
    for name, index in context.indexes.items():
        exact = getattr(index, "exact_search_batch", None)
        n = int(getattr(index, "num_samples", 0))
        if exact is None or n <= 0:
            continue
        vids = []
        for vid in np.linspace(0, n - 1, num=min(count, n),
                               dtype=np.int64):
            vid = int(vid)
            try:
                if index.contains_sample(vid):
                    vids.append(vid)
            except Exception:                            # noqa: BLE001
                continue
        if not vids:
            continue
        try:
            vecs = np.stack([np.asarray(index.get_sample(v),
                                        dtype=np.float32).reshape(-1)
                             for v in vids])
            truth_d, truth_ids = exact(vecs, k)
        except Exception:                                # noqa: BLE001
            log.exception("canary probe pinning failed for index %s",
                          name)
            continue
        for row, vid in enumerate(vids):
            # $resultnum pins the served k to the pinned truth's k —
            # without it the service default (often smaller) would cap
            # recall below 1.0 on a healthy index
            text = ("$indexname:%s $resultnum:%d " % (name, k)
                    + "|".join(repr(float(x)) for x in vecs[row]))
            out.append(CanaryProbe(
                text, index_name=name, k=k,
                truth_ids=[int(v) for v in truth_ids[row]],
                truth_dists=[float(d) for d in truth_d[row]]))
        log.info("canary: pinned %d probes for index %s (k=%d)",
                 len(vids), name, k)
    return out


def probes_from_file(path: str, k: int = 10) -> List[CanaryProbe]:
    """One probe per non-empty line of `path` (full text-protocol query
    lines), first-answer pinned — the aggregator tier's probe source."""
    out: List[CanaryProbe] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(CanaryProbe(line, k=k, pin_first=True))
    return out


class CanaryProber:
    """The background replay worker for one serving tier.  Owns a
    loopback AnnClient to `host:port` (the tier's OWN serve socket —
    the full-path contract) and probes round-robin every
    `interval_ms`, deadline-paced on the stop event."""

    def __init__(self, host: str, port: int, probes: List[CanaryProbe],
                 interval_ms: float = 1000.0, tier: str = "server",
                 timeout_s: float = 10.0):
        self.host = "127.0.0.1" if host in ("0.0.0.0", "::") else host
        self.port = port
        self.probes = probes
        self.interval_ms = max(float(interval_ms), 1.0)
        self.tier = tier
        self.timeout_s = timeout_s
        self._client = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = locksan.make_lock("CanaryProber._lock")
        self._seq = 0
        self._stats: Dict[str, dict] = {}   # index label -> window stats
        metrics.register_family_provider("canary", _canary_families)
        _probers.add(self)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if not self.probes or (self._thread is not None
                               and self._thread.is_alive()):
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="canary-prober")
        self._thread.start()
        log.info("canary prober armed: %d probes every %.0fms against "
                 "%s:%d", len(self.probes), self.interval_ms, self.host,
                 self.port)

    def stop(self) -> None:
        self._stop.set()
        # join the handle directly (the hostprof GL704 pattern)
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)
        self._thread = None
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                # a dead loopback socket at shutdown is expected noise,
                # but keep it visible at debug
                log.debug("canary client close failed", exc_info=True)
            self._client = None

    # ------------------------------------------------------------- worker

    def _ensure_client(self):
        if self._client is None:
            from sptag_tpu_torch.serve.client import AnnClient

            c = AnnClient(self.host, self.port, timeout_s=self.timeout_s,
                          heartbeat_interval_s=0.0)
            c.connect()
            self._client = c
        return self._client

    def _run(self) -> None:
        i = 0
        # deadline-based pacing on the stop event (never a bare sleep):
        # stop() takes effect within one interval
        while not self._stop.wait(self.interval_ms / 1000.0):
            probe = self.probes[i % len(self.probes)]
            i += 1
            try:
                self.probe_once(probe)
            except Exception:                            # noqa: BLE001
                # one broken probe costs one sample, never the worker
                metrics.inc("canary.errors")
                log.exception("canary probe failed")

    def probe_once(self, probe: CanaryProbe) -> dict:
        """Replay one probe through the full serve path and fold the
        outcome into the timeline + families.  Returns the outcome (the
        test surface)."""
        from sptag_tpu_torch.serve import wire

        with self._lock:
            self._seq += 1
            seq = self._seq
        rid = "%s%s-%d" % (RID_PREFIX, self.tier, seq)
        t0 = time.perf_counter()
        try:
            client = self._ensure_client()
            result = client.search(probe.text, request_id=rid,
                                   timeout_s=self.timeout_s)
        except OSError:
            result = wire.RemoteSearchResult(
                wire.ResultStatus.FailedNetwork, [])
        latency_ms = (time.perf_counter() - t0) * 1000.0
        ok = result.status == wire.ResultStatus.Success
        out = {"rid": rid, "ok": ok, "latency_ms": latency_ms,
               "status": int(result.status), "recall": None}
        metrics.inc("canary.probes")
        if not ok:
            metrics.inc("canary.failures")
            # a failed probe drops the dead loopback client so the next
            # probe re-dials a restarted listener
            if self._client is not None:
                try:
                    self._client.close()
                except OSError:
                    log.debug("canary client close failed",
                              exc_info=True)
                self._client = None
        metrics.observe("canary.latency", latency_ms / 1000.0)
        timeline.record("canary.ok", 1.0 if ok else 0.0)
        timeline.record("canary.latency_ms", latency_ms)
        if ok:
            recall = self._score(probe, result)
            if recall is not None:
                out["recall"] = recall
                timeline.record("canary.recall", recall)
        self._fold(probe, out)
        return out

    def _score(self, probe: CanaryProbe, result) -> Optional[float]:
        """Exact recall vs the pinned truth via THE canonical recall
        definition (qualmon.recall_row).  First-answer probes pin here
        and score 1.0 for the pinning reply by construction."""
        rows = [r for r in result.results
                if not probe.index_name
                or r.index_name == probe.index_name]
        if not rows:
            return None
        ids = [int(v) for v in rows[0].ids]
        dists = [float(d) for d in rows[0].dists]
        if probe.truth_ids is None:
            if not probe.pin_first or not ids:
                return None
            probe.truth_ids = ids
            probe.truth_dists = dists
        k = min(probe.k, len(probe.truth_ids))
        if k <= 0:
            return None
        return qualmon.recall_row(ids, probe.truth_ids, k, dists=dists,
                                  truth_dists=probe.truth_dists)

    def _fold(self, probe: CanaryProbe, out: dict) -> None:
        label = probe.index_name or self.tier
        with self._lock:
            st = self._stats.setdefault(
                label, {"probes": 0, "failures": 0, "recall_sum": 0.0,
                        "recall_n": 0, "recall_min": 1.0,
                        "latency_ms_last": 0.0})
            st["probes"] += 1
            if not out["ok"]:
                st["failures"] += 1
            st["latency_ms_last"] = round(out["latency_ms"], 3)
            if out["recall"] is not None:
                st["recall_sum"] += out["recall"]
                st["recall_n"] += 1
                st["recall_min"] = min(st["recall_min"], out["recall"])

    # ------------------------------------------------------------- surface

    def snapshot(self) -> dict:
        with self._lock:
            per_index = {
                label: dict(st, recall_mean=(
                    round(st["recall_sum"] / st["recall_n"], 4)
                    if st["recall_n"] else None))
                for label, st in self._stats.items()}
        return {"enabled": True, "tier": self.tier,
                "probe_count": len(self.probes),
                "interval_ms": self.interval_ms, "indexes": per_index}

    def families(self) -> List[metrics.Family]:
        recall = metrics.Family(
            "canary.recall",
            help="mean canary exact recall vs pinned ground truth")
        fails = metrics.Family("canary.failures_by_index")
        lat = metrics.Family("canary.latency_ms_last")
        with self._lock:
            for label, st in self._stats.items():
                labels = {"index": label, "tier": self.tier}
                if st["recall_n"]:
                    recall.add(round(st["recall_sum"] / st["recall_n"],
                                     4), labels)
                fails.add(st["failures"], labels)
                lat.add(st["latency_ms_last"], labels)
        return [recall, fails, lat]


_probers: "weakref.WeakSet[CanaryProber]" = weakref.WeakSet()


def _canary_families() -> List[metrics.Family]:
    out: List[metrics.Family] = []
    for p in list(_probers):
        out.extend(p.families())
    return out
