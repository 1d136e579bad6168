"""Aggregator — scatter-gather proxy over multiple search servers (copy
of ``sptag_tpu/serve/aggregator.py`` over the port's protocol, wire,
control plane and metrics listener).

Parity: AggregatorService/AggregatorContext (AnnService/src/
Aggregator/AggregatorService.cpp, inc/Aggregator/AggregatorContext.h:29-61):

* ini config: ``[Service]`` ListenAddr/ListenPort/Threads,
  ``[Servers] Number=N`` + ``[Server_<i>] Address=/Port=`` (AggregatorContext
  ctor);
* a reconnect loop re-dials Disconnected servers every 30 s
  (AggregatorService.cpp:139-194);
* each incoming SearchRequest fans out to every Connected server with a
  per-request timeout; the LAST finisher (atomic unfinished count,
  AggregatorExecutionContext.h:21-43) assembles the response
  (:206-304);
* the merge is a FLAT CONCATENATION of every server's per-index result
  lists — no global re-rank (:316-366); a timeout or network failure
  downgrades the overall status to the per-request partial statuses
  (Timeout / FailedNetwork, :242-262).

Framework extension: ``[Service] MergeTopK=true`` re-ranks the gathered
lists into ONE globally sorted top-K list per index name (`merge_top_k`)
— the merge the reference leaves to every client.  Off by default for
reference parity.

`start()` logs an advisory when a config fans out to several loopback
backends: the in-mesh serve path (``[Service] MeshServe=1`` over a sharded
mesh index, parallel/sharded.py) serves same-host shards in one process.
``[Service] TraceSanitizer`` arms the trace sentinel
(utils/recompile_guard.py) as the shard tier does.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import logging
import random
import time
import weakref
from typing import List, Optional, Tuple

from sptag_tpu_torch.serve import admission as admission_mod
from sptag_tpu_torch.serve import canary as canary_mod
from sptag_tpu_torch.serve import controller as controller_mod
from sptag_tpu_torch.serve import protocol, wire
from sptag_tpu_torch.serve import slo as slo_mod
from sptag_tpu_torch.serve.metrics_http import MetricsHttpServer
from sptag_tpu_torch.utils import (flightrec, hostprof, locksan, metrics,
                                   qualmon, timeline, trace)
from sptag_tpu_torch.utils.ini import IniReader

log = logging.getLogger(__name__)

#: the reference's fixed re-dial sweep interval (AggregatorService.cpp:
#: 139-194) — now the DEFAULT CAP of the per-server exponential backoff
#: (`ReconnectCapS`); the first retry after a drop is near-immediate
RECONNECT_INTERVAL_S = 30.0


def merge_top_k(per_server: List[List[wire.IndexSearchResult]],
                rel_tol: float = 1e-5,
                replica_groups: Optional[List[Optional[str]]] = None
                ) -> List[wire.IndexSearchResult]:
    """Re-rank flat-gathered per-server lists into one globally sorted
    top-K list per index name (framework extension; the reference returns
    the lists unmerged, AggregatorService.cpp:316-366).

    `per_server` is one result list per replying backend.  K per index =
    the most REAL (non-sentinel) entries any single backend returned for
    that name.  Vector ids are shard-LOCAL, so two servers' equal ids may
    be different vectors: entry identity is always (server, id), and
    metadata is used ONLY to collapse replicas — same metadata bytes AND
    a distance within `rel_tol` relative tolerance (bit-equality would be
    the same kernel on the same padding; heterogeneous backends — a
    reference C++ server next to this one, or differently padded shards
    with different XLA reduction orders — score the same vector with a
    few-ULP spread).  `rel_tol=0` demands bit-equality.

    CAVEAT: with integer-valued distance conventions (int8/
    int16 corpora score integer L2/cosine), two DISTINCT vectors sharing
    a non-unique metadata label can tie at exactly the same distance and
    would be conflated by the tolerance test alone.  `replica_groups`
    (one group label per server, None = not a replica of anything)
    restricts the collapse to servers DECLARED as replicas of each other:
    when given, entries collapse only if their servers carry the same
    non-None group label.  Shard topologies (every server a distinct
    corpus slice) should declare no groups — exact integer ties then
    survive the merge.  Ties break on distance then id for determinism."""
    groups: dict = {}
    for srv_i, results in enumerate(per_server):
        for r in results:
            groups.setdefault(r.index_name, []).append((srv_i, r))

    def _collapsible(a: int, b: int) -> bool:
        if a == b:
            # one server never returns the same vector twice, so two
            # entries from the same reply are ALWAYS distinct vectors —
            # a within-reply metadata+distance tie must never collapse
            return False
        if replica_groups is None:
            return True            # legacy: any cross-server pair may
        ga = replica_groups[a] if a < len(replica_groups) else None
        gb = replica_groups[b] if b < len(replica_groups) else None
        return ga is not None and ga == gb

    out: List[wire.IndexSearchResult] = []
    for name, rs in groups.items():
        k = max(sum(1 for v in r.ids if v >= 0) for _, r in rs)
        has_meta = any(r.metas is not None for _, r in rs)
        entries = []
        for srv_i, r in rs:
            metas = (r.metas if r.metas is not None
                     else [b""] * len(r.ids))
            for vid, dist, meta in zip(r.ids, r.dists, metas):
                if vid >= 0:
                    entries.append((float(dist), int(vid), meta, srv_i))
        entries.sort(key=lambda e: (e[0], e[1]))
        kept_dists: dict = {}   # meta -> (distance, server) already kept
        best = []
        for dist, vid, meta, srv_i in entries:
            if has_meta and meta:
                prior = kept_dists.setdefault(meta, [])
                tol = rel_tol * max(abs(dist), 1.0)
                if any(abs(dist - d0) <= tol and _collapsible(srv_i, s0)
                       for d0, s0 in prior):
                    continue                  # replica of a kept entry
                prior.append((dist, srv_i))
            best.append((dist, vid, meta))
            if len(best) == k:
                break
        out.append(wire.IndexSearchResult(
            name, [v for _, v, _ in best], [d for d, _, _ in best],
            [m for _, _, m in best] if has_meta else None))
    return out


@dataclasses.dataclass
class RemoteServer:
    address: str
    port: int
    # MergeTopK collapse scope: servers sharing a non-None ReplicaGroup
    # label are declared replicas of one another (see merge_top_k)
    replica_group: Optional[str] = None
    reader: Optional[asyncio.StreamReader] = None
    writer: Optional[asyncio.StreamWriter] = None
    # per-backend latency distribution (an UNREGISTERED Histogram
    # instance — the registry's names must be literals/bounded, and the
    # backend set is config-bounded here instead).  Feeds the hedge
    # trigger and GET /debug/admission.
    latency: metrics.Histogram = dataclasses.field(
        default_factory=lambda: metrics.Histogram("backend"))
    # reconnect backoff state (capped exponential + jitter; see
    # _reconnect_loop): 0 backoff = dial immediately
    backoff_s: float = 0.0
    next_dial: float = 0.0
    reconnect_attempts: int = 0
    # in-flight requests keyed by resource_id — the asyncio analog of the
    # reference's ResourceManager callback registry
    # (inc/Socket/ResourceManager.h:31-184).  A dedicated reader task
    # dispatches each response to its future, so requests PIPELINE on one
    # connection (no per-round-trip lock) and a timed-out request leaves the
    # stream aligned: the late reply is read and discarded by resource_id.
    pending: dict = dataclasses.field(default_factory=dict)
    reader_task: Optional[asyncio.Task] = None
    next_rid: int = 1
    # serializes write+drain: concurrent client tasks pipeline onto ONE
    # backend connection, and two drain() waiters trip an assertion in
    # asyncio's flow control on Python 3.10/3.11 (the server's send lock
    # guards the same)
    wlock: asyncio.Lock = dataclasses.field(default_factory=asyncio.Lock)

    @property
    def connected(self) -> bool:
        return self.writer is not None and not self.writer.is_closing()

    def drop(self) -> None:
        """Tear down the connection and fail every in-flight request."""
        if self.reader_task is not None and \
                self.reader_task is not asyncio.current_task():
            self.reader_task.cancel()
        self.reader_task = None
        if self.writer is not None:
            self.writer.close()
        self.reader = None
        self.writer = None
        pending, self.pending = self.pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(OSError("connection dropped"))


def _merge_quality_check(rid: str,
                         per_server: List[List[wire.IndexSearchResult]],
                         merged: List[wire.IndexSearchResult],
                         rel_tol: float) -> None:
    """Quality-monitor shadow job for the aggregator tier: per index
    name, the fraction of the IDEAL union top-k (every shard entry,
    globally sorted by distance) the merged list preserved.  Matching is
    by DISTANCE at the merge's OWN tolerance (`MergeRelTol`) — vector
    ids are shard-local and not comparable across backends.  A
    kept-entry agreement below QualityRecallFloor is triaged as a merge
    drop.

    Names where any reply entry carries metadata are SKIPPED: metadata
    is the merge's replica-collapse key, so there the raw union
    legitimately contains one copy per replica and an undeduplicated
    ideal would score the INTENDED collapse as lost recall — a
    permanent false alarm on every replica deployment.  The check
    therefore measures exactly what it can honestly measure: the
    collapse-free merge path (shard topologies, the common case)."""
    by_name: dict = {}
    meta_names: set = set()
    for results in per_server:
        for r in results:
            if r.metas is not None and any(r.metas):
                meta_names.add(r.index_name)
            by_name.setdefault(r.index_name, []).extend(
                float(d) for v, d in zip(r.ids, r.dists) if v >= 0)
    for m in merged:
        union = by_name.get(m.index_name)
        mdists = [float(d) for v, d in zip(m.ids, m.dists) if v >= 0]
        if not union or not mdists or m.index_name in meta_names:
            continue
        k = len(mdists)
        ideal = sorted(union)[:k]
        agreement = qualmon.dist_recall(mdists, ideal, k,
                                        rel_tol=max(rel_tol, 0.0))
        verdict = detail = ""
        floor = qualmon.recall_floor()
        if floor > 0 and agreement < floor:
            verdict = "merge_drop"
            detail = ("dropped in the aggregator merge: kept %d of the "
                      "union's top-%d" % (round(agreement * k), k))
        qualmon.record_sample("merge", "aggregator", agreement, k,
                              rid=rid, verdict=verdict, detail=detail)


class AggregatorContext:
    def __init__(self, listen_addr: str = "0.0.0.0",
                 listen_port: int = 8100,
                 search_timeout_s: float = 9.0,
                 merge_top_k: bool = False,
                 merge_rel_tol: float = 1e-5,
                 metrics_port: int = 0,
                 metrics_host: str = "127.0.0.1",
                 slow_query_threshold_ms: float = 0.0,
                 trace_requests: bool = True,
                 flight_recorder: bool = False,
                 flight_recorder_events: int = 0,
                 flight_dump_on_slow_query: str = "",
                 quality_sample_rate: float = 0.0,
                 quality_recall_floor: float = 0.0,
                 quality_shadow_budget: float = 0.0,
                 quality_window: int = 0,
                 admission_control: bool = False,
                 admission_degrade_queue_frac: float = 0.5,
                 admission_shed_queue_frac: float = 0.9,
                 admission_degrade_slot_wait_ms: float = 250.0,
                 admission_shed_slot_wait_ms: float = 1000.0,
                 admission_fair_share: float = 0.5,
                 admission_recover_hold_ms: float = 2000.0,
                 max_inflight: int = 1024,
                 degrade_max_check_floor: int = 512,
                 deadline_ms: float = 0.0,
                 hedge_percentile: float = 95.0,
                 hedge_budget: float = 0.0,
                 hedge_min_ms: float = 1.0,
                 reconnect_base_ms: float = 250.0,
                 reconnect_cap_s: float = RECONNECT_INTERVAL_S,
                 host_prof_hz: float = 0.0,
                 host_prof_events: int = 0,
                 host_prof_dump_on_slow_query: bool = False,
                 lock_contention_ledger: bool = False,
                 race_sanitizer: bool = False,
                 racesan_sample_rate: float = 1.0,
                 trace_sanitizer: bool = False,
                 tracesan_compile_budget: int = 0,
                 timeline_interval_ms: float = 0.0,
                 timeline_events: int = 0,
                 slo_availability_target: float = 0.0,
                 slo_p99_ms: float = 0.0,
                 slo_recall_floor: float = 0.0,
                 slo_qps_floor: float = 0.0,
                 slo_budget: float = 0.05,
                 slo_fast_window_s: float = 60.0,
                 slo_slow_window_s: float = 300.0,
                 slo_warn_burn: float = 1.0,
                 slo_page_burn: float = 4.0,
                 canary_interval_ms: float = 0.0,
                 canary_probe_file: str = "",
                 canary_k: int = 10,
                 controller: bool = False,
                 controller_cooldown_ms: float = 10000.0,
                 controller_hold_ms: float = 30000.0,
                 controller_revert_window_ms: float = 15000.0,
                 controller_max_check_floor: int = 256,
                 controller_recall_floor: float = 0.0):
        self.listen_addr = listen_addr
        self.listen_port = listen_port
        self.search_timeout_s = search_timeout_s
        self.merge_top_k = merge_top_k
        self.merge_rel_tol = merge_rel_tol
        # observability: /metrics + /healthz port (0 disables, negative
        # binds OS-ephemeral; host defaults to loopback — exposing the
        # unauthenticated endpoint is an operator choice) and slow-query
        # log threshold (0 disables)
        self.metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.slow_query_threshold_ms = slow_query_threshold_ms
        # False = never repack id-less queries to the extended wire layout
        # (client.py trace_requests analog) — for backends that must see
        # reference-exact minor-version-0 bodies; existing wire/text ids
        # still ride through untouched
        self.trace_requests = trace_requests
        # flight recorder (utils/flightrec.py) — [Service]
        # parity with the shard tier: ring on/off, ring size, ringed
        # auto-dump dir on slow/errored requests
        self.flight_recorder = flight_recorder
        self.flight_recorder_events = flight_recorder_events
        self.flight_dump_on_slow_query = flight_dump_on_slow_query
        # search-quality monitor (utils/qualmon.py) — [Service]
        # parity with the shard tier.  The aggregator has no corpus to
        # replay against; its sampled check is the MERGE itself: with
        # MergeTopK on, the merged top-k's distances are compared to the
        # ideal top-k over the union of shard replies (ids are shard-
        # local, distances are comparable), so a replica-collapse or
        # merge bug that drops a better candidate is measured, triaged
        # ("dropped in the aggregator merge") and flight-dumped.
        self.quality_sample_rate = quality_sample_rate
        self.quality_recall_floor = quality_recall_floor
        self.quality_shadow_budget = quality_shadow_budget
        self.quality_window = quality_window
        # overload defense (serve/admission.py) — attribute
        # names intentionally match ServiceSettings so
        # admission.config_from_settings duck-types over both tiers.
        # The aggregator's "queue" is its in-flight request count over
        # `max_inflight`; its latency signal is its own request p99.
        self.admission_control = admission_control
        self.admission_degrade_queue_frac = admission_degrade_queue_frac
        self.admission_shed_queue_frac = admission_shed_queue_frac
        self.admission_degrade_slot_wait_ms = admission_degrade_slot_wait_ms
        self.admission_shed_slot_wait_ms = admission_shed_slot_wait_ms
        self.admission_fair_share = admission_fair_share
        self.admission_recover_hold_ms = admission_recover_hold_ms
        self.max_inflight = max_inflight
        self.degrade_max_check_floor = degrade_max_check_floor
        # default per-request deadline (ms of budget, re-anchored at
        # arrival; 0 = none).  Requests carrying their own deadline —
        # wire minor-2 trailer or the $deadlinems text option — keep it;
        # the aggregator decrements the remaining budget into the
        # forwarded bodies so shards drop work the client gave up on.
        self.deadline_ms = deadline_ms
        # hedged fan-out: when a backend's reply is slower than the
        # fleet's `hedge_percentile` latency, duplicate the request to a
        # replica (same ReplicaGroup; without groups, re-send to the
        # same backend — other shards hold DIFFERENT corpus slices).
        # First reply wins, the loser is deregistered.  `hedge_budget`
        # caps hedges as a fraction of fan-out requests; 0 = hedging off.
        self.hedge_percentile = hedge_percentile
        self.hedge_budget = hedge_budget
        self.hedge_min_ms = hedge_min_ms
        # reconnect backoff (replaces the fixed 30 s sweep)
        self.reconnect_base_ms = reconnect_base_ms
        self.reconnect_cap_s = reconnect_cap_s
        # host sampling profiler + lock-contention ledger —
        # [Service] parity with the shard tier (utils/hostprof.py,
        # utils/locksan.py); all off by default
        self.host_prof_hz = host_prof_hz
        self.host_prof_events = host_prof_events
        self.host_prof_dump_on_slow_query = host_prof_dump_on_slow_query
        self.lock_contention_ledger = lock_contention_ledger
        # race sanitizer: [Service] parity with the shard tier
        self.race_sanitizer = race_sanitizer
        self.racesan_sample_rate = racesan_sample_rate
        # trace/transfer sentinel: [Service] parity with the
        # shard tier — the aggregator itself dispatches no device work,
        # but arming here keeps one ini fragment valid for both tiers
        # (and bites if a future merge path grows a device stage)
        self.trace_sanitizer = trace_sanitizer
        self.tracesan_compile_budget = tracesan_compile_budget
        # serving timeline + SLO engine + canary — [Service]
        # parity with the shard tier.  The aggregator has no corpus to
        # pin ground truth from, so its canary loads probe query lines
        # from CanaryProbeFile and pins THE FIRST ANSWER as reference
        # (distance-stability: later drift from the pinned merged top-k
        # is the silent-degradation signal a merge/topology bug makes).
        self.timeline_interval_ms = timeline_interval_ms
        self.timeline_events = timeline_events
        self.slo_availability_target = slo_availability_target
        self.slo_p99_ms = slo_p99_ms
        self.slo_recall_floor = slo_recall_floor
        self.slo_qps_floor = slo_qps_floor
        self.slo_budget = slo_budget
        self.slo_fast_window_s = slo_fast_window_s
        self.slo_slow_window_s = slo_slow_window_s
        self.slo_warn_burn = slo_warn_burn
        self.slo_page_burn = slo_page_burn
        self.canary_interval_ms = canary_interval_ms
        self.canary_probe_file = canary_probe_file
        self.canary_k = canary_k
        # online controller (serve/controller.py): on this
        # tier the actuators are the hedge percentile and the admission
        # degrade floor — [Service] parity with the shard tier
        self.controller = controller
        self.controller_cooldown_ms = controller_cooldown_ms
        self.controller_hold_ms = controller_hold_ms
        self.controller_revert_window_ms = controller_revert_window_ms
        self.controller_max_check_floor = controller_max_check_floor
        self.controller_recall_floor = controller_recall_floor
        self.servers: List[RemoteServer] = []

    @classmethod
    def from_ini(cls, path: str) -> "AggregatorContext":
        reader = IniReader.load(path)
        ctx = cls(
            listen_addr=reader.get_parameter("Service", "ListenAddr",
                                             "0.0.0.0"),
            listen_port=int(reader.get_parameter("Service", "ListenPort",
                                                 "8100")),
            search_timeout_s=float(reader.get_parameter(
                "Service", "SearchTimeout", "9")),
            merge_top_k=reader.get_parameter(
                "Service", "MergeTopK", "false").lower() in
            ("true", "1", "yes"),
            merge_rel_tol=float(reader.get_parameter(
                "Service", "MergeRelTol", "1e-5")),
            metrics_port=int(reader.get_parameter(
                "Service", "MetricsPort", "0")),
            metrics_host=reader.get_parameter(
                "Service", "MetricsHost", "127.0.0.1"),
            slow_query_threshold_ms=float(reader.get_parameter(
                "Service", "SlowQueryThresholdMs", "0")),
            trace_requests=reader.get_parameter(
                "Service", "TraceRequests", "1").lower() in
            ("1", "true", "on", "yes"),
            flight_recorder=reader.get_parameter(
                "Service", "FlightRecorder", "0").lower() in
            ("1", "true", "on", "yes"),
            flight_recorder_events=int(reader.get_parameter(
                "Service", "FlightRecorderEvents", "0")),
            flight_dump_on_slow_query=reader.get_parameter(
                "Service", "FlightDumpOnSlowQuery", ""),
            quality_sample_rate=float(reader.get_parameter(
                "Service", "QualitySampleRate", "0")),
            quality_recall_floor=float(reader.get_parameter(
                "Service", "QualityRecallFloor", "0")),
            quality_shadow_budget=float(reader.get_parameter(
                "Service", "QualityShadowBudget", "0")),
            quality_window=int(reader.get_parameter(
                "Service", "QualityWindow", "0")),
            admission_control=reader.get_parameter(
                "Service", "AdmissionControl", "0").lower() in
            ("1", "true", "on", "yes"),
            admission_degrade_queue_frac=float(reader.get_parameter(
                "Service", "AdmissionDegradeQueueFrac", "0.5")),
            admission_shed_queue_frac=float(reader.get_parameter(
                "Service", "AdmissionShedQueueFrac", "0.9")),
            admission_degrade_slot_wait_ms=float(reader.get_parameter(
                "Service", "AdmissionDegradeSlotWaitMs", "250")),
            admission_shed_slot_wait_ms=float(reader.get_parameter(
                "Service", "AdmissionShedSlotWaitMs", "1000")),
            admission_fair_share=float(reader.get_parameter(
                "Service", "AdmissionFairShare", "0.5")),
            admission_recover_hold_ms=float(reader.get_parameter(
                "Service", "AdmissionRecoverHoldMs", "2000")),
            max_inflight=int(reader.get_parameter(
                "Service", "AdmissionMaxInflight", "1024")),
            degrade_max_check_floor=int(reader.get_parameter(
                "Service", "DegradeMaxCheckFloor", "512")),
            deadline_ms=float(reader.get_parameter(
                "Service", "DeadlineMs", "0")),
            hedge_percentile=float(reader.get_parameter(
                "Service", "HedgePercentile", "95")),
            hedge_budget=float(reader.get_parameter(
                "Service", "HedgeBudget", "0")),
            hedge_min_ms=float(reader.get_parameter(
                "Service", "HedgeMinMs", "1")),
            reconnect_base_ms=float(reader.get_parameter(
                "Service", "ReconnectBaseMs", "250")),
            reconnect_cap_s=float(reader.get_parameter(
                "Service", "ReconnectCapS",
                str(RECONNECT_INTERVAL_S))),
            host_prof_hz=float(reader.get_parameter(
                "Service", "HostProfHz", "0")),
            host_prof_events=int(reader.get_parameter(
                "Service", "HostProfEvents", "0")),
            host_prof_dump_on_slow_query=reader.get_parameter(
                "Service", "HostProfDumpOnSlowQuery", "0").lower() in
            ("1", "true", "on", "yes"),
            lock_contention_ledger=reader.get_parameter(
                "Service", "LockContentionLedger", "0").lower() in
            ("1", "true", "on", "yes"),
            race_sanitizer=reader.get_parameter(
                "Service", "RaceSanitizer", "0").lower() in
            ("1", "true", "on", "yes", "strict"),
            racesan_sample_rate=float(reader.get_parameter(
                "Service", "RaceSanSampleRate", "1")),
            trace_sanitizer=reader.get_parameter(
                "Service", "TraceSanitizer", "0").lower() in
            ("1", "true", "on", "yes", "strict"),
            tracesan_compile_budget=int(reader.get_parameter(
                "Service", "TraceSanCompileBudget", "0")),
            timeline_interval_ms=float(reader.get_parameter(
                "Service", "TimelineIntervalMs", "0")),
            timeline_events=int(reader.get_parameter(
                "Service", "TimelineEvents", "0")),
            slo_availability_target=float(reader.get_parameter(
                "Service", "SloAvailabilityTarget", "0")),
            slo_p99_ms=float(reader.get_parameter(
                "Service", "SloP99Ms", "0")),
            slo_recall_floor=float(reader.get_parameter(
                "Service", "SloRecallFloor", "0")),
            slo_qps_floor=float(reader.get_parameter(
                "Service", "SloQpsFloor", "0")),
            slo_budget=float(reader.get_parameter(
                "Service", "SloBudget", "0.05")),
            slo_fast_window_s=float(reader.get_parameter(
                "Service", "SloFastWindowS", "60")),
            slo_slow_window_s=float(reader.get_parameter(
                "Service", "SloSlowWindowS", "300")),
            slo_warn_burn=float(reader.get_parameter(
                "Service", "SloWarnBurn", "1")),
            slo_page_burn=float(reader.get_parameter(
                "Service", "SloPageBurn", "4")),
            canary_interval_ms=float(reader.get_parameter(
                "Service", "CanaryIntervalMs", "0")),
            canary_probe_file=reader.get_parameter(
                "Service", "CanaryProbeFile", ""),
            canary_k=int(reader.get_parameter(
                "Service", "CanaryK", "10")),
            controller=reader.get_parameter(
                "Service", "Controller", "0").lower() in
            ("1", "true", "on", "yes"),
            controller_cooldown_ms=float(reader.get_parameter(
                "Service", "ControllerCooldownMs", "10000")),
            controller_hold_ms=float(reader.get_parameter(
                "Service", "ControllerHoldMs", "30000")),
            controller_revert_window_ms=float(reader.get_parameter(
                "Service", "ControllerRevertWindowMs", "15000")),
            controller_max_check_floor=int(reader.get_parameter(
                "Service", "ControllerMaxCheckFloor", "256")),
            controller_recall_floor=float(reader.get_parameter(
                "Service", "ControllerRecallFloor", "0")),
        )
        if ctx.lock_contention_ledger:
            # arm before any client/connection locks are created (the
            # ServiceContext.from_ini timing contract)
            from sptag_tpu_torch.utils import locksan
            locksan.enable_contention()
        if ctx.race_sanitizer:
            from sptag_tpu_torch.utils import locksan
            locksan.enable_racesan(
                strict=(reader.get_parameter(
                    "Service", "RaceSanitizer", "0").lower() == "strict"),
                sample_rate=ctx.racesan_sample_rate)
        if ctx.trace_sanitizer:
            from sptag_tpu_torch.utils import recompile_guard
            recompile_guard.enable_tracesan(
                strict=(reader.get_parameter(
                    "Service", "TraceSanitizer", "0").lower() == "strict"),
                compile_budget=(ctx.tracesan_compile_budget or None))
        count = int(reader.get_parameter("Servers", "Number", "0"))
        for i in range(count):
            section = f"Server_{i}"
            addr = reader.get_parameter(section, "Address", "")
            port = reader.get_parameter(section, "Port", "")
            if addr and port:
                group = reader.get_parameter(section, "ReplicaGroup", "")
                ctx.servers.append(RemoteServer(
                    addr, int(port), replica_group=group or None))
        return ctx


# ---------------------------------------------------------------------------
# cross-host shard-skew telemetry: the socket tier's analog
# of the mesh scheduler's per-shard iteration series — per-backend reply
# p99 from the existing unregistered latency histograms, published as
# labeled families so /metrics and the timeline see which shard is the
# straggler in a fan-out topology (the e2e drill's "skew gauge names
# the shard" surface)
# ---------------------------------------------------------------------------

_services: "weakref.WeakSet" = weakref.WeakSet()


def _backend_skew_families() -> List[metrics.Family]:
    fams: List[metrics.Family] = []
    for svc in list(_services):
        p99 = metrics.Family(
            "aggregator.backend_p99_ms",
            help="per-backend reply p99 (the cross-host shard-skew "
                 "series; the straggler is the max)")
        rows = []
        for s in svc.context.servers:
            if s.latency.count == 0:
                continue
            ms = s.latency.percentile(99) * 1000.0
            rows.append(("%s:%d" % (s.address, s.port), ms))
            p99.add(round(ms, 3), {"backend": "%s:%d" % (s.address,
                                                         s.port)})
        if not rows:
            continue
        fams.append(p99)
        vals = [ms for _b, ms in rows]
        mean = sum(vals) / len(vals)
        straggler = max(rows, key=lambda r: r[1])
        skew = metrics.Family(
            "aggregator.backend_skew",
            help="straggler backend's p99 excess over the fleet mean "
                 "(0 = balanced)")
        skew.add(round(max(vals) / mean - 1.0, 4) if mean > 0 else 0.0)
        fams.append(skew)
        strag = metrics.Family(
            "aggregator.backend_straggler",
            help="1 on the backend with the worst reply p99")
        for b, _ms in rows:
            strag.add(1 if b == straggler[0] else 0, {"backend": b})
        fams.append(strag)
    return fams


metrics.register_family_provider("aggregator_skew",
                                 _backend_skew_families)


@locksan.race_track
class AggregatorService:
    def __init__(self, context: AggregatorContext,
                 admission: Optional[
                     admission_mod.AdmissionController] = None):
        self.context = context
        self._server: Optional[asyncio.AbstractServer] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._metrics_http: Optional[MetricsHttpServer] = None
        # overload defense: ctor-injected controller is the
        # test surface, [Service] AdmissionControl the deployment one
        if admission is not None:
            self._admission: Optional[
                admission_mod.AdmissionController] = admission
            admission.bind_signals(self._admission_signals)
        elif context.admission_control:
            self._admission = admission_mod.AdmissionController(
                admission_mod.config_from_settings(context),
                signals=self._admission_signals)
        else:
            self._admission = None
        # the request p99 admission reads, over its window
        self._request_p99 = metrics.WindowedPercentile(
            "aggregator.request", admission_mod.SIGNAL_WINDOW_S,
            self._admission.clock if self._admission is not None
            else time.monotonic)
        self._inflight = 0
        self._next_client = 1
        # hedge budget accounting: hedges issued vs fan-out requests seen
        self._fanouts = 0
        self._hedges_issued = 0
        # connections whose decoded rids identified them as canary
        # traffic (serve/canary.py): excluded from admission fair-share
        # accounting from their next request on
        self._canary_conns: set = set()
        # open client connections: stop() aborts them, since Python
        # 3.12's wait_closed() waits for every one of them
        self._client_writers: dict = {}
        # serving timeline + SLO engine + canary
        self._slo: Optional[slo_mod.SloEngine] = None
        self._canary: Optional[canary_mod.CanaryProber] = None
        # closed loop
        self._controller: Optional[controller_mod.Controller] = None
        _services.add(self)

    def _admission_signals(self) -> dict:
        """Aggregator pressure signals: in-flight fraction of the
        admission cap, plus this tier's own request p99 (there is no
        scheduler here — end-to-end latency IS the congestion signal),
        over the last ``admission.SIGNAL_WINDOW_S`` seconds."""
        return {
            "queue_frac": self._inflight / max(self.context.max_inflight,
                                               1),
            "slot_wait_p99_ms": self._request_p99.percentile(99) * 1000.0,
            "occupancy": 0.0,
        }

    def _admission_debug(self) -> dict:
        """GET /debug/admission payload: controller state, hedge
        accounting, per-backend latency/backoff, deadline drops."""
        out = {"enabled": self._admission is not None,
               "tier": "aggregator"}
        if self._admission is not None:
            out.update(self._admission.snapshot())
        out["hedge"] = {
            "budget": self.context.hedge_budget,
            "percentile": self.context.hedge_percentile,
            "fanouts": self._fanouts,
            "issued": self._hedges_issued,
            "wins": metrics.counter_value("aggregator.hedge_wins"),
            "budget_denied": metrics.counter_value(
                "aggregator.hedge_budget_denied"),
        }
        out["backends"] = [
            {"address": s.address, "port": s.port,
             "connected": s.connected,
             "backoff_s": round(s.backoff_s, 3),
             "reconnect_attempts": s.reconnect_attempts,
             "latency_p99_ms": round(s.latency.percentile(99) * 1000.0,
                                     3)}
            for s in self.context.servers]
        out["deadline_drops"] = metrics.counter_value(
            "aggregator.deadline_drops")
        return out

    def _slo_debug(self) -> dict:
        """GET /debug/slo payload for this tier (engine + canary)."""
        out = (self._slo.snapshot() if self._slo is not None
               else {"enabled": False})
        out["tier"] = "aggregator"
        if self._canary is not None:
            out["canary"] = self._canary.snapshot()
        return out

    def _controller_debug(self) -> dict:
        """GET /debug/controller payload for this tier."""
        if self._controller is None:
            return {"enabled": False, "tier": "aggregator"}
        return self._controller.snapshot()

    async def start(self, host: Optional[str] = None,
                    port: Optional[int] = None):
        if self.context.metrics_port or \
                self.context.slow_query_threshold_ms > 0:
            metrics.install_request_id_logging()
        if self.context.flight_recorder:
            flightrec.configure(
                enabled=True,
                max_events=self.context.flight_recorder_events or None,
                dump_dir=self.context.flight_dump_on_slow_query or None)
        if self.context.lock_contention_ledger:
            locksan.enable_contention()
        if self.context.race_sanitizer:
            locksan.enable_racesan(
                sample_rate=self.context.racesan_sample_rate)
        if self.context.trace_sanitizer:
            from sptag_tpu_torch.utils import recompile_guard
            recompile_guard.enable_tracesan(
                compile_budget=(self.context.tracesan_compile_budget
                                or None))
        if self.context.host_prof_hz > 0:
            # host sampler (utils/hostprof.py): process-wide;
            # never started at the default HostProfHz=0
            hostprof.configure(
                hz=self.context.host_prof_hz,
                max_samples=self.context.host_prof_events or None,
                dump_on_slow_query=self.context
                .host_prof_dump_on_slow_query or None)
            hostprof.start()
        if self.context.quality_sample_rate > 0:
            qualmon.configure(
                sample_rate=self.context.quality_sample_rate,
                recall_floor=self.context.quality_recall_floor,
                shadow_budget_gflops=self.context.quality_shadow_budget,
                window=self.context.quality_window or None)
        # serving timeline + SLO engine: [Service] parity
        # with the shard tier — declaring any objective arms the
        # timeline implicitly
        slo_cfg = slo_mod.config_from_settings(self.context)
        if self.context.timeline_interval_ms > 0 \
                or slo_mod.armed(slo_cfg) \
                or self.context.canary_interval_ms > 0:
            timeline.configure(
                enabled=True,
                interval_ms=(self.context.timeline_interval_ms
                             if self.context.timeline_interval_ms > 0
                             else None),
                capacity=self.context.timeline_events or None)
            timeline.start()
        if slo_mod.armed(slo_cfg):
            self._slo = slo_mod.SloEngine(slo_cfg, tier="aggregator")
            timeline.add_tick_listener(self._slo.evaluate)
        ctl_cfg = controller_mod.config_from_settings(self.context)
        if controller_mod.armed(ctl_cfg):
            # closed loop: this tier has no MaxCheck — its
            # actuators are the admission degrade floor and the hedge
            # trigger percentile (lower = hedge sooner, shorter tail at
            # more duplicate work), all via the live-actuation registry
            if self._slo is None:
                log.warning("Controller=1 but no SLO objective "
                            "declared; controller stays off")
            else:
                self._controller = controller_mod.Controller(
                    ctl_cfg, tier="aggregator")
                self._controller.bind_slo(self._slo)
                if self._admission is not None:
                    adm_cfg = self._admission.config
                    self._controller.bind_tier_knob(
                        "DegradeMaxCheckFloor",
                        read=lambda c=adm_cfg: float(
                            c.degrade_max_check_floor),
                        apply=lambda v, c=adm_cfg: setattr(
                            c, "degrade_max_check_floor", int(v)))
                ctx = self.context
                self._controller.bind_tier_knob(
                    "HedgePercentile",
                    read=lambda: float(ctx.hedge_percentile),
                    apply=lambda v: setattr(ctx, "hedge_percentile",
                                            float(v)))
                timeline.add_tick_listener(self._controller.evaluate)
        if self.context.metrics_port:
            # bind first: a metrics-port clash must fail start() before
            # backend connections, the reconnect task, or the listen
            # socket exist (no half-started aggregator on error)
            self._metrics_http = MetricsHttpServer(
                self.context.metrics_port, health=self._healthz,
                host=self.context.metrics_host,
                admission=self._admission_debug,
                slo=self._slo_debug,
                controller=self._controller_debug)
            self._metrics_http.start()
        # same-host advisory: socket fan-out between processes on one
        # machine pays framing + host merge that the in-process mesh
        # (parallel/sharded.py) does not; flag configs still fanning out
        # to several loopback backends (count only; behavior unchanged)
        local = sum(1 for s in self.context.servers
                    if s.address in ("127.0.0.1", "localhost", "::1"))
        if local > 1:
            metrics.set_gauge("aggregator.same_host_backends", local)
            log.warning(
                "aggregator fans out to %d same-host backends — the "
                "in-mesh serve path ([Service] MeshServe=1 over a "
                "sharded mesh index) replaces same-host fan-out with one "
                "process's shard search and merge; keep this tier for "
                "cross-host", local)
        await self._connect_all()
        self._reconnect_task = asyncio.create_task(self._reconnect_loop())
        host = host or self.context.listen_addr
        port = port if port is not None else self.context.listen_port
        self._server = await asyncio.start_server(self._on_client, host,
                                                  port)
        addr = self._server.sockets[0].getsockname()
        log.info("aggregator listening on %s:%d", addr[0], addr[1])
        if self.context.canary_interval_ms > 0:
            # canary on the corpus-less tier: probe query
            # lines from CanaryProbeFile, first answer pinned as the
            # stability reference; latency/availability feed the SLO
            # engine either way
            probes: List[canary_mod.CanaryProbe] = []
            if self.context.canary_probe_file:
                try:
                    probes = canary_mod.probes_from_file(
                        self.context.canary_probe_file,
                        k=self.context.canary_k)
                except OSError:
                    log.exception("canary probe file unreadable: %s",
                                  self.context.canary_probe_file)
            if probes:
                self._canary = canary_mod.CanaryProber(
                    addr[0], addr[1], probes,
                    interval_ms=self.context.canary_interval_ms,
                    tier="aggregator")
                self._canary.start()
        return addr[0], addr[1]

    async def stop(self) -> None:
        if self._canary is not None:
            canary_ref = self._canary
            self._canary = None
            await asyncio.get_event_loop().run_in_executor(
                None, canary_ref.stop)
        if self._controller is not None:
            timeline.remove_tick_listener(self._controller.evaluate)
            self._controller = None
        if self._slo is not None:
            timeline.remove_tick_listener(self._slo.evaluate)
            self._slo = None
        if self._metrics_http:
            self._metrics_http.shutdown()
            self._metrics_http = None
        if self._reconnect_task:
            self._reconnect_task.cancel()
        if self._server:
            self._server.close()
            for writer in list(self._client_writers.values()):
                writer.transport.abort()
            await self._server.wait_closed()
        for s in self.context.servers:
            s.drop()

    def _healthz(self) -> dict:
        """/healthz payload: per-backend connectivity; "ok" only with every
        configured backend connected (load balancers act on the code)."""
        servers = [{"address": s.address, "port": s.port,
                    "connected": s.connected}
                   for s in self.context.servers]
        n_up = sum(1 for s in servers if s["connected"])
        status = ("ok" if servers and n_up == len(servers)
                  else "degraded" if n_up else "down")
        return {"status": status, "connected": n_up,
                "configured": len(servers), "servers": servers}

    # ---------------------------------------------------------- connections

    async def _connect(self, server: RemoteServer) -> None:
        try:
            reader, writer = await asyncio.open_connection(
                server.address, server.port)
            # register handshake
            writer.write(wire.PacketHeader(
                wire.PacketType.RegisterRequest).pack())
            await writer.drain()
            head = await reader.readexactly(wire.HEADER_SIZE)
            wire.PacketHeader.unpack(head)
            server.reader = reader
            server.writer = writer
            server.reader_task = asyncio.create_task(
                self._read_responses(server))
            log.info("aggregator connected to %s:%d", server.address,
                     server.port)
        except OSError:
            server.reader = None
            server.writer = None

    async def _read_responses(self, server: RemoteServer) -> None:
        """Per-connection response pump: match replies to pending futures by
        resource_id (ResourceManager semantics); unmatched (late) replies are
        discarded harmlessly."""
        try:
            while True:
                head = await server.reader.readexactly(wire.HEADER_SIZE)
                header = wire.PacketHeader.unpack(head)
                if not 0 <= header.body_length <= wire.MAX_BODY_LENGTH:
                    # a garbled/hostile length must not make this pump
                    # buffer multi-GB — drop the connection (the backoff
                    # loop re-dials; in-flight requests fail fast)
                    metrics.inc("aggregator.malformed_backend_body")
                    log.warning("backend %s:%d sent body_length %d over "
                                "cap; dropping connection", server.address,
                                server.port, header.body_length)
                    server.drop()
                    return
                body = (await server.reader.readexactly(header.body_length)
                        if header.body_length else b"")
                fut = server.pending.pop(header.resource_id, None)
                if fut is not None and not fut.done():
                    fut.set_result((header, body))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError,
                asyncio.CancelledError):
            server.drop()

    async def _connect_all(self) -> None:
        await asyncio.gather(*(self._connect(s)
                               for s in self.context.servers
                               if not s.connected))

    async def _reconnect_loop(self) -> None:
        """Re-dial Disconnected servers with capped exponential backoff +
        jitter — replaces the reference's fixed 30 s
        sweep (AggregatorService.cpp:139-194).  A freshly dropped backend
        is retried within one tick (fast first retry); a dead address
        backs off to `ReconnectCapS` with ±50% jitter so a restarting
        fleet does not thundering-herd it."""
        base = max(self.context.reconnect_base_ms, 1.0) / 1000.0
        cap = max(self.context.reconnect_cap_s, base)
        now_fn = asyncio.get_event_loop().time
        while True:
            for s in self.context.servers:
                if s.connected or now_fn() < s.next_dial:
                    continue
                s.reconnect_attempts += 1
                metrics.inc("aggregator.reconnect_attempts")
                await self._connect(s)
                if s.connected:
                    metrics.inc("aggregator.reconnects")
                    s.backoff_s = 0.0
                else:
                    s.backoff_s = min(cap, (s.backoff_s * 2.0) or base)
                    s.next_dial = now_fn() + \
                        s.backoff_s * random.uniform(0.5, 1.5)
            down = [s for s in self.context.servers if not s.connected]
            if down:
                delay = min(max(s.next_dial - now_fn(), 0.0)
                            for s in down)
                delay = min(max(delay, 0.05), 1.0)
            else:
                # everything up: idle tick — a drop is noticed because
                # drop() leaves next_dial in the past (fast first retry)
                delay = 1.0
            await asyncio.sleep(delay)

    # -------------------------------------------------------------- serving

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        cid = self._next_client
        self._next_client += 1
        self._client_writers[cid] = writer
        try:
            while True:
                head = await reader.readexactly(wire.HEADER_SIZE)
                header = wire.PacketHeader.unpack(head)
                if not 0 <= header.body_length <= wire.MAX_BODY_LENGTH:
                    # the public listen socket is the MOST exposed framing
                    # reader: a hostile header must not buffer multi-GB
                    # before admission/decode ever run — drop the client
                    metrics.inc("aggregator.malformed_packets")
                    log.warning("client sent body_length %d over cap; "
                                "closing", header.body_length)
                    break
                body = (await reader.readexactly(header.body_length)
                        if header.body_length else b"")
                t = header.packet_type
                if t == wire.PacketType.RegisterRequest:
                    writer.write(wire.PacketHeader(
                        wire.PacketType.RegisterResponse,
                        wire.PacketProcessStatus.Ok, 0, 1,
                        header.resource_id).pack())
                    await writer.drain()
                elif t == wire.PacketType.HeartbeatRequest:
                    writer.write(wire.PacketHeader(
                        wire.PacketType.HeartbeatResponse,
                        wire.PacketProcessStatus.Ok, 0,
                        header.connection_id, header.resource_id).pack())
                    await writer.drain()
                elif t == wire.PacketType.SearchRequest:
                    metrics.inc("aggregator.requests")
                    rec = flightrec.enabled()
                    t0 = time.perf_counter()
                    degraded = False
                    if self._admission is not None:
                        # canary isolation: marked at first probe decode
                        # (below), exempt from fair shares thereafter
                        decision = self._admission.admit(
                            "conn-%d" % cid,
                            canary=cid in self._canary_conns)
                        if decision == admission_mod.SHED:
                            # shed BEFORE the body is decoded or any
                            # backend touched — a distinct status so
                            # callers back off instead of retrying
                            metrics.inc("aggregator.admission_sheds")
                            if rec:
                                flightrec.record("aggregator", "shed")
                            shed = wire.RemoteSearchResult(
                                wire.ResultStatus.Overloaded, []).pack()
                            writer.write(wire.PacketHeader(
                                wire.PacketType.SearchResponse,
                                wire.PacketProcessStatus.Dropped,
                                len(shed), header.connection_id,
                                header.resource_id).pack() + shed)
                            await writer.drain()
                            continue
                        degraded = decision == admission_mod.DEGRADE
                    hp = hostprof.armed()
                    if hp:
                        # serve-stage pin: decode + id/
                        # deadline stamping run whole between awaits
                        hostprof.set_stage("decode")
                    body, rid, deadline_mono = self._prepare_request(
                        body, degraded)
                    if hp:
                        hostprof.clear_stage()
                    if rid and canary_mod.is_canary_rid(rid):
                        self._canary_conns.add(cid)
                    if deadline_mono is not None and \
                            time.perf_counter() >= deadline_mono:
                        # budget already spent before any fan-out
                        metrics.inc("aggregator.deadline_drops")
                        if rec:
                            flightrec.record("aggregator",
                                             "deadline_drop", rid)
                        late = wire.RemoteSearchResult(
                            wire.ResultStatus.Timeout, [], rid).pack()
                        writer.write(wire.PacketHeader(
                            wire.PacketType.SearchResponse,
                            wire.PacketProcessStatus.Ok, len(late),
                            header.connection_id,
                            header.resource_id).pack() + late)
                        await writer.drain()
                        continue
                    self._inflight += 1
                    metrics.set_gauge("aggregator.inflight",
                                      self._inflight)
                    try:
                        with trace.span("aggregator.scatter_gather"):
                            result = await self._scatter_gather(
                                body, rid, deadline_mono)
                    finally:
                        self._inflight -= 1
                        metrics.set_gauge("aggregator.inflight",
                                          self._inflight)
                    # prefer the id echoed back by a shard (proof the trace
                    # traversed a backend); fall back to the edge-minted one
                    result.request_id = result.request_id or rid
                    if degraded and \
                            result.status == wire.ResultStatus.Success:
                        if wire.MARKER_DEGRADED not in result.markers:
                            result.markers.append(wire.MARKER_DEGRADED)
                        metrics.inc("aggregator.degraded_responses")
                    if hp:
                        # per-request encode on the loop thread — the
                        # rid pin is exact here (no awaits inside)
                        hostprof.set_stage("encode", rid)
                    rbody = result.pack()
                    if hp:
                        hostprof.clear_stage()
                    t_send0 = time.perf_counter() if rec else 0.0
                    writer.write(wire.PacketHeader(
                        wire.PacketType.SearchResponse,
                        wire.PacketProcessStatus.Ok, len(rbody),
                        header.connection_id, header.resource_id).pack()
                        + rbody)
                    await writer.drain()
                    total = time.perf_counter() - t0
                    trace.record("aggregator.request", total)
                    if rec:
                        flightrec.record(
                            "aggregator", "send", rid,
                            dur_ns=int((time.perf_counter() - t_send0)
                                       * 1e9))
                        flightrec.record(
                            "aggregator", "request", rid,
                            dur_ns=int(total * 1e9),
                            payload={"status": int(result.status)})
                    thresh = self.context.slow_query_threshold_ms
                    slow = thresh > 0 and total * 1000.0 >= thresh
                    if rec and self.context.flight_dump_on_slow_query \
                            and (slow or result.status
                                 != wire.ResultStatus.Success):
                        asyncio.get_event_loop().run_in_executor(
                            None, flightrec.dump_to_file,
                            "slow" if slow else "error", rid)
                    if slow:
                        try:
                            # the status byte is backend-supplied and may
                            # be outside the enum ("hostile peers send
                            # anything") — the log line must not raise
                            status_name = wire.ResultStatus(
                                result.status).name
                        except ValueError:
                            status_name = str(result.status)
                        cepoch = ("" if self._controller is None
                                  else " cepoch=%d"
                                  % self._controller.epoch)
                        token = metrics.set_request_id(rid)
                        try:
                            log.warning(
                                "slow query rid=%s total=%.2fms status=%s "
                                "results=%d%s", rid or "-", total * 1000.0,
                                status_name,
                                sum(len(r.ids) for r in result.results),
                                cepoch)
                        finally:
                            metrics.reset_request_id(token)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._canary_conns.discard(cid)
            self._client_writers.pop(cid, None)
            writer.close()

    def _prepare_request(self, body: bytes, degraded: bool = False
                         ) -> Tuple[bytes, str, Optional[float]]:
        """The edge-preparation step: request-id minting (PR-2 contract:
        a body already carrying a wire or text id rides untouched; an
        id-less one gets minted+repacked unless TraceRequests opted out),
        deadline resolution (wire trailer > $deadlinems text option >
        the [Service] DeadlineMs default; the REMAINING budget is stamped
        into the forwarded body so shards drop work the client gave up
        on) and the degrade clamp (a degraded query's $maxcheck is
        clamped down to DegradeMaxCheckFloor in the TEXT — the layout
        version is untouched, so this works for reference-exact
        backends too).  Returns (body, rid, deadline_mono).  A body that
        does not decode rides through unchanged — malformed payloads
        stay one backend's problem, as before."""
        query = wire.RemoteQuery.unpack(body)
        if query is None:
            return body, "", None
        modified = False
        # attacker-sized wire field: bound it before it reaches logs
        # (each shard re-caps its own copy at its edge)
        rid = query.request_id[:64]
        if not rid:
            rid = protocol.request_id_of(query.query) or ""
            if not rid and self.context.trace_requests:
                query.request_id = wire.new_request_id()
                rid = query.request_id
                modified = True
        dl = query.deadline_ms or (protocol.deadline_of(query.query)
                                   or 0.0)
        if dl <= 0:
            dl = self.context.deadline_ms
        deadline_mono = None
        if dl > 0:
            deadline_mono = time.perf_counter() + dl / 1000.0
            if query.deadline_ms > 0 or self.context.trace_requests:
                # propagate as a wire trailer (the body was already
                # extended, or the operator allows extending it);
                # text-channel deadlines otherwise ride through as text
                query.deadline_ms = dl
                modified = True
        if degraded:
            floor = self.context.degrade_max_check_floor
            mc = protocol.parse_query(query.query).max_check
            if mc is None or mc > floor:
                # the last $maxcheck token wins at the shard's parser,
                # so appending clamps without disturbing anything else
                query.query += " $maxcheck:%d" % floor
                modified = True
        return (query.pack() if modified else body), rid, deadline_mono

    async def _scatter_gather(self, body: bytes, rid: str = "",
                              deadline_mono: Optional[float] = None
                              ) -> wire.RemoteSearchResult:
        """Fan out to every Connected server; flat-merge the per-index
        lists; degrade status on timeout/network failure
        (AggregatorService.cpp:206-366).  `rid` tags the per-shard
        fan-out and merge flight events.  `deadline_mono` bounds the
        per-shard wait to the client's remaining budget."""
        targets = [(i, s) for i, s in enumerate(self.context.servers)
                   if s.connected]
        metrics.set_gauge("aggregator.connected_backends", len(targets))
        if not targets:
            metrics.inc("aggregator.no_backend")
            return wire.RemoteSearchResult(wire.ResultStatus.FailedNetwork,
                                           [])
        timeout_s = self.context.search_timeout_s
        if deadline_mono is not None:
            timeout_s = max(min(timeout_s,
                                deadline_mono - time.perf_counter()),
                            0.001)
        tasks = [self._query_one(i, s, body, rid, timeout_s)
                 for i, s in targets]
        replies = await asyncio.gather(*tasks)
        rec = flightrec.enabled()
        t_merge0 = time.monotonic_ns() if rec else 0
        hp = hostprof.armed()
        if hp:
            # the merge runs whole between awaits and serves exactly one
            # request — the aggregator's execute-stage analog, rid exact
            hostprof.set_stage("merge", rid)
        merged = wire.RemoteSearchResult(wire.ResultStatus.Success, [])
        for status, results, shard_rid, shard_markers in replies:
            if status != wire.ResultStatus.Success:
                merged.status = status
            merged.results.extend(results)
            # a shard's echo proves the id made the full hop; keep the
            # first one so the client's response id traveled end to end
            merged.request_id = merged.request_id or shard_rid
            # shard-stamped markers survive the merge: if ANY shard's
            # admission control degraded its slice, the merged answer
            # traded recall for survival and the client must know
            for m in shard_markers:
                if m not in merged.markers and \
                        len(merged.markers) < wire.MAX_MARKERS:
                    merged.markers.append(m)
        if self.context.merge_top_k:
            # declared-topology mode keys off the CONFIGURED servers, not
            # the connected subset: if any server declares a ReplicaGroup
            # the operator chose group-restricted collapse, and a group
            # member being temporarily disconnected must not revert the
            # merge to legacy collapse-anything semantics.  Labels are
            # aligned with reply order (= targets order).
            declared = any(s.replica_group is not None
                           for s in self.context.servers)
            merged.results = merge_top_k(
                [r for _, r, _, _ in replies],
                rel_tol=self.context.merge_rel_tol,
                replica_groups=([s.replica_group for _, s in targets]
                                if declared else None))
        if hp:
            hostprof.clear_stage()
        if rec:
            flightrec.record("aggregator", "merge", rid,
                             dur_ns=time.monotonic_ns() - t_merge0,
                             payload={"backends": len(targets)})
        # merge-quality sampling: with MergeTopK on, compare
        # the merged top-k against the ideal top-k over the union of
        # shard replies on the quality monitor's background worker —
        # one flag test here when the monitor is off, and the captured
        # lists are never mutated after this point (read-only capture)
        if qualmon.enabled() and self.context.merge_top_k \
                and merged.status == wire.ResultStatus.Success \
                and qualmon.maybe_sample():
            qualmon.submit(functools.partial(
                _merge_quality_check, rid,
                [r for _, r, _, _ in replies], merged.results,
                self.context.merge_rel_tol))
        return merged

    async def _issue(self, server: RemoteServer, body: bytes):
        """Register + send one request on a backend connection; returns
        (future, resource id) or None when the backend is gone.  The
        future resolves to (header, body) via the response pump."""
        rid = server.next_rid
        server.next_rid += 1
        header = wire.PacketHeader(wire.PacketType.SearchRequest,
                                   wire.PacketProcessStatus.Ok, len(body),
                                   0, rid)
        fut = asyncio.get_event_loop().create_future()
        server.pending[rid] = fut
        try:
            async with server.wlock:
                if server.writer is None:
                    # a concurrent drop() (backend reset) beat us to the
                    # lock; writer is gone and our future already failed
                    server.pending.pop(rid, None)
                    self._discard(fut)
                    return None
                server.writer.write(header.pack() + body)
                await server.writer.drain()
        except OSError:
            server.pending.pop(rid, None)
            self._discard(fut)
            server.drop()
            return None
        return fut, rid

    @staticmethod
    def _discard(fut) -> None:
        """Retrieve a dead attempt's exception so the loop never logs
        'Future exception was never retrieved' — a concurrent drop()
        may have failed the future we are abandoning."""
        if fut.done() and not fut.cancelled():
            fut.exception()

    def _hedge_delay(self, timeout_s: float) -> Optional[float]:
        """Seconds to wait on a backend before issuing the hedged
        duplicate: the fleet latency histogram's HedgePercentile once
        enough samples exist (a reply slower than that percentile is, by
        definition, in the tail worth hedging), a quarter of the request
        timeout while cold; floored at HedgeMinMs.  None = hedging off
        (HedgeBudget 0, the default)."""
        if self.context.hedge_budget <= 0:
            return None
        floor = max(self.context.hedge_min_ms, 0.0) / 1000.0
        h = metrics.histogram_or_none("aggregator.backend_s")
        if h is not None and h.count >= 16:
            return max(h.percentile(self.context.hedge_percentile), floor)
        return max(timeout_s / 4.0, floor)

    def _hedge_allow(self) -> bool:
        """Budget cap: hedges may not exceed HedgeBudget as a fraction
        of fan-out requests (floored at one so a cold start can hedge
        at all); past the cap the hedge is denied and counted."""
        cap = max(1.0, self.context.hedge_budget * self._fanouts)
        if self._hedges_issued < cap:
            self._hedges_issued += 1
            return True
        metrics.inc("aggregator.hedge_budget_denied")
        return False

    def _hedge_target(self, server: RemoteServer
                      ) -> Optional[RemoteServer]:
        """Where the duplicate goes: a connected replica (same declared
        ReplicaGroup) holds the same data and is the ideal target;
        without groups every other backend is a DIFFERENT corpus slice,
        so the only correct duplicate is a fresh request to the same
        backend (which beats per-request flukes: a lost packet, one bad
        queue draw — not a genuinely slow server)."""
        if server.replica_group is not None:
            for s in self.context.servers:
                if s is not server and s.connected \
                        and s.replica_group == server.replica_group:
                    return s
        return server if server.connected else None

    async def _query_one(self, idx: int, server: RemoteServer, body: bytes,
                         req_id: str = "",
                         timeout_s: Optional[float] = None):
        timeout_s = (timeout_s if timeout_s is not None
                     else self.context.search_timeout_s)
        rec = flightrec.enabled()
        t_fan0 = time.monotonic_ns() if rec else 0
        t0 = time.perf_counter()

        def fanout_event(status: int) -> None:
            # every exit of this fan-out — success, backend-gone,
            # timeout, socket error — records its span: the
            # error-triggered auto-dump must contain the span of exactly
            # the backend that broke, not every OTHER one
            if rec:
                flightrec.record(
                    "aggregator", "fanout", req_id,
                    dur_ns=time.monotonic_ns() - t_fan0,
                    payload={"backend": "%s:%d" % (server.address,
                                                   server.port),
                             "status": int(status)})

        self._fanouts += 1
        issued = await self._issue(server, body)
        if issued is None:
            metrics.inc("aggregator.backend_failures")
            fanout_event(wire.ResultStatus.FailedNetwork)
            return wire.ResultStatus.FailedNetwork, [], "", []
        # attempts: (server, future, resource id) — the primary plus at
        # most one hedged duplicate.  First healthy completion wins; the
        # loser is DEREGISTERED (its late reply is read and discarded by
        # resource id, the protocol's cancellation).
        attempts = [(server, issued[0], issued[1])]
        hedge_delay = self._hedge_delay(timeout_s)
        end = t0 + timeout_s
        hedged = False
        winner = None
        try:
            while winner is None:
                for _s, f, _r in attempts:
                    if f.done() and not f.cancelled() \
                            and f.exception() is None:
                        winner = f
                        break
                if winner is not None:
                    break
                live = [f for _s, f, _r in attempts if not f.done()]
                if not live:
                    raise OSError("all attempts failed")
                now = time.perf_counter()
                if now >= end:
                    raise asyncio.TimeoutError
                wait_s = end - now
                if not hedged and hedge_delay is not None:
                    fire_at = t0 + hedge_delay
                    if now >= fire_at:
                        hedged = True
                        target = self._hedge_target(server)
                        if target is not None and self._hedge_allow():
                            dup = await self._issue(target, body)
                            if dup is None:
                                # nothing was sent (replica dropped /
                                # write failed): refund the budget so a
                                # flaky-replica episode cannot lock
                                # hedging out, and keep the counters
                                # equal to hedges actually in flight
                                self._hedges_issued -= 1
                            else:
                                metrics.inc("aggregator.hedges")
                                if rec:
                                    flightrec.record(
                                        "aggregator", "hedge", req_id,
                                        payload={"backend": "%s:%d" % (
                                            target.address, target.port)})
                                attempts.append((target, dup[0], dup[1]))
                        continue
                    wait_s = min(wait_s, fire_at - now)
                await asyncio.wait(live, timeout=wait_s,
                                   return_when=asyncio.FIRST_COMPLETED)
        except asyncio.TimeoutError:
            # connections stay up and aligned — the reader tasks drop
            # the late replies when they arrive (no resource_id match)
            for s, f, r in attempts:
                s.pending.pop(r, None)
                self._discard(f)
            metrics.inc("aggregator.backend_timeouts")
            fanout_event(wire.ResultStatus.Timeout)
            return wire.ResultStatus.Timeout, [], "", []
        except OSError:
            for s, f, r in attempts:
                s.pending.pop(r, None)
                self._discard(f)
            metrics.inc("aggregator.backend_failures")
            fanout_event(wire.ResultStatus.FailedNetwork)
            return wire.ResultStatus.FailedNetwork, [], "", []
        # first-wins: deregister the loser (cancellation in this
        # protocol = the late reply dies unmatched at the pump)
        for s, f, r in attempts:
            if f is not winner:
                s.pending.pop(r, None)
                self._discard(f)
                metrics.inc("aggregator.hedge_cancels")
        if len(attempts) > 1 and winner is attempts[1][1]:
            metrics.inc("aggregator.hedge_wins")
        elapsed = time.perf_counter() - t0
        metrics.observe("aggregator.backend_s", elapsed)
        # instance histogram (config-bounded cardinality): feeds the
        # hedge trigger's fleet view and /debug/admission
        for s, f, _r in attempts:
            if f is winner:
                s.latency.observe(elapsed)
        _, rbody = await winner        # done: resolves without suspending
        try:
            result = wire.RemoteSearchResult.unpack(rbody)
        except Exception:                            # noqa: BLE001
            # a malformed backend body must cost one request, not the
            # client's whole connection task — but stay observable:
            # 100%-FailedNetwork from wire corruption must look
            # different from connectivity loss in the logs
            log.warning("malformed SearchResponse body from %s:%d",
                        server.address, server.port)
            result = None
        if result is None:
            metrics.inc("aggregator.malformed_backend_body")
            fanout_event(wire.ResultStatus.FailedNetwork)
            return wire.ResultStatus.FailedNetwork, [], "", []
        fanout_event(result.status)
        return result.status, result.results, result.request_id, result.markers


def main(argv=None) -> int:
    """`python -m sptag_tpu_torch.serve.aggregator -c aggregator.ini`;
    SIGTERM or SIGINT stops it and the process exits 0."""
    import argparse

    parser = argparse.ArgumentParser(
        description="sptag_tpu_torch aggregator")
    parser.add_argument("-c", "--config", required=True)
    args = parser.parse_args(argv)
    context = AggregatorContext.from_ini(args.config)

    async def serve():
        from sptag_tpu_torch.serve.server import _until_terminated

        service = AggregatorService(context)
        await service.start()
        await _until_terminated()
        await service.stop()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
