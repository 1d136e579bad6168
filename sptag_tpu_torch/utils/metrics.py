"""Metrics registry — counters, gauges, log-bucketed latency histograms.

The reference has no telemetry at all (SURVEY §5: per-query `clock()` math
in IndexSearcher is the whole story), and the ROADMAP north star — serving
heavy traffic as fast as the hardware allows — is unreachable without
knowing where time goes: TPU-KNN (arXiv:2206.14286) frames ANN performance
as a measurable fraction of peak FLOP/s, which presumes per-stage
accounting.  This module is the process-wide registry everything feeds:

* `Counter` / `Gauge` — named monotonic / last-value metrics;
* `Histogram` — HDR-style log-bucketed latency distribution: bucket upper
  bounds grow by a factor of ~1.3 from 1 µs, so any quantile estimate is
  within 30% of the true value while `observe()` stays one bisect + one
  locked array increment (cheap enough for per-request paths);
* counter sources (`register_source`) — counts kept elsewhere, such as
  an accumulator on the card that kernels add into, folded into their
  counter when the registry is read, so counting costs the hot path no
  device sync;
* `render_prometheus()` — the text exposition format served by
  `serve/metrics_http.py`;
* request-id context: a `contextvars.ContextVar` + `RequestIdLogFilter`
  so every log record a request touches carries its id (the filter sets
  `record.request_id`; include `%(request_id)s` in the handler format).

`utils/trace.py` feeds every span/record into a histogram here, so
`trace.report()` derives p50/p90/p99 and the Prometheus endpoint exports
span latencies with no extra wiring.  Metric NAMES must be string
literals at call sites (graftlint GL6xx) so cardinality stays bounded —
the registry never expires a series.

Thread-safety: creation races resolve under the registry lock; each
instrument serializes its own updates on a per-instance lock (pinned by
tests/test_metrics.py hammering from a thread pool).
"""

from __future__ import annotations

import bisect
import collections
import contextvars
import logging
import re
import itertools
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

log = logging.getLogger(__name__)

#: histogram bucket growth factor — ~1.3 per bucket bounds any quantile
#: estimate to within one bucket (≤ 30% relative error) at ~85 buckets
#: spanning 1 µs .. 1 h
BUCKET_GROWTH = 1.3
_BUCKET_FLOOR_S = 1e-6
_BUCKET_CEIL_S = 3600.0


def _make_bounds() -> Tuple[float, ...]:
    out = [_BUCKET_FLOOR_S]
    while out[-1] < _BUCKET_CEIL_S:
        out.append(out[-1] * BUCKET_GROWTH)
    return tuple(out)


#: bucket UPPER bounds; values above the last bound land in an overflow
#: bucket whose quantile estimate is the observed max
BUCKET_BOUNDS: Tuple[float, ...] = _make_bounds()


class Counter:
    """Monotonic named counter."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-value named gauge."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed latency histogram (seconds).

    `observe` is one bisect over the shared bounds plus a locked bucket
    increment; `percentile(p)` walks the cumulative counts and returns
    the crossing bucket's upper bound (an overestimate by at most one
    bucket = factor BUCKET_GROWTH), except the overflow bucket which
    reports the exact observed max."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)   # +1 = overflow
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(BUCKET_BOUNDS, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (0 < p <= 100); 0.0 when empty."""
        counts, mx = self.counts()
        return _percentile(counts, p, mx)

    def counts(self) -> Tuple[List[int], float]:
        """(per-bucket counts, overflow last; the observed max)."""
        with self._lock:
            return list(self._counts), self._max

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """(upper_bound, CUMULATIVE count) for every non-empty bucket plus
        the +inf overflow — the Prometheus exposition shape."""
        with self._lock:
            counts = list(self._counts)
        out: List[Tuple[float, int]] = []
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if c:
                bound = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                         else float("inf"))
                out.append((bound, cum))
        if not out or out[-1][0] != float("inf"):
            out.append((float("inf"), cum))
        return out


def _percentile(counts: List[int], p: float, mx: float) -> float:
    """The crossing bucket's upper bound (the observed max past the last
    bound) of per-bucket `counts`; 0.0 when they are empty."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = max(1, int(-(-p * total // 100)))            # ceil(p% of total)
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return mx if i >= len(BUCKET_BOUNDS) \
                else min(BUCKET_BOUNDS[i], mx)
    return mx


class WindowedPercentile:
    """Percentiles of one registry histogram over a trailing window of
    about `window_s` seconds: the difference between its bucket counts now
    and at a mark at least `window_s` old (at most `window_s` / MARKS
    older), counting only what was recorded after this object was made.
    The admission signals read it: a shed request records no latency, so a
    lifetime percentile past its threshold would shed every request until
    the process restarts, while this one forgets a slow spell within the
    window.  Marks are taken when it is read, at most MARKS a window, so
    its memory is bounded; a histogram made or reset after the last mark
    counts whole."""

    MARKS = 8

    def __init__(self, name: str, window_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.window_s = float(window_s)
        self.clock = clock
        self._lock = threading.Lock()
        # (t, histogram instance, per-bucket counts)
        self._marks: collections.deque = collections.deque()
        h = histogram_or_none(name)
        if h is not None:
            self._marks.append((clock(), h, h.counts()[0]))

    def percentile(self, p: float) -> float:
        h = histogram_or_none(self.name)
        if h is None:
            return 0.0
        now = self.clock()
        counts, mx = h.counts()
        with self._lock:
            marks = self._marks
            if not marks or marks[-1][1] is not h:
                marks.clear()
                marks.append((now, h, [0] * len(counts)))
            elif now - marks[-1][0] >= self.window_s / self.MARKS:
                marks.append((now, h, counts))
            while len(marks) > 1 and marks[1][0] <= now - self.window_s:
                marks.popleft()
            base = marks[0][2]
        return _percentile([c - b for c, b in zip(counts, base)], p, mx)


# ---------------------------------------------------------------------------
# process-wide registry
# ---------------------------------------------------------------------------

_reg_lock = threading.Lock()
_counters: Dict[str, Counter] = {}
_gauges: Dict[str, Gauge] = {}
_histograms: Dict[str, Histogram] = {}


class MetricKindError(TypeError):
    """One name, two instrument kinds.  Before this check, registering
    `x` as both a counter and a gauge silently minted two instruments
    sharing one name — the timeline then derived `x` AND `x.rate` from
    different series and /metrics exposed the name twice (GL10xx
    contract, DESIGN.md §24)."""


def _check_kind(name: str, kind: str) -> None:
    # caller holds _reg_lock
    for other_kind, reg in (("counter", _counters), ("gauge", _gauges),
                            ("histogram", _histograms)):
        if other_kind != kind and name in reg:
            raise MetricKindError(
                f"metric {name!r} is already registered as a "
                f"{other_kind}; cannot re-register it as a {kind}")


def counter(name: str) -> Counter:
    with _reg_lock:
        c = _counters.get(name)
        if c is None:
            _check_kind(name, "counter")
            c = _counters[name] = Counter(name)
        return c


def gauge(name: str) -> Gauge:
    with _reg_lock:
        g = _gauges.get(name)
        if g is None:
            _check_kind(name, "gauge")
            g = _gauges[name] = Gauge(name)
        return g


def histogram(name: str) -> Histogram:
    with _reg_lock:
        h = _histograms.get(name)
        if h is None:
            _check_kind(name, "histogram")
            h = _histograms[name] = Histogram(name)
        return h


def histogram_or_none(name: str) -> Optional[Histogram]:
    """Read-only lookup — never mints an empty series (trace.report uses
    this so reporting cannot grow the registry)."""
    with _reg_lock:
        return _histograms.get(name)


# convenience forms: get-or-create each call, so reset() never leaves a
# caller holding a detached instrument
def inc(name: str, n: int = 1) -> None:
    counter(name).inc(n)


def set_gauge(name: str, value: float) -> None:
    gauge(name).set(value)


def observe(name: str, value: float) -> None:
    histogram(name).observe(value)


# counter sources: id -> [counter name, read(), total already folded]
_src_lock = threading.Lock()
_sources: Dict[int, list] = {}
_retired: List[list] = []
_source_ids = itertools.count()


def register_source(name: str, owner, read: Callable[[], int]) -> None:
    """Fold the running total `read()` returns into the counter `name`:
    its growth since the last fold, whenever the registry is read
    (`counter_value` of `name`, `snapshot`, `render_prometheus`).  When
    `owner` is collected the source is folded once more at the next read,
    or the next registration, and dropped; `read` must not hold `owner`
    (it may hold a device tensor, which then lives until that fold)."""
    _fold_sources(live=False)
    key = next(_source_ids)
    with _src_lock:
        _sources[key] = [name, read, 0]
    weakref.finalize(owner, _retire_source, key).atexit = False


def _retire_source(key: int) -> None:
    # a finalizer: no device work here (it may run inside a capture)
    with _src_lock:
        entry = _sources.pop(key, None)
        if entry is not None:
            _retired.append(entry)


def _fold_sources(name: Optional[str] = None, live: bool = True) -> None:
    """Fold the sources of counter `name` (all when None); with `live`
    False only those whose owner was collected."""
    with _src_lock:
        current = [e for e in _sources.values()
                   if live and name in (None, e[0])]
        done = [e for e in _retired if name in (None, e[0])]
        _retired[:] = [e for e in _retired if name not in (None, e[0])]
    for entry in current + done:
        total = int(entry[1]())
        with _src_lock:            # totals only grow; a later read wins
            delta = max(total - entry[2], 0)
            entry[2] = max(total, entry[2])
        if delta:
            inc(entry[0], delta)


def counter_value(name: str) -> int:
    _fold_sources(name)
    with _reg_lock:
        c = _counters.get(name)
    return c.value if c is not None else 0


def gauge_value(name: str) -> float:
    """Read-only gauge lookup — never mints an empty series (the
    admission controller's signal reads must not grow the registry)."""
    with _reg_lock:
        g = _gauges.get(name)
    return g.value if g is not None else 0.0


def reset() -> None:
    """Drop every registered series (test isolation; see
    tests/conftest.py)."""
    with _reg_lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()


def snapshot() -> Dict[str, Dict]:
    """Plain-data view of the whole registry."""
    _fold_sources()
    with _reg_lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        histograms = dict(_histograms)
    return {
        "counters": {n: c.value for n, c in counters.items()},
        "gauges": {n: g.value for n, g in gauges.items()},
        "histograms": {
            n: {"count": h.count, "sum": round(h.sum, 6),
                "max": round(h.max, 6),
                "p50": round(h.percentile(50), 6),
                "p90": round(h.percentile(90), 6),
                "p99": round(h.percentile(99), 6)}
            for n, h in histograms.items()},
    }


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, name: str) -> str:
    return f"{prefix}_{_NAME_RE.sub('_', name)}"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(round(v, 9))


def render_prometheus(prefix: str = "sptag_tpu") -> str:
    """Registry in Prometheus text format 0.0.4.  Histograms export the
    standard cumulative `_bucket{le=...}` / `_sum` / `_count` triple with
    a `_seconds` unit suffix (every histogram here is a latency)."""
    _fold_sources()
    with _reg_lock:
        counters = sorted(_counters.items())
        gauges = sorted(_gauges.items())
        histograms = sorted(_histograms.items())
    lines: List[str] = []
    for name, c in counters:
        m = _metric_name(prefix, name) + "_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {c.value}")
    for name, g in gauges:
        m = _metric_name(prefix, name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(g.value)}")
    for name, h in histograms:
        m = _metric_name(prefix, name) + "_seconds"
        lines.append(f"# TYPE {m} histogram")
        for bound, cum in h.bucket_counts():
            lines.append(f'{m}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f"{m}_sum {_fmt(h.sum)}")
        lines.append(f"{m}_count {h.count}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# labeled series: THE one exposition helper + provider registry
# ---------------------------------------------------------------------------
#
# The shared registry above deliberately has no label support (GL6xx
# keeps its cardinality bounded by literal names).  Subsystems whose
# series ARE labeled — the device-memory ledger's per-component bytes,
# the quality windows' (mode, shard) gauges, the lock-contention
# ledger's per-lock counters, the flight/hostprof health blocks — used
# to each carry a private copy of the Prometheus text-formatting rules
# (one TYPE line per name or the parser rejects the whole scrape, label
# escaping, counter `_total` suffixes).  `Family` + `render_families`
# is that logic exactly once, and `register_family_provider` is the
# discovery surface: serve/metrics_http.py renders every registered
# provider into /metrics, and utils/timeline.py samples the SAME
# provider output into its time-series rings — one unified surface, two
# consumers.


class Family:
    """One labeled metric family: a metric name, its TYPE, optional
    HELP, and `samples` = [(labels_dict_or_None, value), ...].  A None
    (or empty) labels dict renders the unlabeled aggregate sample.
    `prefix=None` uses the renderer's default; the contention ledger
    passes `prefix=""` to keep its historical bare `lock_*` names."""

    __slots__ = ("name", "kind", "help", "samples", "prefix")

    def __init__(self, name: str, kind: str = "gauge",
                 help: str = "",                          # noqa: A002
                 samples: Optional[List[Tuple[Optional[Dict[str, str]],
                                              float]]] = None,
                 prefix: Optional[str] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.samples = samples if samples is not None else []
        self.prefix = prefix

    def add(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> "Family":
        self.samples.append((labels, value))
        return self


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(labels: Optional[Dict[str, str]]) -> str:
    """`{k="v",...}` in insertion order with Prometheus escaping; the
    empty string for the unlabeled sample."""
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (k, _escape_label(v))
                     for k, v in labels.items())
    return "{%s}" % inner


def render_families(families: List[Family], prefix: str = "sptag_tpu"
                    ) -> str:
    """Prometheus text exposition for labeled families: ONE TYPE line
    per metric name with every label set under it (a second TYPE line
    for the same name is an invalid exposition and Prometheus rejects
    the WHOLE scrape), HELP when provided, counters suffixed `_total`.
    `prefix=""` renders bare names (the lock-contention ledger's
    historical shape).  Empty families render nothing, so an idle
    subsystem leaves the exposition byte-identical.

    Same-name families MERGE into one group before rendering: multi-
    instance providers (two SLO engines — one per tier — in one
    process, several canary probers) each return their own Family for
    the same metric, and emitting a TYPE line per instance would be
    exactly the invalid exposition this helper exists to prevent."""
    merged: List[Family] = []
    by_key: Dict[tuple, Family] = {}
    for fam in families:
        if not fam.samples:
            continue
        key = (fam.name, fam.kind, fam.prefix)
        prior = by_key.get(key)
        if prior is None:
            prior = Family(fam.name, fam.kind, fam.help, prefix=fam.prefix)
            by_key[key] = prior
            merged.append(prior)
        prior.help = prior.help or fam.help
        prior.samples.extend(fam.samples)
    lines: List[str] = []
    for fam in merged:
        p = fam.prefix if fam.prefix is not None else prefix
        m = _metric_name(p, fam.name) if p else _NAME_RE.sub("_", fam.name)
        if fam.kind == "counter":
            m += "_total"
        if fam.help:
            lines.append(f"# HELP {m} {fam.help}")
        lines.append(f"# TYPE {m} {fam.kind}")
        for labels, value in fam.samples:
            lines.append(f"{m}{format_labels(labels)} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


#: key -> zero-arg callable returning List[Family].  Structural (which
#: subsystems exist), not statistical — reset() leaves it alone; each
#: provider renders empty when its subsystem has nothing.
_family_providers: Dict[str, Callable[[], List[Family]]] = {}


def register_family_provider(key: str,
                             fn: Callable[[], List[Family]]) -> None:
    """Idempotent by key (module re-import replaces, never duplicates)."""
    with _reg_lock:
        _family_providers[key] = fn


def collect_families() -> List[Family]:
    """Every registered provider's families, provider-key order.  A
    broken provider is skipped (logged) — one subsystem must never
    break the scrape or the timeline sampler."""
    with _reg_lock:
        providers = sorted(_family_providers.items())
    out: List[Family] = []
    for key, fn in providers:
        try:
            out.extend(fn() or [])
        except Exception:                                # noqa: BLE001
            log.exception("family provider %s failed", key)
    return out


def render_provider_families(prefix: str = "sptag_tpu") -> str:
    """The /metrics tail: every provider family rendered through the
    one formatter (per-family prefix overrides honored)."""
    return render_families(collect_families(), prefix)


# ---------------------------------------------------------------------------
# request-id context + logging filter
# ---------------------------------------------------------------------------

_request_id: contextvars.ContextVar = contextvars.ContextVar(
    "sptag_tpu_request_id", default="")


def set_request_id(rid: str):
    """Bind the current context's request id; returns the token for
    `reset_request_id` (use try/finally around the request's work)."""
    return _request_id.set(rid or "")


def reset_request_id(token) -> None:
    _request_id.reset(token)


def get_request_id() -> str:
    return _request_id.get()


class RequestIdLogFilter(logging.Filter):
    """Stamps `record.request_id` from the context var ("-" outside any
    request) so a handler format with `%(request_id)s` traces one slow
    query across aggregator → shard logs."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = _request_id.get() or "-"
        return True


_factory_installed = False


def install_request_id_logging() -> None:
    """Stamp `record.request_id` on EVERY log record via the log-record
    factory (idempotent).  The factory — unlike a handler filter — also
    covers handlers added after installation (a late
    `logging.basicConfig`) and records from any logger in the tree."""
    global _factory_installed
    with _reg_lock:
        if _factory_installed:
            return
        _factory_installed = True
    old_factory = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = old_factory(*args, **kwargs)
        rid = _request_id.get()
        # a factory installed before this one (another package's
        # request-id stamp in the same process) may have set the field:
        # keep its id unless this package has one of its own
        if rid or getattr(record, "request_id", "-") == "-":
            record.request_id = rid or "-"
        return record

    logging.setLogRecordFactory(factory)
