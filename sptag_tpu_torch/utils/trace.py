"""Tracing / profiling (port of ``sptag_tpu/utils/trace.py``).

Two cooperating layers:

* host spans — `span("name")` context managers record wall time into a
  process-wide registry; `report()` aggregates count/total/mean/max per
  name plus p50/p90/p99 from the log-bucketed histogram every `record()`
  also feeds (utils/metrics.py, so the Prometheus text exports span
  latencies with no extra wiring).  Cheap enough for production paths: a
  perf_counter pair, a dict update and a histogram bucket increment.
* device tracing — while `start_trace(logdir)` has a
  ``torch.profiler.profile`` running, the same `span` also opens a
  ``torch.profiler.record_function`` range, so host spans line up with
  the card's kernels in the trace; `stop_trace()` ends the profile and
  writes a Chrome trace (``trace.json``, Perfetto / chrome://tracing)
  into `logdir`.

Used by the server batch path and the graph build.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

from sptag_tpu_torch.utils import metrics

_lock = threading.Lock()
_spans: Dict[str, list] = {}      # name -> [count, total_s, max_s]
_profile = None                   # the live torch.profiler.profile
_logdir: Optional[str] = None


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Record one host span; mark the device trace when one is live."""
    ann = None
    if _profile is not None:
        import torch.profiler
        ann = torch.profiler.record_function(name)
        ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        record(name, dt)


def record(name: str, seconds: float) -> None:
    """Record one externally measured duration into the span registry:
    the entry point for instrumentation that observes durations instead
    of wrapping code (the server's queue wait and request totals)."""
    with _lock:
        rec = _spans.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += seconds
        rec[2] = max(rec[2], seconds)
    metrics.observe(name, seconds)


def report() -> Dict[str, Dict[str, float]]:
    """Snapshot of all spans: {name: {count, total_s, mean_s, max_s,
    p50_s, p90_s, p99_s}}; the percentiles come from the log-bucketed
    metrics histogram each record() feeds (upper-bound estimates, within
    one ~1.3x bucket of the true quantile)."""
    with _lock:
        spans = {name: tuple(rec) for name, rec in _spans.items()}
    out: Dict[str, Dict[str, float]] = {}
    for name, (c, t, mx) in spans.items():
        entry = {"count": c, "total_s": round(t, 6),
                 "mean_s": round(t / c, 6) if c else 0.0,
                 "max_s": round(mx, 6)}
        h = metrics.histogram_or_none(name)
        if h is not None and h.count:
            entry.update({"p50_s": round(h.percentile(50), 6),
                          "p90_s": round(h.percentile(90), 6),
                          "p99_s": round(h.percentile(99), 6)})
        out[name] = entry
    return out


def reset() -> None:
    """Clear the span registry (metrics.reset() clears the paired
    histograms)."""
    with _lock:
        _spans.clear()


def start_trace(logdir: str) -> None:
    """Begin a ``torch.profiler`` trace of the host and, when CUDA is
    available, the card; `span`s become named ranges in it."""
    global _profile, _logdir
    import torch
    import torch.profiler

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    os.makedirs(logdir, exist_ok=True)
    _logdir = logdir
    _profile = prof


def stop_trace() -> Optional[str]:
    """End the trace and write it as ``<logdir>/trace.json``; returns the
    path, or None when no trace was running."""
    global _profile, _logdir
    prof, logdir = _profile, _logdir
    _profile = _logdir = None
    if prof is None:
        return None
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
