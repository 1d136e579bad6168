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
  into `logdir`.  ``torch.profiler`` is process-global, so one trace runs
  at a time: `start_trace` holds a process-wide lock until `stop_trace`
  and raises `TraceBusy` while another trace (the metrics listener's
  ``/debug/devicetrace``, or any other caller) holds it.  The profiler
  turns on and off while `capture_lock` is held, so no CUDA graph is
  captured or replayed then, and no graph is captured while a trace holds
  the profiler: a capture checks `tracing()` under the lock and the
  caller runs eagerly instead.  A process that
  serves traces from another thread calls `prepare_device_trace()` once
  from its main thread first: the profiler's CUDA side (Kineto, CUPTI)
  initialises in the first thread that profiles, and Kineto runs its
  client's initialisation only in the thread that registered the client
  (the one that imported torch).

CUPTI between sessions.  ``torch.profiler`` (Kineto) keeps CUPTI
initialised from one profiling session to the next unless
``TEARDOWN_CUPTI=1``.  Kept alive, it loses the card: on the H100 (torch
2.11, CUDA 12.8), in a process whose card kept working between sessions,
a session around three kernel launches recorded all three at first and
none about a minute later, whatever thread had profiled before
(``tests/test_torch_cuda.py``
``test_profiler_sees_the_card_a_minute_after_its_first_session``).  Torn
down at each session's end, CUPTI initialises afresh at the next
(lazily, which torch allows beside CUDA graphs from CUDA 12.6 on), and
every session saw all three.  So the port's own device traces
(`prepare_device_trace`, `start_trace`) set ``TEARDOWN_CUPTI=1``, unless
the environment already names a value, before their profile starts; from
then on every ``torch.profiler`` session of the process tears CUPTI down.
A process that never asks the port for a device trace keeps torch's
default.

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
# held from start_trace to stop_trace (possibly by different threads, so
# a plain Lock, never an RLock)
_trace_lock = threading.Lock()
# one CUDA-graph capture or replay at a time in the process, and none
# while the profiler turns on or off: a server captures and replays from
# its executor thread (padded walk sizes) and from the scheduler's worker
# (capacities) while the quality monitor and background swaps launch
# from their own threads; every capture and replay, and start_trace /
# stop_trace around the profiler's start and stop, holds this lock.  It is
# one lock for every card of the process (the profiler is process-wide):
# a capture on one card holds back the other cards' replays for as long
# as the capture itself (the warm-up before it runs outside the lock), and
# a replay holds it only while the graph is launched
capture_lock = threading.Lock()
_prepared = False


class TraceBusy(RuntimeError):
    """Another ``torch.profiler`` trace is running in this process."""


def _teardown_cupti() -> None:
    """Every later ``torch.profiler`` session of the process ends by
    tearing CUPTI down (see the module docstring); an operator's own
    setting wins."""
    os.environ.setdefault("TEARDOWN_CUPTI", "1")


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
    if not _trace_lock.acquire(blocking=False):
        raise TraceBusy("a torch.profiler trace is already running")
    try:
        import torch
        import torch.profiler

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            _teardown_cupti()
        prof = torch.profiler.profile(activities=acts)
        with capture_lock:
            prof.__enter__()
        os.makedirs(logdir, exist_ok=True)
    except BaseException:
        _trace_lock.release()
        raise
    _logdir = logdir
    _profile = prof


def tracing() -> bool:
    """True while a `start_trace` trace holds the profiler: a CUDA graph
    capture checks it under `capture_lock` and is skipped when it is
    true."""
    return _trace_lock.locked()


def prepare_device_trace() -> None:
    """Start and stop one empty profile of the card in the calling
    thread, once per process, when CUDA is available: the profiler's CUDA
    side then initialises here, before any other thread profiles or
    launches, and not in a scrape thread under load.  Call it from the
    main thread."""
    global _prepared
    if _prepared:
        return
    import torch

    if not torch.cuda.is_available():
        return
    import torch.profiler

    _teardown_cupti()
    with _trace_lock, capture_lock:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            pass
        _prepared = True


def stop_trace() -> Optional[str]:
    """End the trace and write it as ``<logdir>/trace.json``; returns the
    path, or None when no trace was running."""
    global _profile, _logdir
    prof, logdir = _profile, _logdir
    _profile = _logdir = None
    if prof is None:
        return None
    try:
        with capture_lock:
            prof.__exit__(None, None, None)
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
    finally:
        _trace_lock.release()
    return path
