"""The traced windows of a `--trace 1` run, opened by the thread that
runs the batches once warm-up is done, and what the per-layer metrics
read from them.

* `DeviceWindow`, the first `trace_seconds` of the loop: a
  `torch.profiler` session of the card's activity alone.  Recording every
  host operator as well doubles a graph walk's batch time (some 3,000
  launches a batch), which would read as idleness of the card.  It gives
  `busy_s`, the union of the card's operation intervals (kernels, copies,
  sets), `window_s`, the window's length on the host clock between two
  synchronisations, and the operations the layers' metrics pick by name.
* `HostWindow`, the calls of the next 0.25 s: a session of the host and
  the card, which names each idle gap of the card by the innermost host
  event open at its start (what the host was doing while the card
  waited).  Its times carry the host recording's own cost; only the
  names and shares are read.

The raw event list of the profiler's results is read directly: building
`key_averages()` over the hundreds of thousands of events of a walk takes
minutes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.profiler as tp
from torch.autograd import DeviceType

from annbench import arith

ANNOTATION_PREFIX = "annbench."
WINDOW = ANNOTATION_PREFIX + "window"
BATCH = ANNOTATION_PREFIX + "batch"
# kineto's activity types of the card's own work
DEVICE_KINDS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
NAME_CHARS = 160


@dataclasses.dataclass
class DeviceOp:
    kind: str
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    batches: int
    ops: List[DeviceOp]
    idle_by_host: Dict[str, float]

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for op in self.ops:
            out[op.name] += (op.end_ns - op.start_ns) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        def best(d: Dict[str, float]):
            return [[name[:NAME_CHARS], s] for name, s in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.seconds_by_name()),
                "idle_gaps": best(self.idle_by_host)}


class _Session:
    """One profiler session; `guard` is held while the profiler turns on
    and off (the program's CUDA-graph lock)."""

    def __init__(self, cuda: bool, guard, host: bool):
        self.cuda = cuda
        self.guard = guard if guard is not None else contextlib.nullcontext()
        acts = [tp.ProfilerActivity.CPU] if host or not cuda else []
        if cuda:
            # every session of the process tears CUPTI down at its end,
            # so the next one sees the card afresh
            os.environ.setdefault("TEARDOWN_CUPTI", "1")
            acts.append(tp.ProfilerActivity.CUDA)
        self.prof = tp.profile(activities=acts)
        self.batches = 0

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _enter(self) -> None:
        self._sync()
        with self.guard:
            self.prof.__enter__()

    def _exit(self) -> None:
        with self.guard:
            self.prof.__exit__(None, None, None)

    def events(self):
        return self.prof.profiler.kineto_results.events()


class DeviceWindow(_Session):
    def __init__(self, cuda: bool, guard=None):
        super().__init__(cuda, guard, host=False)

    def start(self) -> None:
        self._enter()
        self.t0 = time.perf_counter()

    def batch(self):
        self.batches += 1
        return contextlib.nullcontext()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self._exit()

    def read(self) -> Optional[TraceReading]:
        if self.batches <= 0:
            return None
        ops = device_ops(self.events())
        busy = arith.union_seconds((op.start_ns, op.end_ns) for op in ops)
        return TraceReading(window_s=self.t1 - self.t0, busy_s=busy / 1e9,
                            batches=self.batches, ops=ops, idle_by_host={})


class HostWindow(_Session):
    def __init__(self, cuda: bool, guard=None):
        super().__init__(cuda, guard, host=True)
        self._range = tp.record_function(WINDOW)

    def start(self) -> None:
        self._enter()
        self._range.__enter__()

    def batch(self):
        self.batches += 1
        return tp.record_function(BATCH)

    def stop(self) -> None:
        self._sync()
        self._range.__exit__(None, None, None)
        self._exit()

    def read(self) -> Dict[str, float]:
        return idle_by_host(self.events())


def _kind(e) -> str:
    """kineto's activity type of an event: read where torch exposes it,
    else worked out from the device and the name as kineto names them."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    cpu = e.device_type() == DeviceType.CPU
    if getattr(e, "is_user_annotation", lambda: False)() or \
            e.name().startswith(ANNOTATION_PREFIX):
        return "user_annotation" if cpu else "gpu_user_annotation"
    if cpu:
        return "cpu_op"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def device_ops(events) -> List[DeviceOp]:
    ops = []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            ops.append(DeviceOp(kind, e.name(), e.start_ns(), e.end_ns()))
    return ops


def idle_by_host(events) -> Dict[str, float]:
    """Seconds of card idleness inside the `annbench.window` range, by the
    innermost host event of the range's thread open at each gap's start;
    empty without the range."""
    kinds = [(e, _kind(e)) for e in events]
    win = next(((e.start_ns(), e.end_ns(), e.start_thread_id())
                for e, kind in kinds
                if kind == "user_annotation" and e.name() == WINDOW), None)
    if win is None:
        return {}
    w0, w1, thread = win
    spans, host = [], []
    for e, kind in kinds:
        if kind in DEVICE_KINDS:
            spans.append((e.start_ns(), e.end_ns()))
        elif (e.device_type() == DeviceType.CPU
              and e.start_thread_id() == thread and e.name() != WINDOW):
            host.append((e.start_ns(), e.end_ns(), e.name()))
    return _idle_by_host(list(arith.gaps(spans, w0, w1)), host)


def _idle_by_host(gaps: List[Tuple[int, int]],
                  host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of card idleness by the innermost host event open at each
    gap's start ("host outside any operator" where none is)."""
    out: Dict[str, float] = collections.defaultdict(float)
    host.sort()
    stack: List[Tuple[int, str]] = []     # (end, name), nested
    i = 0
    for g0, g1 in gaps:                   # gaps come in time order
        while i < len(host) and host[i][0] <= g0:
            s, e, name = host[i]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((e, name))
            i += 1
        while stack and stack[-1][0] <= g0:
            stack.pop()
        name = stack[-1][1] if stack else "host outside any operator"
        out[name] += (g1 - g0) / 1e9
    return dict(out)
