"""Recompile guard and trace/transfer sentinel (port of
``sptag_tpu/utils/recompile_guard.py``).

What counts as a "compile" on the card.  The JAX package counts XLA backend
compilations through ``jax.monitoring``.  The port compiles nothing per
shape; what it pays for once per key, and must not pay again in a served
steady state, is

* a **CUDA-graph capture** (the engine's whole-walk graphs and the slot
  scheduler's segment graphs), and
* an **nvcc build** of a ``csrc/`` kernel library (``_build.build``).

Each calls `note_compile(kind, seconds)`.  Every active `track_compiles`
window counts it, and it is recorded in utils/trace.py under the span
``cuda.compile`` (``cuda.compile[<label>]`` inside a window) where the JAX
package records ``xla.backend_compile``; it is also charged to the
innermost hot section's compile budget.  `track_compiles` /
`no_recompiles` / `warmup_then_guard`, `CompileLog` and `RecompileError`
keep the JAX package's surface.

The trace sentinel (``SPTAG_TRACESAN`` / ``[Service] TraceSanitizer``).
Engine and scheduler hot paths declare themselves with
``hot_section("family")``.  Inside one, while the sentinel is armed,

* every IMPLICIT device-to-host sync of a CUDA tensor is a violation:
  ``.item()``, ``bool()``, ``int()``, ``float()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` and ``__array__`` are shimmed on
  ``torch.Tensor`` while the sentinel is armed (the JAX package shims
  ``ArrayImpl`` the same way).  A CPU tensor never counts: it involves no
  card.
* `device_get(x)` is the blessed EXPLICIT readback: it copies to host
  numpy under a thread-local blessing, so the shims stay quiet.
* every compile (capture or build) is attributed to the innermost section
  and checked against its budget (`set_compile_budget`, the
  `enable_tracesan(compile_budget=...)` default); a trip counts
  ``tracesan.compile_budget_trips`` and raises `CompileBudgetError` in
  strict mode.

Disarmed, `hot_section` tests one flag and yields.  Armed, a shim costs
one thread-local read when its thread is in no hot section.  The shims are
installed at the first armed hot section and removed by `disable_tracesan`
and `reset_tracesan`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Dict, Iterator, List, Optional

from sptag_tpu_torch.utils import metrics, trace

log = logging.getLogger("sptag_tpu_torch.tracesan")

#: the trace-span family compile durations are recorded under (the JAX
#: package's ``xla.backend_compile``)
TRACE_SPAN = "cuda.compile"

#: the two kinds of compile the port has
CAPTURE = "graph_capture"
BUILD = "nvcc_build"

_lock = threading.Lock()
_active: List["CompileLog"] = []


class RecompileError(AssertionError):
    """A guard observed more compiles than its window allows."""


class CompileLog:
    """Counter for one `track_compiles` window."""

    def __init__(self, label: str):
        self.label = label
        self.count = 0
        self.total_s = 0.0
        self.durations: List[float] = []
        self.kinds: Dict[str, int] = {}
        self._log_lock = threading.Lock()

    def _record(self, duration_s: float, kind: str) -> None:
        with self._log_lock:
            self.count += 1
            self.total_s += duration_s
            self.durations.append(duration_s)
            self.kinds[kind] = self.kinds.get(kind, 0) + 1

    def assert_compiles(self, at_most: int, context: str = "") -> None:
        """Raise RecompileError if more than `at_most` compiles were
        observed in this window."""
        if self.count > at_most:
            where = f" during {context}" if context else ""
            raise RecompileError(
                f"[{self.label}] {self.count} compile(s){where} "
                f"({self.kinds}), expected at most {at_most} — a walk "
                "shape or plan varies per call, or the graph cache is "
                "thrashing")

    def __repr__(self) -> str:
        return (f"CompileLog({self.label!r}, count={self.count}, "
                f"total_s={round(self.total_s, 3)})")


def note_compile(kind: str, duration_s: float) -> None:
    """Record one compile (`CAPTURE` or `BUILD`) of `duration_s` seconds:
    counted by every active window, recorded as a trace span, and charged
    to the calling thread's innermost hot section."""
    with _lock:
        logs = list(_active)
    for clog in logs:
        clog._record(duration_s, kind)
        trace.record(f"{TRACE_SPAN}[{clog.label}]", duration_s)
    if not logs:
        trace.record(TRACE_SPAN, duration_s)
    if tracesan_enabled():
        _tracesan_on_compile()


@contextlib.contextmanager
def track_compiles(label: str = "guard") -> Iterator[CompileLog]:
    """Count compiles (graph captures, nvcc builds) within the block.

        with track_compiles("beam.warm") as log:
            index.search_batch(queries, 10)
        log.assert_compiles(at_most=0)
    """
    log_ = CompileLog(label)
    with _lock:
        _active.append(log_)
    try:
        yield log_
    finally:
        with _lock:
            _active.remove(log_)


@contextlib.contextmanager
def no_recompiles(label: str = "steady-state",
                  at_most: int = 0) -> Iterator[CompileLog]:
    """`track_compiles` that raises RecompileError on a clean exit when
    the block compiled more than `at_most` times."""
    with track_compiles(label) as log_:
        yield log_
    log_.assert_compiles(at_most)


def warmup_then_guard(fn, *args, label: str = "steady-state",
                      repeats: int = 1, **kwargs):
    """Run `fn` once (warm-up: compiles are expected), then `repeats` more
    times under a zero-compile guard; returns the last result."""
    result = fn(*args, **kwargs)
    with no_recompiles(label):
        for _ in range(repeats):
            result = fn(*args, **kwargs)
    return result


# ---------------------------------------------------------------------------
# trace/transfer sentinel (SPTAG_TRACESAN / [Service] TraceSanitizer)
# ---------------------------------------------------------------------------

_MAX_VIOLATION_RECORDS = 200

_ts_cfg_lock = threading.Lock()
_ts_tls = threading.local()            # .sections: List[str]; .blessed: int
_tracesan_override: Optional[bool] = None
_tracesan_strict_override: Optional[bool] = None
_ts_shims_installed = False
# attr -> the original (None: inherited from TensorBase, deleted on removal)
_ts_originals: Dict[str, object] = {}
_ts_violations: List[dict] = []
_ts_transfers = 0
_ts_compiles: Dict[str, int] = {}
_ts_budgets: Dict[str, int] = {}
_ts_default_budget: Optional[int] = None
_ts_budget_trips = 0

#: the implicit readbacks the shims watch: (kind, torch.Tensor attribute)
_SHIMMED = (("item", "item"), ("bool", "__bool__"), ("int", "__int__"),
            ("float", "__float__"), ("tolist", "tolist"), ("cpu", "cpu"),
            ("numpy", "numpy"), ("__array__", "__array__"))


class TransferSyncError(AssertionError):
    """An implicit device-to-host sync fired inside a hot section."""


class CompileBudgetError(RecompileError):
    """A hot-section family exceeded its compile budget."""


def _tracesan_env() -> str:
    return os.environ.get("SPTAG_TRACESAN", "").strip().lower()


def tracesan_enabled() -> bool:
    """The opt-in sentinel: env ``SPTAG_TRACESAN=1`` (``strict`` /
    ``raise`` to make violations raise) or ini ``[Service]
    TraceSanitizer``."""
    if _tracesan_override is not None:
        return _tracesan_override
    return _tracesan_env() in ("1", "true", "on", "yes", "log",
                               "strict", "raise")


def tracesan_strict() -> bool:
    if _tracesan_strict_override is not None:
        return _tracesan_strict_override
    return _tracesan_env() in ("strict", "raise")


def enable_tracesan(strict: Optional[bool] = None,
                    compile_budget: Optional[int] = None) -> None:
    """Arm the sentinel for hot sections entered from now on.
    `strict` / `compile_budget` override the env; None keeps the
    env-derived values (budget default: unlimited)."""
    global _tracesan_override, _tracesan_strict_override, \
        _ts_default_budget
    with _ts_cfg_lock:
        _tracesan_override = True
        if strict is not None:
            _tracesan_strict_override = strict
        if compile_budget is not None:
            _ts_default_budget = int(compile_budget)


def disable_tracesan() -> None:
    global _tracesan_override, _tracesan_strict_override
    with _ts_cfg_lock:
        _tracesan_override = False
        _tracesan_strict_override = None
    _uninstall_shims()


def reset_tracesan() -> None:
    """Back to env-derived config; drop all records, counts, budgets and
    the shims (test isolation)."""
    global _tracesan_override, _tracesan_strict_override, \
        _ts_default_budget, _ts_transfers, _ts_budget_trips
    with _ts_cfg_lock:
        _tracesan_override = None
        _tracesan_strict_override = None
        _ts_default_budget = None
        _ts_transfers = 0
        _ts_budget_trips = 0
        _ts_violations.clear()
        _ts_compiles.clear()
        _ts_budgets.clear()
    _uninstall_shims()


def set_compile_budget(family: str, at_most: int) -> None:
    """Budget compiles for one hot-section family (overrides the
    `enable_tracesan(compile_budget=...)` default for that family)."""
    with _ts_cfg_lock:
        _ts_budgets[family] = int(at_most)


def violations() -> List[dict]:
    with _ts_cfg_lock:
        return [dict(v) for v in _ts_violations]


def violation_count() -> int:
    with _ts_cfg_lock:
        return _ts_transfers


def compile_counts() -> Dict[str, int]:
    """{family: compiles observed} while armed."""
    with _ts_cfg_lock:
        return dict(_ts_compiles)


def tracesan_counters() -> Dict[str, object]:
    with _ts_cfg_lock:
        return {"enabled": tracesan_enabled(),
                "transfers": _ts_transfers,
                "compiles": sum(_ts_compiles.values()),
                "budget_trips": _ts_budget_trips}


def shims_installed() -> bool:
    return _ts_shims_installed


def _sections() -> List[str]:
    return getattr(_ts_tls, "sections", None) or []


def _blessed() -> bool:
    return getattr(_ts_tls, "blessed", 0) > 0


def _flag_transfer(kind: str) -> None:
    sections = _sections()
    if not sections or _blessed() or not tracesan_enabled():
        return
    global _ts_transfers
    with _ts_cfg_lock:
        _ts_transfers += 1
        if len(_ts_violations) < _MAX_VIOLATION_RECORDS:
            _ts_violations.append({"section": sections[-1], "kind": kind,
                                   "stack": list(sections)})
    metrics.inc("tracesan.transfers")
    msg = (f"implicit device->host sync (`{kind}`) inside hot section "
           f"{sections[-1]!r} — read back explicitly with "
           "recompile_guard.device_get, or move the sync out of the loop")
    if tracesan_strict():
        raise TransferSyncError(msg)
    log.warning(msg)


def _install_shims() -> None:
    """Wrap torch.Tensor's host-readback methods (idempotent).  A shim is
    one thread-local read when its thread is in no hot section."""
    global _ts_shims_installed
    with _ts_cfg_lock:
        if _ts_shims_installed:
            return
        import torch

        def make(kind, orig):
            def shim(self, *args, **kwargs):
                if not getattr(_ts_tls, "sections", None) \
                        or getattr(_ts_tls, "in_shim", False):
                    return orig(self, *args, **kwargs)
                # one readback flags once, even when a Tensor subclass's
                # __torch_function__ calls the shim again
                if self.is_cuda:
                    _flag_transfer(kind)
                _ts_tls.in_shim = True
                try:
                    return orig(self, *args, **kwargs)
                finally:
                    _ts_tls.in_shim = False
            shim.__name__ = getattr(orig, "__name__", kind)
            shim._tracesan_orig = orig
            return shim

        for kind, attr in _SHIMMED:
            orig = getattr(torch.Tensor, attr, None)
            if orig is None or hasattr(orig, "_tracesan_orig"):
                continue
            _ts_originals[attr] = (orig if attr in torch.Tensor.__dict__
                                   else None)
            setattr(torch.Tensor, attr, make(kind, orig))
        _ts_shims_installed = True


def _uninstall_shims() -> None:
    global _ts_shims_installed
    with _ts_cfg_lock:
        if not _ts_shims_installed:
            return
        import torch

        for attr, orig in _ts_originals.items():
            if orig is None:
                delattr(torch.Tensor, attr)
            else:
                setattr(torch.Tensor, attr, orig)
        _ts_originals.clear()
        _ts_shims_installed = False


@contextlib.contextmanager
def hot_section(name: str) -> Iterator[None]:
    """Declare a device-dispatch hot region (the scheduler cycle, bucket
    seeding, a walk's readback).  Disarmed: one flag test, then yield.
    Armed: implicit syncs of CUDA tensors inside the block are violations,
    and compiles are charged to `name`'s budget."""
    if not tracesan_enabled():
        yield
        return
    _install_shims()
    stack = getattr(_ts_tls, "sections", None)
    if stack is None:
        stack = _ts_tls.sections = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def device_get(x):
    """The blessed explicit readback: a tensor (or a tuple / list / dict
    of them) copied to host numpy under a thread-local blessing, so the
    sentinel's shims stay quiet.  Non-tensors pass through."""
    _ts_tls.blessed = getattr(_ts_tls, "blessed", 0) + 1
    try:
        return _to_host(x)
    finally:
        _ts_tls.blessed -= 1


def _to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _tracesan_on_compile() -> None:
    sections = _sections()
    if not sections:
        return
    family = sections[-1]
    global _ts_budget_trips
    with _ts_cfg_lock:
        _ts_compiles[family] = _ts_compiles.get(family, 0) + 1
        count = _ts_compiles[family]
        budget = _ts_budgets.get(family, _ts_default_budget)
    metrics.inc("tracesan.compiles")
    if budget is None or count <= budget:
        return
    with _ts_cfg_lock:
        _ts_budget_trips += 1
    metrics.inc("tracesan.compile_budget_trips")
    msg = (f"hot-section family {family!r} compiled {count} time(s), "
           f"budget {budget} — a walk shape or plan varies per call in "
           "the steady state")
    if tracesan_strict():
        raise CompileBudgetError(msg)
    log.warning(msg)
