"""What the per-layer metrics read from the program's own clock: the
port's span registry (``sptag_tpu_torch/utils/trace.py``, `report()`)
and its counters (``sptag_tpu_torch/utils/metrics.py``).

They are read from the modules the run has loaded, so the benchmark
imports nothing of the port here, and a program without a span or
counter reads as nothing (None).  The registry holds every call of the
run, the warm-up and the traced windows' included, and the build.
"""

from __future__ import annotations

import sys
from typing import Optional

TRACE = "sptag_tpu_torch.utils.trace"
METRICS = "sptag_tpu_torch.utils.metrics"


def span(name: str) -> Optional[dict]:
    """The span's {count, total_s, ...}, or None where it never closed."""
    trace = sys.modules.get(TRACE)
    if trace is None:
        return None
    entry = trace.report().get(name)
    return entry if entry and entry["count"] else None


def total_s(name: str) -> Optional[float]:
    entry = span(name)
    return None if entry is None else entry["total_s"]


def counter(name: str) -> Optional[int]:
    """The counter's value, or None without the registry."""
    metrics = sys.modules.get(METRICS)
    return None if metrics is None else metrics.counter_value(name)
