"""What the per-layer metrics read from a traced window: the card's
kernels of one layer, picked by name."""

from __future__ import annotations

import re
from typing import Optional

from annbench.devtrace import TraceReading

# the port's walk kernels (csrc/walk_dots.cu), as the card names them
WALK = re.compile(r"\bwalk_\w*kernel")


def layer_ops(trace: Optional[TraceReading], pattern: re.Pattern):
    """The window's kernels whose names match, or None when the layer ran
    no kernel in the window (or the run has no trace)."""
    if trace is None:
        return None
    ops = [op for op in trace.ops if pattern.search(op.name)]
    return ops or None


def kernels_per_batch(trace: Optional[TraceReading],
                      pattern: re.Pattern) -> Optional[float]:
    """Every kernel the card ran in the window per batch, in a window
    where the layer's own kernels ran."""
    if layer_ops(trace, pattern) is None:
        return None
    kernels = sum(1 for op in trace.ops if op.kind == "kernel")
    return kernels / trace.batches


def kernel_ms_per_batch(trace: Optional[TraceReading],
                        pattern: re.Pattern) -> Optional[float]:
    """The layer's kernels' device milliseconds per batch."""
    ops = layer_ops(trace, pattern)
    if ops is None:
        return None
    return sum(op.end_ns - op.start_ns for op in ops) / 1e6 / trace.batches
