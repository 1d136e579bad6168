"""kd_descent_roofline (%): the kd descent's bytes over its device time,
as a share of the H100 SXM's 3.35 TB/s of HBM3.

Bytes a call: every node record the descent read (the port's
`search.kd_node_reads` counter over its `search.call` count), 16 B a
KDTNode record and the 4 B of the query it compares at that node: a
level reads one element of the query, not its row.  Time a call: the
descent kernel's device time per batch of the traced window
(`kd_descent_kernel_ms`).  The counter covers every call of the run and
the time the window's; every call of a cell sends alike batches from one
query set, so the mean stands for the window's.  Nothing where the
program has no such counter or kernel."""

import re

from annbench import layers, spans

# the port's kd descent kernel, as the card names it
KD = re.compile(r"\bkd_\w*kernel")
HBM_BYTES_PER_S = 3.35e12
# a KDTNode record and the query element compared with its split
BYTES_PER_NODE = 16 + 4


def read(run):
    ms = layers.kernel_ms_per_batch(run.trace, KD)
    call = spans.span("search.call")
    reads = spans.counter("search.kd_node_reads")
    if ms is None or call is None or not reads:
        return None
    nbytes = reads * BYTES_PER_NODE / call["count"]
    return 100.0 * nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
