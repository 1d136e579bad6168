"""batch_p95_ms (ms): the 95th percentile over every `search_batch` call
of the window, from the call to the numpy answers (host clock)."""

from annbench import arith


def read(run):
    return arith.percentile(run.latencies_s, 95) * 1e3
