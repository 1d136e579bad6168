"""qps (queries/s): every query answered in the window over the window's
seconds (host clock)."""

from annbench import arith


def read(run):
    return arith.rate(run.answered, run.window_s)
