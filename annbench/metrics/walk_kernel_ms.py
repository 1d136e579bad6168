"""walk_kernel_ms (ms/batch): device time of the walk's kernels
(`walk_*_kernel`, csrc/walk_dots.cu) per batch of the traced window."""

from annbench import layers


def read(run):
    return layers.kernel_ms_per_batch(run.trace, layers.WALK)
