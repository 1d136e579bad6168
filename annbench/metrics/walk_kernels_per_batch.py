"""walk_kernels_per_batch (kernels/batch): the card's kernel launches in
the traced window per batch, in a window where the walk's kernels ran."""

from annbench import layers


def read(run):
    return layers.kernels_per_batch(run.trace, layers.WALK)
