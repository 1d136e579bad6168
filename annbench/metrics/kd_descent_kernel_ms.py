"""kd_descent_kernel_ms (ms/batch): device time of the kd forest's seed
descent (`kd_*kernel`, csrc/kd_descent.cu) per batch of the traced
window; nothing where no such kernel ran (a walk seeded on the host)."""

import re

from annbench import layers

# the port's kd descent kernel, as the card names it
KD = re.compile(r"\bkd_\w*kernel")


def read(run):
    return layers.kernel_ms_per_batch(run.trace, KD)
