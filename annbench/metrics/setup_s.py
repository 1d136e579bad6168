"""setup_s (s): process start to the first timed call: CUDA
initialisation, the kernels' libraries, data, build and warm-up."""


def read(run):
    return run.setup_s
