"""build_s (s): the host clock around `VectorIndex.build`."""


def read(run):
    return run.build_s
