"""graph_build_s (s): the build's RNG graph stage, the port's
`build.rng_graph` span (host clock); nothing where the index has no
graph."""

from annbench import spans


def read(run):
    return spans.total_s("build.rng_graph")
