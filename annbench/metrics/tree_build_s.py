"""tree_build_s (s): the build's tree stage, the port's `build.bkt_tree`
span (host clock)."""

from annbench import spans


def read(run):
    return spans.total_s("build.bkt_tree")
