"""walk_bodies_per_batch (bodies/batch): walk bodies run per call, the
port's `search.walk_bodies` counter over its `search.call` count."""

from annbench import spans


def read(run):
    call = spans.span("search.call")
    bodies = spans.counter("search.walk_bodies")
    if call is None or not bodies:
        return None
    return bodies / call["count"]
