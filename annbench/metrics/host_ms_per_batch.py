"""host_ms_per_batch (ms/batch): the host's time in `search_batch` outside
the wait for the card, per call: the port's `search.call` less
`search.wait` (host clock).  It moves with the host's work (front end,
launches, readback), not with the card's speed."""

from annbench import spans


def read(run):
    call = spans.span("search.call")
    wait = spans.total_s("search.wait")
    if call is None or wait is None:
        return None
    return (call["total_s"] - wait) / call["count"] * 1e3
