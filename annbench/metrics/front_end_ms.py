"""front_end_ms (ms/batch): the host's time in `search_batch` outside
the mode's search and the wait for the card, per call: the port's
`search.call` less `search.dispatch` and `search.wait` (host clock)."""

from annbench import spans


def read(run):
    call = spans.span("search.call")
    dispatch = spans.total_s("search.dispatch")
    wait = spans.total_s("search.wait")
    if call is None or dispatch is None or wait is None:
        return None
    return (call["total_s"] - dispatch - wait) / call["count"] * 1e3
