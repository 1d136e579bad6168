"""Flight-dump merge CLI (copy of ``sptag_tpu/tools/flight.py`` over the
port's flight recorder).

A slow query crosses processes — client, aggregator, shard servers —
and each tier's recorder (utils/flightrec.py) dumps its OWN ring
(`FlightDumpOnSlowQuery`, `/debug/flight`, `--flight-dump`).  This tool
joins those dumps into ONE Chrome trace:

    python -m sptag_tpu_torch.tools.flight -o merged.json \\
        agg/flight-*.json shard0/flight-*.json shard1/flight-*.json \\
        [--rid e2e-rid-0042]

Dumps carry the RAW events (`flightEvents`) next to the rendered
`traceEvents`, so the merge re-exports from raw events: flow arrows are
recomputed GLOBALLY per request id (per-dump exports can only chain the
spans one process saw), duplicate events from overlapping ring dumps
collapse, and tiers that collide across files (two shard processes both
named "server") are disambiguated with a per-file suffix.  Timestamps
are CLOCK_MONOTONIC, which shares its epoch across processes on one
Linux machine — dumps from one host merge onto a coherent timeline;
cross-host merges stay per-rid-correct but tier clocks may be offset.

`--rid` narrows the output to one request id (plus untagged pool-level
events are dropped) — the "explain THIS query" artifact.

Host-profiler overlay: `utils/hostprof.py` exports its
sample ring in the same dump schema (tier ``hostprof``, kind
``sample``, rid-tagged where attribution is exact), so
``hostprof.write_trace`` files and ``/debug/prof?action=chrome`` output
merge right here — host stacks land on the same Perfetto timeline as
the flight spans and sampled device segments, one track per sampled
thread.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from sptag_tpu_torch.utils import flightrec


def load_dump(path: str, index: int = 0):
    """(raw events, source key) of one dump file.  The source key is the
    recorder's pid when the dump carries one (otherData.pid) — so two
    successive ringed dumps of ONE process share a key and are never
    split into two Perfetto processes — falling back to a per-file key
    for hand-crafted inputs.  Tolerates a bare event list."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return data, f"file{index}"
    events = data.get("flightEvents")
    if events is None:
        raise ValueError(
            f"{path}: no flightEvents — not a flight recorder dump "
            "(a bare Chrome trace cannot be re-merged; pass the "
            "recorder's own dump files)")
    pid = data.get("otherData", {}).get("pid")
    return events, (f"pid{pid}" if pid is not None else f"file{index}")


def merge_events(per_file: List[List[dict]], sources: List[str],
                 rid: Optional[str] = None) -> List[dict]:
    """Concatenate per-file raw events, dedupe overlapping ring dumps,
    and disambiguate tier names that appear under DIFFERENT source
    processes (two shard processes both named "server") with a source
    suffix — same-process dumps keep one tier."""
    tier_sources: Dict[str, set] = {}
    for events, src in zip(per_file, sources):
        for e in events:
            tier_sources.setdefault(e["tier"], set()).add(src)
    merged: List[dict] = []
    seen = set()
    for events, src in zip(per_file, sources):
        for e in events:
            if rid is not None and e.get("rid") != rid:
                continue
            key = (e["t_ns"], e["tier"], e["kind"], e.get("tid"),
                   e.get("rid"), e.get("dur_ns"))
            if key in seen:
                continue                 # overlapping dumps share a ring
            seen.add(key)
            tier = e["tier"]
            if len(tier_sources.get(tier, ())) > 1:
                e = dict(e, tier=f"{tier}#{src}")
            merged.append(e)
    merged.sort(key=lambda e: e["t_ns"])
    return merged


def merge_traces(paths: List[str], rid: Optional[str] = None) -> dict:
    loaded = [load_dump(p, i) for i, p in enumerate(paths)]
    events = merge_events([ev for ev, _ in loaded],
                          [src for _, src in loaded], rid=rid)
    return flightrec.export_chrome_trace(
        events, other_data={"merged_from": list(paths),
                            "rid_filter": rid or ""})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="merge flight-recorder dumps from multiple tiers "
                    "into one Perfetto-loadable Chrome trace")
    parser.add_argument("dumps", nargs="+",
                        help="flight dump files (FlightDumpOnSlowQuery "
                             "output, /debug/flight captures, or "
                             "--flight-dump artifacts)")
    parser.add_argument("-o", "--output", default="-",
                        help="merged trace path ('-' = stdout)")
    parser.add_argument("--rid", default=None,
                        help="keep only this request id's events")
    args = parser.parse_args(argv)
    try:
        trace = merge_traces(args.dumps, rid=args.rid)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"flight: {e}", file=sys.stderr)
        return 1
    n = sum(1 for ev in trace["traceEvents"] if ev.get("ph") != "M")
    if args.output == "-":
        json.dump(trace, sys.stdout)
        sys.stdout.write("\n")
    else:
        with open(args.output, "w") as f:
            json.dump(trace, f)
        print(f"wrote {args.output}: {n} events from {len(args.dumps)} "
              "dump(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
