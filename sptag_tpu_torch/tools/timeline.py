"""Timeline CLI — terminal sparklines over the serving time-series (copy
of ``sptag_tpu/tools/timeline.py``).

``python -m sptag_tpu_torch.tools.timeline <target>`` where target is either
a metrics-listener base URL (``http://127.0.0.1:8001`` — fetches
``/debug/timeline``) or a saved snapshot JSON file.  Renders one
sparkline row per series: name, min/mean/max/last, and the fine ring as
unicode block characters — the sixty-second "what happened" view an
operator gets before reaching for Grafana.

Options: ``--series SUBSTR`` filters, ``--window S`` bounds to the
trailing window, ``--coarse`` plots the downsampled long-horizon rings,
``--width N`` sets the sparkline width, ``--json`` dumps the fetched
snapshot instead of rendering (for piping into files/tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 60) -> str:
    """Downsample `values` to `width` columns (mean per column) and map
    onto eight block glyphs; constant series render mid-height."""
    if not values:
        return ""
    if len(values) > width:
        # mean-pool into `width` buckets so spikes shorter than one
        # column still move the column they land in
        out = []
        n = len(values)
        for c in range(width):
            lo = c * n // width
            hi = max((c + 1) * n // width, lo + 1)
            chunk = values[lo:hi]
            out.append(sum(chunk) / len(chunk))
        values = out
    vmin, vmax = min(values), max(values)
    span = vmax - vmin
    if span <= 0:
        return _BLOCKS[3] * len(values)
    return "".join(_BLOCKS[min(int((v - vmin) / span * 8), 7)]
                   for v in values)


def _fetch(target: str, window_s: Optional[float], series: Optional[str],
           coarse: bool) -> dict:
    if target.startswith(("http://", "https://")):
        import urllib.parse
        import urllib.request

        params = {}
        if window_s is not None:
            params["window_s"] = str(window_s)
        if series:
            params["series"] = series
        if coarse:
            params["coarse"] = "1"
        url = target.rstrip("/") + "/debug/timeline"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.load(resp)
    with open(target, encoding="utf-8") as f:
        return json.load(f)


def _fmt(v: float) -> str:
    if abs(v) >= 1000:
        return "%.4g" % v
    return "%.3g" % v


def report(snap: dict, width: int = 60,
           series_filter: Optional[str] = None) -> List[str]:
    """Render a fetched /debug/timeline snapshot as report lines."""
    cfg = snap.get("config", {})
    cnt = snap.get("counters", {})
    lines = ["timeline: enabled=%s interval=%sms series=%s samples=%s"
             % (snap.get("enabled"), cfg.get("interval_ms"),
                cnt.get("series"), cnt.get("samples"))]
    series = snap.get("series", {})
    if not series:
        lines.append("(no series recorded)")
        return lines
    name_w = min(max(len(n) for n in series), 48)
    for name in sorted(series):
        if series_filter and series_filter not in name:
            continue
        st = series[name]
        vals = [v for _t, v in st.get("points", [])]
        lines.append(
            "%-*s  %s  [min %s  mean %s  max %s  last %s  n=%d]"
            % (name_w, name[:name_w], sparkline(vals, width),
               _fmt(st["min"]), _fmt(st["mean"]), _fmt(st["max"]),
               _fmt(st["last"]), st["n"]))
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="render the serving timeline as terminal sparklines")
    parser.add_argument("target",
                        help="metrics listener base URL or snapshot file")
    parser.add_argument("--series", default=None,
                        help="substring filter on series names")
    parser.add_argument("--window", type=float, default=None,
                        help="trailing window in seconds")
    parser.add_argument("--coarse", action="store_true",
                        help="plot the downsampled long-horizon rings")
    parser.add_argument("--width", type=int, default=60)
    parser.add_argument("--json", action="store_true",
                        help="dump the snapshot JSON instead of rendering")
    args = parser.parse_args(argv)
    snap = _fetch(args.target, args.window, args.series, args.coarse)
    if args.json:
        json.dump(snap, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0
    for line in report(snap, width=args.width,
                       series_filter=args.series):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
