"""Roofline perf report — ``python -m sptag_tpu_torch.tools.perf_report``
(port of ``sptag_tpu/tools/perf_report.py``).

Renders a markdown roofline table from either

* the output of the port's ``chip_smoke.py`` (its standard output, or a
  file of it): the ``{"kernels": [...]}`` line gives one row per kernel —
  time, plain version, library call, the bound and its share — headed by
  the card's peaks from the run's ``{"roofline": ...}`` line (phase 15a
  prints one); or
* a bench artifact with a ``roofline`` block (the JAX package's layout:
  one ledger-derived row per measured family).

    python -m sptag_tpu_torch.tools.perf_report chip_smoke.out
    python -m sptag_tpu_torch.tools.perf_report BENCH_r06.json
    python -m sptag_tpu_torch.tools.perf_report --probe   # this card's caps

``--probe`` prints this machine's capability, running the disk-cached
micro-probe where the table has no entry.  The tables are GitHub markdown.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, List, Optional


def _fmt(v, nd=2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def capability_dict(cap) -> dict:
    """A `roofline.Capability` as the dict `render_peaks` reads."""
    return {"device_kind": cap.device_kind, "source": cap.source,
            "peak_flops_f32": cap.peak_flops_f32,
            "peak_flops_bf16": cap.peak_flops_bf16,
            "peak_flops_int8": cap.peak_flops_int8,
            "hbm_gbps": cap.hbm_gbps}


def render_peaks(peaks: dict) -> List[str]:
    out = [f"Device: **{peaks.get('device_kind', 'unknown')}** "
           f"(capability source: {peaks.get('source', 'none')})"]
    pf = peaks.get("peak_flops_f32")
    pb = peaks.get("peak_flops_bf16")
    pi = peaks.get("peak_flops_int8")
    bw = peaks.get("hbm_gbps")
    parts = []
    if pf:
        parts.append(f"f32 peak {pf / 1e12:.2f} TFLOP/s")
    if pb and pb != pf:
        parts.append(f"bf16 peak {pb / 1e12:.2f} TFLOP/s")
    if pi and pi not in (pf, pb):
        parts.append(f"int8 peak {pi / 1e12:.2f} TOP/s")
    if bw:
        parts.append(f"memory {bw:.1f} GB/s")
    if parts:
        out.append("Peaks: " + ", ".join(parts))
    else:
        out.append("Peaks: unknown (run with RooflineProbe=1, or on a "
                   "card the table knows)")
    return out


def render_kernels(kernels: List[dict], peaks: Optional[dict] = None
                   ) -> List[str]:
    """Markdown lines for chip_smoke.py's ``kernels`` rows: each kernel's
    time against its bound (the larger of its bytes over the memory rate
    and its operations over the peak rate), its plain version and its
    library call."""
    lines: List[str] = []
    if peaks:
        lines.extend(render_peaks(peaks))
        lines.append("")
    lines.append("| kernel | route | launches | ms | bound ms | bound by | "
                 "% of bound | plain ms | library ms | max abs err |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|")
    for k in kernels:
        ms, bound = k.get("ms"), k.get("bound_ms")
        share = (100.0 * bound / ms) if ms and bound else None
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} | {} | {} | {} |".format(
                k.get("name", "-"), k.get("route", "-"),
                k.get("launches", "-"), _fmt(ms, 4), _fmt(bound, 4),
                k.get("bound_by", "-"), _fmt(share, 1),
                _fmt(k.get("plain_ms"), 4), _fmt(k.get("library_ms"), 4),
                _fmt(k.get("max_abs_err"), 6)))
    return lines


def render_table(roofline: dict, qps_by_row: Optional[dict] = None
                 ) -> List[str]:
    """Markdown lines for one bench artifact's roofline block."""
    rows = roofline.get("rows", {})
    lines: List[str] = []
    lines.extend(render_peaks(roofline.get("peaks", {})))
    lines.append("")
    lines.append("| path | family | QPS | GFLOP/q | MB/q | achieved "
                 "GFLOP/s | achieved GB/s | % peak FLOPs | % peak HBM | "
                 "bound |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|")
    order = [lbl for lbl in ("flat", "dense", "beam", "int8") if lbl in rows]
    order += sorted(lbl for lbl in rows if lbl not in order)
    for label in order:
        row = rows[label]
        qps = (qps_by_row or {}).get(label)
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} | {} | {} | {} |".format(
                label, row.get("family", "-"), _fmt(qps, 1),
                _fmt(row.get("flops_per_query", 0) / 1e9, 4),
                _fmt(row.get("hbm_bytes_per_query", 0) / 1e6, 3),
                _fmt(row.get("achieved_gflops")),
                _fmt(row.get("achieved_gbps")),
                _fmt(row.get("pct_peak_flops"), 4),
                _fmt(row.get("pct_peak_hbm"), 4),
                row.get("bound", "-")))
    return lines


def report_from_bench(obj: dict) -> List[str]:
    if "parsed" in obj and isinstance(obj["parsed"], dict):
        obj = obj["parsed"]          # a wrapped artifact keeps it here
    roofline = obj.get("roofline")
    lines = [f"# Roofline report — platform: "
             f"{obj.get('platform', 'unknown')}", ""]
    if not roofline:
        lines.append("No roofline block in this artifact (stage failed "
                     "before any measured row; see roofline_errors).")
        for k, v in (obj.get("roofline_errors") or {}).items():
            lines.append(f"- {k}: {v}")
        return lines
    qps_by_row = {"flat": obj.get("flat_qps"), "dense": obj.get("value"),
                  "beam": obj.get("beam_qps"), "int8": obj.get("int8_qps")}
    lines.extend(render_table(roofline, qps_by_row))
    return lines


def json_lines(text: str) -> Iterable[dict]:
    """Every line of `text` that parses as one JSON object."""
    for line in text.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            yield obj


def report_from_text(text: str, peaks: Optional[dict] = None) -> List[str]:
    """A report from chip_smoke.py's output, or from one JSON document (a
    bench artifact)."""
    kernels, roofline_peaks = None, None
    for obj in json_lines(text):
        if isinstance(obj.get("kernels"), list):
            kernels = obj["kernels"]
        if isinstance(obj.get("roofline"), dict) \
                and "device_kind" in obj["roofline"]:
            roofline_peaks = obj["roofline"]
    if kernels is not None:
        lines = ["# Kernel roofline report (chip_smoke.py)", ""]
        lines.extend(render_kernels(kernels, roofline_peaks or peaks))
        return lines
    try:
        obj = json.loads(text)
    except ValueError:
        return ["perf_report: no kernels line and no JSON artifact in the "
                "input"]
    return report_from_bench(obj)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="perf_report",
        description="render the roofline table from chip_smoke.py's "
                    "output or a bench artifact")
    parser.add_argument("source", nargs="?", default=None,
                        help="chip_smoke.py output or a BENCH_*.json "
                             "(default: standard input)")
    parser.add_argument("--probe", action="store_true",
                        help="print this machine's capability (runs the "
                             "disk-cached micro-probe where the table has "
                             "no entry)")
    args = parser.parse_args(argv)

    from sptag_tpu_torch.utils import roofline

    if args.probe:
        cap = roofline.capability(probe=True)
        print("\n".join(render_peaks(capability_dict(cap))))
        return 0
    if args.source is None:
        text = sys.stdin.read()
    else:
        if not os.path.exists(args.source):
            print(f"perf_report: {args.source}: no such file",
                  file=sys.stderr)
            return 2
        with open(args.source) as f:
            text = f.read()
    print("\n".join(report_from_text(text)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
