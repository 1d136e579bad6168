#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this machine holds.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics are found by name (`spec.py`).  The run makes its
corpus and query set from the seed, builds the index through the port's
normal path, warms up the cell's shapes, drives the closed loop for
`--seconds`, judges every answer against the plain reference and prints
one JSON object as the last line of standard output: the end-to-end
metrics with `--trace 0`, the per-layer ones (from a `torch.profiler`
window at the start of the loop) with `--trace 1`.  The numbers compared
for `correct` are printed beside their limits as the last lines of
standard error and under the result's last key, `checks`.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when the JAX package, `jax`, `jaxlib` or
`flax` is loaded in the process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sptag_tpu"})
# the card's name and power limit, read beside every run
SMI = ("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Every cache at a fixed path in the checkout or under TMPDIR."""
    cache = os.path.join(ROOT, ".annbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["SPTAG_TPU_ROOFLINE_CACHE"] = os.path.join(
        tempfile.gettempdir(), "annbench_roofline")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(SMI, capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e!r})"
    return out.stdout.strip() or f"unread (exit {out.returncode})"


def finite(obj):
    """JSON-safe copy: a non-finite float becomes its name as a string."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_dirs()
    import torch

    from annbench import judge, program, session, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("annbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"annbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = session.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START, program.build)
    card = card_line()
    print(f"annbench card: {card}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"annbench: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    result["card"] = card
    result["checks"] = result.pop("checks")     # the last key
    for line in judge.limits_line(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, leads the import path: the
    # benchmark is the package `annbench`, the port `sptag_tpu_torch`
    sys.path[0] = ROOT
    sys.exit(main())
