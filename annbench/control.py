#!/usr/bin/env python3
"""The control of `correct` and a planted fault: the upper readings its
limits are set from.  The benchmark's own runs (`run.py`) never run this.

    python3 annbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--set <Parameter>=<value> ...]

runs the cell's window once per seed, all in one process.  Without
`--set`, the reference's exact search stands in the program's place, its
dot products in TF32, the precision below the float32 the configurations
state: `dist_gap` reads it.  Two faults planted in the program return
rows with their exact distances but not the nearest ones, which
`recall_miss` reads: `--set` forces index parameters over the cell's
(``--set MaxCheck=64``: the walk or the scan cut short), and
`--far-rows` replaces every answer's rows by rows drawn at random, their
distances worked out exactly and in order (a walk that never leaves its
seeds, at worst).  Every seed has to come out not correct.  Each
prints one JSON line: the seed, `correct`, and each number compared beside
its limit.  The lower readings are the program's own, which every run of
`run.py` prints.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def far_rows(build, seed: int = 0):
    """`build` with every answer's rows replaced by rows drawn at random,
    each with its exact float32 distance, in ascending order."""
    import torch

    from annbench import reference
    from annbench.session import Built

    def broken_build(config, traffic, corpus, device):
        built = build(config, traffic, corpus, device)
        metric, k = config["distance"], int(config["k"])
        x = reference.prepare(corpus, metric, device)
        rng = np.random.default_rng(seed)

        def search(queries):
            built.search(queries)
            q = reference.prepare(queries, metric, device)
            # k distinct rows a query, spread over the corpus
            base = rng.integers(0, len(x), len(q))
            ids = (base[:, None] + np.arange(k) * (len(x) // k)) % len(x)
            ids_t = torch.from_numpy(ids).to(device)
            rows = x[ids_t]
            if metric == "Cosine":
                d = 1.0 - (q[:, None, :] * rows).sum(-1)
            else:
                d = ((q[:, None, :] - rows) ** 2).sum(-1)
            d, order = torch.sort(d, dim=1)
            ids_t = torch.gather(ids_t, 1, order)
            return d.cpu().numpy(), ids_t.to(torch.int32).cpu().numpy()

        return Built(search=search, build_s=built.build_s, guard=built.guard)

    return broken_build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--set", nargs="+", default=[],
                    metavar="PARAMETER=VALUE")
    ap.add_argument("--far-rows", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from annbench import program, session, spec

    if not torch.cuda.is_available():
        print("annbench: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    forced = dict(kv.split("=", 1) for kv in args.set)
    build = session.build_control
    if forced:
        def build(config, traffic, corpus, device):
            traffic = dict(traffic, index_params=dict(
                traffic.get("index_params", {}), **forced))
            return program.build(config, traffic, corpus, device)
    if args.far_rows:
        build = far_rows(program.build)
    for seed in args.seeds:
        result = session.run(cell, seed, args.seconds, False,
                             torch.device("cuda", 0), time.perf_counter(),
                             build)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "forced": forced, "far_rows": args.far_rows,
                          "correct": result["correct"],
                          "judged_rows": result["judged_rows"],
                          "metrics": result["metrics"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
