"""Time the one-card beam paths of two checkouts of the port, in turns.

    python3 tools/one_card_beam_ab.py --trees PARENT_DIR CHANGE_DIR \
        [--rows 200000] [--workdir DIR]

Each tree is a checkout holding ``sptag_tpu_torch/`` (for instance a
``git archive`` of the parent commit unpacked into a git-ignored
directory, and the working tree).  The first tree builds, on ``cuda:0``,
one BKT graph index and one 2-shard mesh folder over the same rows
(``chip_smoke.make_dataset`` at seed 7, chip_smoke's ``GRAPH_PARAMS``) and
saves them.  Then one worker process a tree loads them onto ``cuda:0``
(``--device``; ``cpu`` rehearses the script at a small ``--rows`` and
``--batch``), in the order A, B, B, A, and times the one-card paths:

* ``beam_off`` / ``beam_on``: ``search_batch`` over batches of 1,024
  (``--batch``; BinnedTopK off / on), chip_smoke phase 7's path;
* ``replayed_q4``: lone chunks of 4 queries, each one replay of the
  engine's whole-walk CUDA graph (phase 9's graph replay);
* ``segmented``: batches of 1,024 with BeamSegmentIters=8;
* ``scheduler``: 1,024 queries through ContinuousBatching (the slot
  scheduler; phase 15b's engine path);
* ``mesh_2x_one_card``: beam batches of 1,024 over the 2-shard mesh on
  ``[cuda:0, cuda:0]`` (phase 15c's path).

Each worker prints one JSON line; the last line holds every reading's
median by tree.  Compare two trees only within one run: the card's clocks
and the host's load differ between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = r"""
import json, os, statistics, sys, time
import numpy as np
import torch
tree, work, role, dev = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
BATCH = int(sys.argv[5])
sys.path.insert(0, tree)
if dev == "cpu":
    torch.set_num_threads(1)
    torch.cuda.synchronize = lambda *a: None
import sptag_tpu_torch as pt
from sptag_tpu_torch.parallel import sharded
GRAPH_PARAMS = json.loads(open(os.path.join(work, "params.json")).read())
K = 10
"""

_BUILD = _COMMON + r"""
data = np.load(os.path.join(work, "data.npy"))
idx = pt.create_instance("BKT", "Float", device=dev)
for name, value in [("DistCalcMethod", "L2")] + GRAPH_PARAMS:
    assert idx.set_parameter(name, value), name
t0 = time.perf_counter()
idx.build(data)
torch.cuda.synchronize()
build_s = time.perf_counter() - t0
idx.save_index(os.path.join(work, "graph"))
t0 = time.perf_counter()
sharded.ShardedBKTIndex.build(
    data, 0, mesh=sharded.Mesh([dev, dev]),
    params=dict(GRAPH_PARAMS), save_to=os.path.join(work, "mesh2"))
torch.cuda.synchronize()
print(json.dumps({"role": "build", "tree": tree, "graph_build_s": build_s,
                  "mesh_build_s": time.perf_counter() - t0}), flush=True)
"""

_TIME = _COMMON + r"""
queries = np.load(os.path.join(work, "queries.npy"))
idx = pt.load_index(os.path.join(work, "graph"), device=dev)
idx.set_parameter("SearchMode", "beam")


def timed(fn, reps):
    fn(0)                                   # warm-up (and captures)
    fn(0)
    ms = []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(r)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def batch(r):
    lo = (r * BATCH) % (len(queries) - BATCH + 1)
    return queries[lo:lo + BATCH]


out = {"role": "time", "tree": tree}
for binned in ("off", "on"):
    idx.set_parameter("BinnedTopK", binned)
    out["beam_" + binned] = timed(lambda r: idx.search_batch(batch(r), K), 8)
idx.set_parameter("BinnedTopK", "off")
out["replayed_q4"] = timed(
    lambda r: idx.search_batch(queries[4 * r:4 * r + 4], K), 40)
idx.set_parameter("BeamSegmentIters", "8")
out["segmented"] = timed(lambda r: idx.search_batch(batch(r), K), 6)
idx.set_parameter("BeamSegmentIters", "0")
idx.set_parameter("ContinuousBatching", "1")
out["scheduler"] = timed(lambda r: idx.search_batch(batch(r), K), 6)
idx.set_parameter("ContinuousBatching", "0")
m = sharded.ShardedBKTIndex.load(
    os.path.join(work, "mesh2"), mesh=sharded.Mesh([dev, dev]))
out["mesh_2x_one_card"] = timed(lambda r: m.search(batch(r), K), 8)
ids = idx.search_batch(queries[:BATCH], K)[1]
np.save(os.path.join(work, f"ids_{role}.npy"), ids)
print(json.dumps(out), flush=True)
os._exit(0)          # the scheduler's worker thread ends with the process
"""


def run(script: str, tree: str, work: str, role: str, device: str,
        batch: int) -> dict:
    res = subprocess.run([sys.executable, "-c", script, tree, work, role,
                          device, str(batch)],
                         cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-3000:] + res.stderr[-6000:])
        raise SystemExit(f"{role} on {tree} exited {res.returncode}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("{")][-1]
    print(line, flush=True)
    return json.loads(line)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs=2, required=True,
                        metavar=("A", "B"))
    parser.add_argument("--rows", type=int, default=200_000)
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--device", default="cuda:0",
                        help="cpu rehearses the script at a small --rows "
                             "and --batch")
    args = parser.parse_args()
    import numpy as np

    sys.path.insert(0, REPO)
    import chip_smoke

    trees = [os.path.abspath(t) for t in args.trees]
    work = args.workdir or tempfile.mkdtemp(prefix="beam_ab_")
    data, queries = chip_smoke.make_dataset(n=args.rows, nq=4096, seed=7)
    np.save(os.path.join(work, "data.npy"), data)
    np.save(os.path.join(work, "queries.npy"), queries)
    with open(os.path.join(work, "params.json"), "w") as f:
        json.dump(chip_smoke.GRAPH_PARAMS, f)
    run(_BUILD, trees[0], work, "build", args.device, args.batch)
    by_tree = {t: {} for t in trees}
    for i, tree in enumerate((trees[0], trees[1], trees[1], trees[0])):
        got = run(_TIME, tree, work, f"time{i}", args.device,
                  args.batch)
        for key, ms in got.items():
            if isinstance(ms, list):
                by_tree[tree].setdefault(key, []).extend(ms)
    same = all(np.array_equal(np.load(os.path.join(work, "ids_time0.npy")),
                              np.load(os.path.join(work, f"ids_time{i}.npy")))
               for i in range(1, 4))
    print(json.dumps({
        "p50_ms": {os.path.relpath(t, REPO) if t != REPO else ".":
                   {k: statistics.median(v) for k, v in r.items()}
                   for t, r in by_tree.items()},
        "ids_equal_across_trees": same}), flush=True)


if __name__ == "__main__":
    main()
