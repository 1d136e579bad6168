#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (sptag_tpu_torch) on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sptag_tpu_torch/csrc`` (first use), drives
the port's BKT dense path, its BKT graph path (RNG graph build, beam walk)
and FLAT through their public entry points at the repository's headline
size, checks what comes out, and compares every kernel with its plain
PyTorch version.  Each phase prints one JSON line;
any failure exits non-zero.  Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.

Phases, in the order they run:

0. environment: ``nvidia-smi`` name and power limit, versions, sm_90 check;
1. build the kernels;
3. f32 headline: BKT Float L2, BuildGraph=0, BKTKmeansK=32, MaxCheck=2048,
   n=200,000 x d=128 (seed 7); 4,096 queries in batches of 1,024 through
   ``probe_block_dots``; then the same queries in one grouped call
   (DenseQueryGroup=8) through ``group_block_dots``; recall@10 held to
   ``F32_RECALL`` within ``RECALL_SLACK``;
4. int8: BKT Int8 cosine, n=50,000, 2,048 queries with DenseQueryGroup=32,
   DenseUnionFactor=4 through ``group_block_dots``; then ungrouped in
   batches of 1,024 through ``probe_block_dots``; both recall@10 held to
   ``INT8_RECALL`` within ``RECALL_SLACK``;
5. persistence: save_index, load_index, the first 1,024 queries again;
2. every kernel against its plain version on the card, on the main path's
   own blocks and block ids, and on the arguments of the first block-dot
   call of each graph build (phases 7 and 7b), all run last so their
   launches stay out of the paths' counts, with its time, the plain
   version's, one PyTorch
   call's (``library_ms``) and the card's bound for the same work; every
   row also counts the blocks the block-major kernel reads
   (``block_reads``: tiles of at most ``TILE_ENTRIES`` entries, from the
   ids on the host and from the CUDA prep's tile table) beside the distinct
   blocks and a probe-major design's reads, and times the entry-list prep
   alone (``prep_ms_back_to_back``);
7. f32 graph headline: the same corpus and queries, BKT with the RNG graph
   (``BuildGraph=1``) at ``bench.py``'s graph parameters; the build's stage
   seconds and block-dot launches, mean degree and orphans; beam search in
   batches of 1,024 with ``BinnedTopK`` off and on, the exact walk's
   recall@10 held inside ``BEAM_RECALL_BAND`` and the binned walk's within
   0.01 of it; save, load, the same ids;
7b. int8 cosine graph: the phase-4 corpus built with the graph and the
   library's ``FinalRefineSearchMode=beam`` (the walk runs inside the
   build), then beam search of its 2,048 queries, recall@10 held to
   ``INT8_BEAM_RECALL_MIN``;
8. FLAT over the phase-3 corpus: exact ids and distances against the exact
   truth, ``ApproxTopK`` and ``BinnedTopK`` recall, and the graph index's
   ``exact_search_batch`` against the same truth;
6. where a search batch's time goes: ``torch.profiler`` device time by
   kernel for one batch of each configuration (f32 per-query and grouped,
   int8 grouped and per-query, f32 beam exact and binned), against its
   untraced time; the beam rows per walk iteration.

Launch counts are zeroed just before phase 3 and read just after phase 5,
and zeroed again before each graph build of phases 7 and 7b and read after
it (the beam walk and FLAT launch no hand-written kernel).
Each query set is searched ``PASSES`` times over for its batch times; the
QPS and batch percentiles are smoke readings of that window, not a
benchmark.  Phase 2's ``ms``, ``plain_ms`` and ``library_ms`` are each the
median of single calls between two CUDA events, the caller's host time up
to the launch included.  Its rows also give ``ms_back_to_back`` and
``library_ms_back_to_back``, the time per call of ``BACK_TO_BACK`` calls
queued between two events (host time hidden where the card is the slower),
``host_ms``, the wrapper's host time per call in such a run, and
``device_ms``, the card's own time per call from ``torch.profiler`` (the
prep and scoring kernels of ``BACK_TO_BACK`` calls, by kernel in
``device_ms_by_kernel``): where the card outruns the host, back to back
reads the host and only ``device_ms`` shows the kernels.  The
second-to-last JSON line before the card's name gives the script's own
wall time (``wall_s``).
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 outside
# the tensor cores, int8 tensor-core ops
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "i8": 1979e12}
K = 10
PASSES = 16          # timed passes over each query set
# recall@10 of the f32 headline (per-query, grouped G=8) on the H100 with
# the earlier probe-major and group-major kernels; the block-major kernel
# must not move it by more than RECALL_SLACK
F32_RECALL = {"per_query": 0.9675, "grouped": 0.9554}
# recall@10 of the int8 configuration (grouped G=32, ungrouped) on the H100
# with the earlier dp4a int8 kernels; int8 dots are exact, so the
# block-major kernel must give the same within RECALL_SLACK
INT8_RECALL = {"grouped": 0.9845, "ungrouped": 0.9822}
RECALL_SLACK = 0.002


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


FAILED_CHECKS = []


def check(ok: bool, msg: str) -> None:
    """A failed check is reported at once and fails the run at its end,
    after every phase has run (one call shows every fault)."""
    if not ok:
        print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr,
              flush=True)
        FAILED_CHECKS.append(msg)


def make_dataset(n=200_000, d=128, nq=1000, seed=7, dtype=np.float32):
    """The repository benchmark's clustered corpus (bench.py make_dataset)."""
    rng = np.random.default_rng(seed)
    n_clusters = 256
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, n)
    data = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    queries = (centers[rng.integers(0, n_clusters, nq)]
               + rng.standard_normal((nq, d)).astype(np.float32))
    if dtype == np.int8:
        def toi8(x):
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                               1e-9)
            return np.clip(np.round(x * 127.0), -128, 127).astype(np.int8)
        return toi8(data), toi8(queries)
    return data, queries


def recall_at_k(ids: np.ndarray, truth: np.ndarray, k: int = K) -> float:
    return float(np.mean([len(set(a[:k].tolist()) & set(t[:k].tolist())) / k
                          for a, t in zip(ids, truth)]))


def exact_truth(dist_ops, rows: torch.Tensor, queries: torch.Tensor,
                cosine_base: int = 0, with_dists: bool = False):
    """Exact top-K on the card: chunked matrix product + stable top-k.
    L2 in float32; integer cosine as exact ``base^2 - dot`` (float64).
    The ids, or (ids, distances)."""
    out, dists = [], []
    if cosine_base:
        xr = rows.double()
    else:
        xr = rows.float()
        xn = (xr * xr).sum(1)
    for lo in range(0, queries.shape[0], 512):
        q = queries[lo:lo + 512]
        if cosine_base:
            d = cosine_base * cosine_base - q.double() @ xr.T
        else:
            qf = q.float()
            d = (qf * qf).sum(1)[:, None] + xn[None, :] - 2.0 * (qf @ xr.T)
        v, i = dist_ops.smallest_k(d, K)
        out.append(i.cpu().numpy())
        dists.append(v.cpu().numpy())
    if with_dists:
        return np.concatenate(out), np.concatenate(dists)
    return np.concatenate(out)


# bench.py's graph parameters (_GRAPH_PARAMS), and the BKT knobs of its
# headline (_bkt_params)
GRAPH_PARAMS = [("BKTNumber", "1"), ("BKTKmeansK", "32"),
                ("TPTNumber", "8"), ("TPTLeafSize", "1000"),
                ("NeighborhoodSize", "32"), ("CEF", "256"),
                ("MaxCheckForRefineGraph", "512"), ("RefineIterations", "2"),
                ("MaxCheck", "2048"), ("RefineQueryGroup", "32"),
                ("FinalRefineSearchMode", "same")]
BEAM_PASSES = 2      # timed passes over each beam query set
# recall@10 of the JAX package's beam walk on the bench graph (BENCH_r07.json:
# CPU, 512 queries, the same graph parameters): exact walk, binned walk
JAX_BEAM_RECALL = {"off": 0.8955, "on": 0.8906}
# the port's exact-walk recall@10 over the 4,096 queries must lie inside
# this band.  The port draws its own k-means restarts, so its forest, its
# refine partition, its pivots and its graph are not the JAX package's;
# the same build over forest seeds 42 / 1 / 2 walked to 0.9230 / 0.8879 /
# 0.9386 on the H100 (PERF.md), with the JAX package's 0.8955 inside that
# spread.  The band is that spread widened by about 0.01 on each side
BEAM_RECALL_BAND = (0.875, 0.945)
# the int8 graph (phase 7b) walked to 0.9962 on the H100 (PERF.md)
INT8_BEAM_RECALL_MIN = 0.98


def timed_batches(index, queries, batch, passes: int = PASSES):
    """Search `queries` in batches, `passes` times over; the ids of the
    first pass and every batch's wall time."""
    ids, times = [], []
    for rep in range(passes):
        for lo in range(0, len(queries), batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, i = index.search_batch(queries[lo:lo + batch], K)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if rep == 0:
                ids.append(i)
    return np.concatenate(ids), times


def batch_stats(times, batch):
    """Smoke readings over the timed batches, not a benchmark."""
    ms = sorted(t * 1e3 for t in times)
    return {"batches": len(ms), "qps": batch * len(ms) / sum(times),
            "batch_ms_p50": statistics.median(ms),
            "batch_ms_p99": float(np.percentile(ms, 99))}


BACK_TO_BACK = 10


def separated_ids_equal(ids, truth_ids, truth_d, tol) -> int:
    """Count of result slots whose id differs from the truth's at a rank
    whose truth distance is farther than `tol` from both neighbours' (a
    near tie may fall either way under another summation order)."""
    gap = np.diff(truth_d, axis=1) > tol
    sep = np.ones(truth_d.shape, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    return int((ids[sep] != truth_ids[sep]).sum())


class FirstCalls:
    """Inside the ``with`` block, records the arguments of the first call
    of each block-dot wrapper per value type, keyed (kernel, "f32"/"i8"),
    so that phase 2 can hold the kernels against their plain versions at
    the shapes a graph build gives them.  The wrappers run unchanged and
    count their launches as always."""

    KINDS = ("probe_block_dots", "group_block_dots")

    def __init__(self, module):
        self.module, self.args, self.saved = module, {}, {}

    def __enter__(self):
        for kind in self.KINDS:
            fn = self.saved[kind] = getattr(self.module, kind)

            def wrapper(blocks, queries, ids, *a, _fn=fn, _kind=kind, **kw):
                t = "i8" if blocks.dtype == torch.int8 else "f32"
                if (_kind, t) not in self.args:
                    self.args[_kind, t] = (blocks, queries.clone(),
                                           ids.clone())
                return _fn(blocks, queries, ids, *a, **kw)
            setattr(self.module, kind, wrapper)
        return self

    def __exit__(self, *exc):
        for kind, fn in self.saved.items():
            setattr(self.module, kind, fn)


def median_ms(fn, reps: int = 30, calls: int = 1) -> float:
    """Median over `reps` event pairs of the time per call, `calls` calls
    queued between the two events (1: a single call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    return statistics.median(ts)


def device_ms(fn, calls: int = BACK_TO_BACK):
    """The card's own time per call from ``torch.profiler``: device time of
    every CUDA kernel and copy over `calls` calls, divided by `calls`, in
    total and by kernel name (host time left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    return sum(rows.values()) or None, rows


def host_ms(fn, reps: int = 30, calls: int = BACK_TO_BACK) -> float:
    """Median over `reps` runs of the host's wall time per call of `calls`
    calls queued without waiting for the card."""
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ts.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return statistics.median(ts)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sptag_tpu_torch")):
        fail("run from a checkout of the repository (sptag_tpu_torch/ "
             "is missing)")
    import sptag_tpu_torch as pt
    from sptag_tpu_torch import _build
    from sptag_tpu_torch.algo import dense
    from sptag_tpu_torch.ops import block_dots
    from sptag_tpu_torch.ops import distance as dist_ops

    # ---- phase 0: environment ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": 0, "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(cap),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    if tuple(cap) != (9, 0):
        fail(f"needs compute capability 9.0 (Hopper), got {cap}")
    dev = torch.device("cuda")

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    so, nvcc_s = _build.build("block_dots")
    block_dots.library()
    log = _build.build_log.get("block_dots", "")
    emit({"phase": 1, "library": os.path.relpath(so, here),
          "build_s": time.perf_counter() - t0, "nvcc_s": nvcc_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # ---- main path ----------------------------------------------------------
    block_dots.reset_launch_counts()

    # phase 3: f32 headline
    data, queries = make_dataset(n=200_000, nq=4096, seed=7)
    idx = pt.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2"), ("BuildGraph", "0"),
                        ("BKTNumber", "1"), ("BKTKmeansK", "32"),
                        ("MaxCheck", "2048")]:
        if not idx.set_parameter(name, value):
            fail(f"set_parameter {name}")
    t0 = time.perf_counter()
    idx.build(data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.search_batch(queries[:1024], K)            # materializes the layout
    first_s = time.perf_counter() - t0
    before = block_dots.probe_f32_launches
    ids_f32, times = timed_batches(idx, queries, 1024)
    probe_runs = block_dots.probe_f32_launches - before
    sf = idx._get_dense()
    truth_f32 = exact_truth(dist_ops, torch.from_numpy(data).to(dev),
                            torch.from_numpy(queries).to(dev))
    recall = recall_at_k(ids_f32, truth_f32)
    emit({"phase": 3, "n": len(data), "d": data.shape[1], "build_s": build_s,
          "first_batch_s": first_s, **batch_stats(times, 1024),
          "recall_at_10": recall, "P": sf.cluster_size,
          "C": sf.num_clusters, "probe_launches": probe_runs})
    check(probe_runs >= 4,
          f"probe_block_dots launched {probe_runs} < 4 times")
    check(recall >= 0.95
          and abs(recall - F32_RECALL["per_query"]) <= RECALL_SLACK,
          f"f32 recall@10 {recall}: below 0.95 or more than "
          f"{RECALL_SLACK} from {F32_RECALL['per_query']}")

    idx.set_parameter("DenseQueryGroup", "8")
    idx.search_batch(queries, K)                   # first grouped call
    before = block_dots.group_f32_launches
    ids_g, times_g = timed_batches(idx, queries, len(queries))
    g_f32 = idx.last_effective_group
    recall_g = recall_at_k(ids_g, truth_f32)
    emit({"phase": "3b", "group": g_f32, **batch_stats(times_g, len(queries)),
          "recall_at_10": recall_g,
          "group_launches": block_dots.group_f32_launches - before})
    idx.set_parameter("DenseQueryGroup", "0")
    check(g_f32 == 8 and recall_g >= 0.95
          and abs(recall_g - F32_RECALL["grouped"]) <= RECALL_SLACK,
          f"f32 grouped: group {g_f32}, recall {recall_g} (held to "
          f"{F32_RECALL['grouped']} +- {RECALL_SLACK})")

    # phase 4: int8 grouped
    data8, queries8 = make_dataset(n=50_000, nq=2048, seed=7, dtype=np.int8)
    idx8 = pt.create_instance("BKT", "Int8")
    for name, value in [("DistCalcMethod", "Cosine"), ("BuildGraph", "0"),
                        ("BKTNumber", "1"), ("BKTKmeansK", "32"),
                        ("MaxCheck", "2048"), ("DenseQueryGroup", "32"),
                        ("DenseUnionFactor", "4")]:
        if not idx8.set_parameter(name, value):
            fail(f"set_parameter {name}")
    t0 = time.perf_counter()
    idx8.build(data8)
    build8_s = time.perf_counter() - t0
    idx8.search_batch(queries8, K)                 # materializes the layout
    before = block_dots.group_i8_launches
    ids8, times8 = timed_batches(idx8, queries8, len(queries8))
    group_runs = block_dots.group_i8_launches - before
    g_i8 = idx8.last_effective_group
    s8 = idx8._get_dense()
    truth8 = exact_truth(dist_ops, torch.from_numpy(idx8._host).to(dev),
                         torch.from_numpy(idx8._prepare_query(queries8))
                         .to(dev), cosine_base=127)
    recall8 = recall_at_k(ids8, truth8)
    idx8.set_parameter("DenseQueryGroup", "0")
    idx8.search_batch(queries8[:1024], K)          # first ungrouped call
    before = block_dots.probe_i8_launches
    ids8p, times8p = timed_batches(idx8, queries8, 1024)
    recall8p = recall_at_k(ids8p, truth8)
    emit({"phase": 4, "n": len(data8), "build_s": build8_s, "group": g_i8,
          **batch_stats(times8, len(queries8)), "recall_at_10": recall8,
          "group_launches": group_runs, "P": s8.cluster_size,
          "C": s8.num_clusters, "ungrouped": {
              **batch_stats(times8p, 1024),
              "recall_at_10": recall8p,
              "probe_launches": block_dots.probe_i8_launches - before}})
    check(g_i8 == 32 and group_runs >= 2,
          f"int8 grouped: group {g_i8}, launches {group_runs}")
    for name, r in (("grouped", recall8), ("ungrouped", recall8p)):
        check(r >= 0.97 and abs(r - INT8_RECALL[name]) <= RECALL_SLACK,
              f"int8 {name} recall@10 {r}: below 0.97 or more than "
              f"{RECALL_SLACK} from {INT8_RECALL[name]}")

    # phase 5: persistence
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "bkt_f32")
        t0 = time.perf_counter()
        if idx.save_index(folder) != pt.ErrorCode.Success:
            fail("save_index")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = pt.load_index(folder)
        load_s = time.perf_counter() - t0
        _, ids_l = loaded.search_batch(queries[:1024], K)
    same = bool(np.array_equal(ids_l, ids_f32[:1024]))
    emit({"phase": 5, "save_s": save_s, "load_s": load_s, "ids_equal": same})
    check(same, "ids differ after save -> load")
    launches = block_dots.launch_counts()
    emit({"phase": "main_path_launches", **launches})
    missing = [k for k, v in launches.items() if v < 1]
    check(not missing,
          f"kernels not launched on the main path: {missing}")

    # ---- phase 7: f32 graph headline (the graph slice's main path) ----------
    # the bench's headline index with its graph: BuildGraph=1 (default),
    # refine searches through the dense scan's grouped kernel
    block_dots.reset_launch_counts()
    gidx = pt.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2")] + GRAPH_PARAMS:
        if not gidx.set_parameter(name, value):
            fail(f"set_parameter {name}")
    t0 = time.perf_counter()
    with FirstCalls(block_dots) as first7:
        gidx.build(data)
        torch.cuda.synchronize()
    gbuild_s = time.perf_counter() - t0
    build_launches = block_dots.launch_counts()
    graph = gidx._graph
    indeg = np.bincount(graph[graph >= 0].ravel(), minlength=len(graph))
    gidx.set_parameter("SearchMode", "beam")
    beam = {}
    for binned in ("off", "on"):
        gidx.set_parameter("BinnedTopK", binned)
        gidx.search_batch(queries[:1024], K)            # builds the engine
        ids_b, times_b = timed_batches(gidx, queries, 1024, BEAM_PASSES)
        eng = gidx._get_engine()
        beam[binned] = {"recall_at_10": recall_at_k(ids_b, truth_f32),
                        # the JAX package's bench sampled the first 512
                        "recall_at_10_first_512": recall_at_k(
                            ids_b[:512], truth_f32[:512]),
                        **batch_stats(times_b, 1024),
                        "iterations_last_batch": eng.last_iterations,
                        "ids": ids_b, "times": times_b}
    walk = eng.walk_plan(K, 2048, 16, None, 3)
    emit({"phase": 7, "n": len(data), "d": data.shape[1],
          "build_s": gbuild_s, "build_stages_s": gidx.build_stages,
          "build_launches": build_launches,
          "mean_degree": float((graph >= 0).sum(1).mean()),
          "zero_in_degree": int((indeg == 0).sum()),
          "pivots": int(eng.pivot_ids.shape[0]),
          "walk_plan": dict(zip(("k_eff", "L", "B", "T", "nbp_limit"),
                                walk)),
          "beam": {b: {k: v for k, v in r.items() if k not in ("ids",
                                                                "times")}
                   for b, r in beam.items()},
          "jax_beam_recall": JAX_BEAM_RECALL,
          "beam_recall_band": BEAM_RECALL_BAND})
    if build_launches["group_block_dots_f32"] \
            + build_launches["probe_block_dots_f32"] < 1:
        fail(f"the graph build launched no f32 block-dot kernel: "
             f"{build_launches}")
    r_off, r_on = beam["off"]["recall_at_10"], beam["on"]["recall_at_10"]
    # on one folder the two packages' walks agree id for id
    # (tests/test_torch_bkt.py); the band covers the port's own forest
    lo, hi = BEAM_RECALL_BAND
    check(lo <= r_off <= hi,
          f"beam recall@10 {r_off} outside [{lo}, {hi}]")
    check(abs(r_on - r_off) <= 0.01,
          f"binned beam recall@10 {r_on} more than 0.01 from the exact "
          f"walk's {r_off}")
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "bkt_graph")
        if gidx.save_index(folder) != pt.ErrorCode.Success:
            fail("save_index (graph)")
        _, ids_gl = pt.load_index(folder).search_batch(queries[:1024], K)
    same = bool(np.array_equal(ids_gl, beam["on"]["ids"][:1024]))
    emit({"phase": "7_persistence", "ids_equal": same})
    check(same, "beam ids differ after save -> load")

    # phase 7b: int8 cosine graph, the final refine pass through the walk
    block_dots.reset_launch_counts()
    gidx8 = pt.create_instance("BKT", "Int8")
    for name, value in [("DistCalcMethod", "Cosine")] + GRAPH_PARAMS[:-1]:
        if not gidx8.set_parameter(name, value):
            fail(f"set_parameter {name}")
    t0 = time.perf_counter()
    with FirstCalls(block_dots) as first7b:
        gidx8.build(data8)
        torch.cuda.synchronize()
    gbuild8_s = time.perf_counter() - t0
    build8_launches = block_dots.launch_counts()
    gidx8.set_parameter("SearchMode", "beam")
    gidx8.search_batch(queries8[:1024], K)
    ids8b, times8b = timed_batches(gidx8, queries8, 1024, BEAM_PASSES)
    recall8b = recall_at_k(ids8b, truth8)
    emit({"phase": "7b", "n": len(data8), "build_s": gbuild8_s,
          "build_stages_s": gidx8.build_stages,
          "build_launches": build8_launches,
          "final_refine_search_mode": gidx8.get_parameter(
              "FinalRefineSearchMode"),
          "mean_degree": float((gidx8._graph >= 0).sum(1).mean()),
          "recall_at_10": recall8b, **batch_stats(times8b, 1024)})
    if build8_launches["group_block_dots_i8"] \
            + build8_launches["probe_block_dots_i8"] < 1:
        fail(f"the int8 graph build launched no int8 block-dot kernel: "
             f"{build8_launches}")
    check(recall8b >= INT8_BEAM_RECALL_MIN,
          f"int8 beam recall@10 {recall8b} below {INT8_BEAM_RECALL_MIN}")

    # ---- phase 8: FLAT over the phase-3 corpus ------------------------------
    flat = pt.create_instance("FLAT", "Float")
    flat.set_parameter("DistCalcMethod", "L2")
    flat.build(data)
    q1k = queries[:1024]
    truth_ids, truth_d = exact_truth(
        dist_ops, torch.from_numpy(data).to(dev),
        torch.from_numpy(q1k).to(dev), with_dists=True)
    d_flat, ids_flat, times_flat = None, None, []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_flat, ids_flat = flat.search_batch(q1k, K)
        torch.cuda.synchronize()
        times_flat.append(time.perf_counter() - t0)
    x = data.astype(np.float64)[ids_flat]
    qd = q1k.astype(np.float64)[:, None, :]
    exact_d = ((qd - x) ** 2).sum(-1)
    bound = 1e-5 * ((qd * qd).sum(-1) + (x * x).sum(-1)
                    + 2 * np.abs(qd * x).sum(-1))
    dist_ok = bool((np.abs(d_flat - exact_d) <= bound).all())
    id_tol = 2e-5 * float(np.abs(truth_d).max())
    flat_diff = separated_ids_equal(ids_flat, truth_ids, truth_d, id_tol)
    knobs = {}
    for name, value in (("ApproxTopK", "true"), ("BinnedTopK", "on")):
        flat.set_parameter(name, value)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, ids_k = flat.search_batch(q1k, K)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        knobs[name] = {"recall_at_10": recall_at_k(ids_k, truth_ids),
                       "batch_ms_p50": statistics.median(ts) * 1e3}
        flat.set_parameter(name, "false" if name == "ApproxTopK" else "off")
    _, ids_gx = gidx.exact_search_batch(q1k, K)
    graph_diff = separated_ids_equal(ids_gx, truth_ids, truth_d, id_tol)
    emit({"phase": 8, "n": len(data), "queries": len(q1k),
          "batch_ms_p50": statistics.median(times_flat) * 1e3,
          "recall_at_10": recall_at_k(ids_flat, truth_ids),
          "ids_equal_truth": bool(np.array_equal(ids_flat, truth_ids)),
          "ids_differing_at_separated_ranks": flat_diff,
          "distances_within_f32_bound": dist_ok, **knobs,
          "graph_exact_search_differing_at_separated_ranks": graph_diff})
    check(not flat_diff and dist_ok and not graph_diff,
          f"FLAT exact search: {flat_diff} ids off the truth, distances "
          f"within bound {dist_ok}; graph index exact search: "
          f"{graph_diff} ids off")

    # ---- phase 2: kernels against their plain versions ---------------------
    q32 = torch.from_numpy(idx._prepare_query(queries[:1024])).to(dev)
    q8 = torch.from_numpy(idx8._prepare_query(queries8[:1024])).to(dev)

    def nprobe_of(s):
        return int(np.clip(-(-2048 // s.cluster_size), 1, s.num_clusters))

    def probe_inputs(s, q):
        _, topc = dense.probe_choice(q, s.centroids, s.cent_sq,
                                     int(s.metric), nprobe_of(s))
        return q, topc.to(torch.int32).contiguous()

    def group_inputs(s, q, G, uf):
        npb = nprobe_of(s)
        U = min(uf * npb, s.num_clusters, G * npb)
        order, _, union = dense.group_union(
            q, s.centroids, s.cent_sq, q.shape[0], npb, U, G, int(s.metric))
        return (q[order].contiguous(),
                torch.clamp_min(union, 0).to(torch.int32).contiguous())

    rows = []
    # (kernel, type, path, its launches on that path, blocks, queries, ids):
    # the dense main path's shapes, then each graph build's first call
    cases = [
        ("probe_block_dots", "f32", "dense", launches, sf.data_perm,
         *probe_inputs(sf, q32)),
        ("probe_block_dots", "i8", "dense", launches, s8.data_perm,
         *probe_inputs(s8, q8)),
        ("group_block_dots", "i8", "dense", launches, s8.data_perm,
         *group_inputs(s8, q8, 32, 4)),
        ("group_block_dots", "f32", "dense", launches, sf.data_perm,
         *group_inputs(sf, q32, 8, 2)),
    ]
    for path, first, counts in (("graph_build_f32", first7, build_launches),
                                ("graph_build_int8", first7b,
                                 build8_launches)):
        if not first.args:
            fail(f"{path}: no block-dot call recorded during the build")
        for (kind, t), args in sorted(first.args.items()):
            cases.append((kind, t, path, counts, *args))
    for kind, t, path, counts, blocks, q, ids in cases:
        fn = getattr(block_dots, kind)
        ref = getattr(block_dots, kind + "_reference")
        got = fn(blocks, q, ids)
        want = ref(blocks, q, ids)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        if t == "i8":
            ok = bool(err.max().item() == 0)
        else:
            # |kernel - plain| <= 1e-5 * sum_d |q_d x_d|, per element
            scale = ref(blocks.abs(), q.abs(), ids).double()
            ok = bool((err <= 1e-5 * scale + 1e-30).all())
        C, P, D = blocks.shape
        es = blocks.element_size()
        Q = q.shape[0]
        distinct = int(torch.unique(ids).numel())
        # blocks the block-major kernel reads: one per tile of at most
        # TILE_ENTRIES entries, from the ids on the host and from the tile
        # table the CUDA prep built on the card
        G = Q // ids.shape[0] if kind == "group_block_dots" else 1
        E = ids.numel() * G
        _, host_tiles = block_dots.block_major_prep_reference(ids.cpu(), G, C)
        _, dev_tiles, ntiles = block_dots.block_major_prep(ids, G, C)
        dev_tiles = dev_tiles[:int(ntiles.item())].cpu()
        reads = {"block_reads": int((host_tiles[:, 0] < C).sum()),
                 "block_reads_kernel": int((dev_tiles[:, 0] < C).sum()),
                 "old_design_reads": ids.numel(), "entries": E,
                 "tile_entries": block_dots.TILE_ENTRIES}
        check(reads["block_reads"] == reads["block_reads_kernel"]
              and reads["block_reads"]
              <= distinct + E / block_dots.TILE_ENTRIES,
              f"{kind} {t} reads {reads} blocks, distinct {distinct}")
        if kind == "probe_block_dots":
            npb = ids.shape[1]
            shape = {"Q": Q, "nprobe": npb, "P": P, "D": D, "C": C}
            nbytes = (distinct * P * D * es + Q * D * es + ids.numel() * 4
                      + Q * npb * P * 4)
            ops = 2.0 * Q * npb * P * D
            lib = ("qd,qjpd->qjp", q, blocks[ids.long()])
        else:
            NG, U = ids.shape
            G = Q // NG
            shape = {"NG": NG, "U": U, "G": G, "P": P, "D": D, "C": C}
            nbytes = (distinct * P * D * es + Q * D * es + ids.numel() * 4
                      + NG * U * G * P * 4)
            ops = 2.0 * NG * U * G * P * D
            lib = ("gqd,gupd->guqp", q.reshape(NG, G, D), blocks[ids.long()])
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = ops / PEAK_OPS_S[t] * 1e3
        kernel_ms = median_ms(lambda: fn(blocks, q, ids))
        card_ms, card_rows = device_ms(lambda: fn(blocks, q, ids))
        timing = {"ms_back_to_back": median_ms(lambda: fn(blocks, q, ids),
                                               calls=BACK_TO_BACK),
                  "device_ms": card_ms, "device_ms_by_kernel": card_rows,
                  "host_ms": host_ms(lambda: fn(blocks, q, ids)),
                  "prep_ms_back_to_back": median_ms(
                      lambda: block_dots.block_major_prep(ids, G, C),
                      calls=BACK_TO_BACK)}
        plain_ms = median_ms(lambda: ref(blocks, q, ids))
        # the library yardstick: one float32 einsum over the pre-gathered
        # blocks (gather and casts outside the timing).  For int8 it is
        # exact: every partial sum is an integer of magnitude at most
        # 128^2 * D = 2^21 < 2^24
        eq, a, b = lib
        if t == "i8":
            a, b = a.float(), b.float()
        library_ms = median_ms(lambda: torch.einsum(eq, a, b))
        timing["library_ms_back_to_back"] = median_ms(
            lambda: torch.einsum(eq, a, b), calls=BACK_TO_BACK)
        lib_err = float((torch.einsum(eq, a, b).double()
                         - want.double()).abs().max().item())
        del lib, a, b
        row = {"name": f"{kind}_{t}", "route": "cuda",
               "source": "sptag_tpu_torch/csrc/block_dots.cu",
               "replaces": ("sptag_tpu/ops/pallas_kernels.py:151"
                            if kind == "probe_block_dots"
                            else "sptag_tpu/ops/pallas_kernels.py:214"),
               "path": path, "launches": counts[f"{kind}_{t}"],
               "max_abs_err": float(err.max().item()), "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": library_ms}
        emit({"phase": 2, **row, **timing, "shape": shape, "distinct_blocks": distinct, **reads,
              "bytes": nbytes, "ops": ops, "within_tolerance": ok,
              "library_max_abs_err": lib_err})
        check(ok,
              f"{kind} {t} ({path}): kernel disagrees with its plain version "
              f"(max |err| {row['max_abs_err']})")
        rows.append(row)

    # ---- phase 6: where a search batch's time goes ---------------------------
    # device time from the profiler's CUDA rows (kernels and copies); the
    # idle share is against the untraced batch time of phases 3/4
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, run, untraced_ms, iterations=None):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev_rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
        top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]
        row = {"phase": 6, "call": label, "untraced_ms": untraced_ms,
               "device_ms": busy_ms or None,
               "device_idle_share": (1.0 - busy_ms / untraced_ms
                                     if busy_ms else None),
               "device_launches": sum(e.count for e in dev_rows),
               "top_device": [[e.key[:80], e.self_device_time_total / 1e3,
                               e.count] for e in top]}
        if iterations is not None:
            # the walk's iterations in this call: the untraced batch time
            # and the card's time and launches per iteration (seeding and
            # finalize included)
            its = iterations()
            row.update({"walk_iterations": its,
                        "untraced_ms_per_iteration": untraced_ms / its,
                        "device_ms_per_iteration": busy_ms / its,
                        "launches_per_iteration":
                            row["device_launches"] / its})
        emit(row)

    breakdown("f32 per-query, 1024 queries",
              lambda: idx.search_batch(queries[:1024], K),
              batch_stats(times, 1024)["batch_ms_p50"])
    idx.set_parameter("DenseQueryGroup", "8")
    breakdown("f32 grouped G=8, 4096 queries",
              lambda: idx.search_batch(queries, K),
              batch_stats(times_g, len(queries))["batch_ms_p50"])
    idx8.set_parameter("DenseQueryGroup", "32")
    breakdown("int8 grouped G=32, 2048 queries",
              lambda: idx8.search_batch(queries8, K),
              batch_stats(times8, len(queries8))["batch_ms_p50"])
    idx8.set_parameter("DenseQueryGroup", "0")
    breakdown("int8 per-query, 1024 queries",
              lambda: idx8.search_batch(queries8[:1024], K),
              batch_stats(times8p, 1024)["batch_ms_p50"])
    for binned in ("off", "on"):
        gidx.set_parameter("BinnedTopK", binned)
        breakdown(f"f32 beam BinnedTopK={binned}, 1024 queries",
                  lambda: gidx.search_batch(queries[:1024], K),
                  beam[binned]["batch_ms_p50"],
                  iterations=lambda: gidx._get_engine().last_iterations)

    if FAILED_CHECKS:
        fail(f"{len(FAILED_CHECKS)} check(s) failed: {FAILED_CHECKS}")
    emit({"phase": "end", "wall_s": time.perf_counter() - T_START})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
