#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (sptag_tpu_torch) on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sptag_tpu_torch/csrc`` (first use), drives
the port's BKT dense path, its BKT graph path (RNG graph build, beam walk),
FLAT, online mutation (inline and delta-shard adds, the background swap,
delete, compaction, the write-ahead log), the KDT index, the walk's bf16,
packed and segmented options, the slot scheduler, the socket search
server, the CLIs, resumable builds, the aggregator, the serving control
plane, the wrappers and the tiered corpus cascade (FLAT, dense, beam,
KDT; device, host and host_all tiers) through their public entry points
at the repository's headline sizes, checks what comes out, and compares
every kernel with its plain PyTorch version.  Each phase prints one JSON line; any failure exits non-zero.  Without a CUDA
card, or outside the repository, it exits non-zero and prints no result.

Phases, in the order they run:

0. environment: ``nvidia-smi`` name and power limit, versions, sm_90 check;
1. build the kernels (every source of ``sptag_tpu_torch/csrc`` and the
   L2 read probe, one ``nvcc`` each, started together);
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
   own blocks and block ids (the walk's fixed-order distance kernels on
   phase 7's first in-loop scoring and seeding calls and the pivots'
   norms, with the share of fresh slots), and on the arguments of the
   first block-dot call of each graph build (phases 7 and 7b), of the
   compaction's refine pass (phase 9c) and of the KDT dense search (phase
   10), all run last so their launches stay out of the paths' counts,
   with its time, the plain version's, one PyTorch call's
   (``library_ms``) and the card's bound for the same work; every
   row also counts the blocks the block-major kernel reads
   (``block_reads``: tiles of at most ``TILE_ENTRIES`` entries, from the
   ids on the host and from the CUDA prep's tile table) beside the distinct
   blocks and a probe-major design's reads, and times the entry-list prep
   alone (``prep_ms_back_to_back``); the ``walk_resident`` row holds the
   resident walk (one launch for all of a captured walk's bodies) and T
   three-launch bodies against T plain bodies at the single-query cell's
   plan on phase 7's engine, bit for bit, with the kernels' device and
   elapsed times a walk, each cluster size's (1, 2, 4, 8 CTAs a row, at
   4, 16 and 256 rows), the size the rule picks, and ptxas's registers,
   shared memory and spills, then a single query on phase 7's index
   through ``search_batch``: from its capturing call on, two resident
   launches, no body kernel, and every body walked resident;
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
9. mutation on phase 7's index, loaded from its saved folder: (a) 1,000
   rows (``make_dataset`` seed 11) added inline in batches of 100; (b)
   ``bench.py``'s mutation stage for ``MUTATE_S`` seconds
   (``DeltaShardCapacity=2048``, ``AutoRefineThreshold=128``, 3 readers,
   5 % paced writes), held to zero reader errors, every acked add found
   by its probe, at least one background swap and no deleted id returned;
   (c) 2 % of the original rows deleted by content in one call, then
   ``refine_index``: the row count drops by the deleted count, and beam and
   dense recall@10 against the exact truth over the live rows are held
   within 0.01 of a fresh build of the same live rows (its forest and
   graph equality printed); recall before the mutation, and after again
   over the same graphs under three other forest draws, are printed;
   (d) a ``WalEnabled=1`` save, 1,000 adds and 100 deletes, then
   ``load_index`` replays the log: the same rows and the same ids; between
   (a) and (b), lone searches of ``GRAPH_SWEEP_Q`` queries, the walk
   replayed as a CUDA graph against the eager walk (times, the same ids,
   at most one graph per padded size, the graphs' memory); (e) adds of
   100 rows and of one row to the dense-only headline index
   (``BuildGraph=0``): the add, the next search (which rebuilds the whole
   dense layout) and the one after it, timed;
10. KDT (``bench.py``'s ``build_headline_kdt``: 50,000 x 100 cosine,
   ``KDTNumber=2``, the graph parameters): the kd-seeded walk's and the
   dense scan's (``DenseReplicas=2``) recall@10 over 200 queries held to
   ``KDT_RECALL_MIN``, save and load, 1,000 adds and 100 deletes; the
   kd descent on the card (``ops/kd_descent.py``): the kernel's seeds
   equal to the plain version's, each (query, tree) the host descent's
   leaves, the walk seeded on the card returning the host-seeded walk's
   ids eager and replayed, single queries replayed with the descent
   inside the graph (no launch from the host) and their walk's bodies all
   resident (two resident launches, none of a body kernel), and
   ``search.kd_node_reads`` read once from the card;
6. where a search batch's time goes: ``torch.profiler`` device time by
   kernel for one batch of each configuration (f32 per-query and grouped,
   int8 grouped and per-query, f32 beam exact and binned, FLAT's cascade
   on the device and host_all tiers, the beam cascade on the device and
   host tiers), against its untraced time; the beam rows per walk
   iteration, the walk kernels' device time, and the former walk kernel's
   batch beside them;
11. the walk's options and the slot scheduler on phase 7's index: (a)
   ``BeamScoreDtype=bf16`` over the 4,096 queries, exact and binned walk,
   recall@10 held within 0.01 of the f32 walk's and every distance held
   to its id's float32 distance (the re-rank), a profile of one batch
   (gather ms, contraction ms, launches per iteration) beside f32's; (b)
   ``BeamPackedNeighbors=1`` in f32 and bf16, ids and distances held equal
   to the unpacked walk's, with ``nbr_vecs`` / ``nbr_sq`` bytes; (c)
   ``BeamSegmentIters`` = T/4, held equal to the monolithic walk; (d)
   ``ContinuousBatching=1``: 1,024 queries through ``search_batch`` and
   through ``submit_batch`` from 4 threads, ids held equal to the
   monolithic walk's; a straggler stream of 2,048 queries from 4
   submitters, MaxCheck alternating 8,192 / 16,384 (one pool), its
   submit-to-resolve p50 / p99, wall time against the monolithic walk,
   resident iterations, segment times and peak memory, held to no slot
   left live or pending and to the monolithic walk's ids; a sweep of
   scheduled batches of 1 to 1,024 queries with eager and with replayed
   segments, against the monolithic walk, ids held; phase 10's KDT index
   through the scheduler, ids held equal; (f) a ``save_index_blobs`` ->
   ``load_index_blobs`` round trip, ids held equal, and
   ``estimated_hbm_usage`` beside the engine's allocated bytes; (e) 200
   delta adds past ``AutoRefineThreshold`` with 1,024 scheduled queries
   in flight: every future resolves without error, one swap, the old
   scheduler's worker exits, the next query walks the new snapshot;
12. the socket search server (``sptag_tpu_torch.serve``) over phase 7's
   saved folder, loaded from a service INI at the JAX package's serving
   defaults (batch window 2 ms, batches of at most 1,024): (a) the
   wrapper lifecycle fixture replayed frame by frame (a FLAT index built
   on the card over the wire); (b) 1,024 single-query requests through a
   4-connection pipelined client pool, ``$searchmode:beam`` then
   ``dense``, ids held to the in-process ``search_batch`` at every
   separated rank and distances to the float32 bound, the dense half's
   ``probe_block_dots`` f32 launches counted; (c) the beam requests again
   with ``ContinuousBatching=1``, streamed in retire order, ids held; (d)
   ``bench.py``'s open-loop ramp (Zipfian keys, bursty arrivals, mixed
   options), at the walk's former CUDA-graph cache of 8 (to its first
   missed step) and then at the default (to its second), from 64 QPS
   doubling per 2 s step against the 250 ms p99 SLO, per step offered and answered QPS, p50 / p99, batch
   sizes and unanswered requests, the card's idle share over the first
   step; nothing may fail below the knee; (e) concurrent clients at
   ever-new padded sizes and budgets with ``QualitySampleRate=1`` and
   the flight recorder on: no request fails, the shadow recall printed,
   a slow-query dump holds the server's and the scheduler's events; (f) after ``stop()`` no scheduler worker, serving thread or
   new non-daemon thread is left;
13. the f32 L2 headline (phase 3's corpus) cut into two shards of 100,000
   rows at the graph parameters: (a) each shard written as a ``BIN:``
   vector file and built by ``python -m
   sptag_tpu_torch.tools.index_builder`` with no device flag (the card),
   both processes started together, and ``tools.index_searcher`` on shard
   0 with the exact top-10 of FLAT on the card as its truth file, its
   recall and ids held to an in-process ``search_batch``; (b) shard 0
   built in-process with ``checkpoint_dir``, interrupted at its first
   refine pass, resumed (``build_resumed``, graph and tree files held
   equal to (a)'s folder) and built once more uninterrupted, each timed;
   (c) two port ``SearchServer`` s (one shard each, every row's global id
   as its metadata) behind the port's aggregator with ``MergeTopK``, the
   1,024 queries through ``wrappers.AnnClient`` from 16 threads, beam
   then ``$searchmode:dense``, the merged global ids held to the
   in-process merge of the two shards' ``search_batch`` at every
   separated rank and the distances to phase 2's float32 bound, recall@10
   against the 200k exact truth, QPS and p50 / p99; (d) servers and
   aggregator again with ``AdmissionControl``, a tight p99 objective (so
   the SLO engine pages and the controller acts), canaries, the
   controller and the metrics listener, through phase 12d's ramp (4
   steps): no request fails except with admission's overload status,
   every canary probe succeeds, ``/metrics`` parses and carries the
   ``admission`` / ``slo`` / ``canary`` / ``controller`` series,
   ``/debug/memory`` names the JAX package's components within
   ``torch.cuda.memory_allocated``, and each of three
   ``/debug/devicetrace`` traces taken under load holds a walk or
   block-dot kernel event while an overlapping one answers 409; (e) ``AnnIndex`` over shard 0: ``Search`` /
   ``SearchWithMetaData`` / ``BatchSearch`` ids held to ``search_batch``,
   1,000 adds found, 100 deletes by content, a ``Save`` / ``Load`` round
   trip with the same ids; (f) every subprocess exited 0 and no serving,
   canary, listener or scheduler thread is left.  Phase 2 holds the
   block-dot kernels again on the first calls of (b)'s build and (c)'s
   dense requests, with the launches counted over (b)-(e);
14. the tiered corpus cascade (``CascadeSearch``): (a) FLAT over the
   phase-3 corpus in ``bench.py``'s five capacity configurations
   (fp_only, int8_fp, cascade, host, host_all; ``TierBudgetSketch``
   8,192, ``TierBudgetInt8`` 1,024), 4,096 queries in batches of 1,024:
   recall@10 against the exact truth held to ``CASCADE_RECALL_MIN``, QPS,
   device and host bytes off the memory ledger; the host tiers' ids and
   distance bits held equal to the device tier's, their float32 bytes
   held host-side, host_all's device bytes held to N_pad (4W + 1) + 4D
   plus 1 MB; ``SketchPrefilter`` calibrated and at ``SketchRerank``
   4,096, its ``sketch_cal.bin`` reused by a loaded index (one Hamming
   launch a chunk, the same ids); (b) the dense cascade on phase 3's
   index, device and host tiers bit for bit equal, recall held to the
   non-cascade recall - 0.1, and 8,192 queries grouped (G=32, union
   factor 4) held to the same grouping without the cascade - 0.1; (c) the
   beam cascade on phase 7's loaded folder, both tiers: recall held to
   phase 7's exact walk - 0.1, segmented and scheduled walks equal to the
   monolithic one, an id both tiers return carrying the same bits, and
   1,024 lone requests through ``SearchServer`` held to ``search_batch``;
   (d) phase 10's KDT folder, both tiers' recall held to the non-cascade
   walk's - 0.1; (e) deletes and delta-shard adds on a FLAT cascade index
   of 50,000 rows, every tier; (f) host_all FLAT at ``CAPACITY_N`` rows,
   recall against its streamed exact scan, QPS and the ledger's bytes.
   Phase 2 holds the four cascade kernels (``sketch_hamming``,
   ``int8_gather_dots``, ``walk_score_i8``, the block-dot kernels on int8
   blocks with float32 queries) on their first main-path calls of phase
   14, whose launches they report, every int8 kernel variant phase 14 ran
   (mode, epilogue, D) on its first call bit for bit, and the two int8
   gathers beside an estimate of their time were every row read from L2
   at the card's L2 read rate, which a read probe over an L2-resident
   buffer measures (past L1, so rows that hit L1 can beat it).
15. observability (device half) and the mesh: (a) the card's capability
   from ``sptag_tpu_torch.utils.roofline``'s table (whose peaks phase 2's
   bounds use), the measured probe on a fresh cache held to at most 1.05x
   each table peak, and ``tools/perf_report`` rendered from phase 2's
   rows; (b) a server over phase 7's folder with ``[Service]
   TraceSanitizer`` armed, the slot scheduler and
   ``FlightDeviceSampleRate=1``: after a warm-up, 1,024 requests with
   every family's compile budget at its warm-up count, held to 0 budget
   trips and 0 flagged transfers, the engine's roofline gauges set
   (``pct_peak`` at most 100) and a forced slow query's log line carrying
   ``gflops=`` and ``pct_peak=``; (c) phase 13c's two serve-shard folders
   as a 2-shard mesh on ``[cuda:0, cuda:0]``: beam recall at least 13c's
   merged recall - 0.01, the mesh scheduler equal to the monolithic walk
   bit for bit, the dense scan launching ``probe_block_dots`` a shard,
   the ids equal to 13c's in-process merge at every separated rank, and a
   ``MeshServe=1`` server's 256 answers equal to the mesh's
   ``search_batch``; (d) two processes on ``cuda:0`` over gloo, each
   building 2 of the 4 shards of a 50,000-row slice of the headline, equal
   to a one-process 4-shard mesh over the same shard folders.
16. the mesh across the cards (on a machine with at least 2 cards; on one
   card it prints one line saying that it did not run, and the cards it
   saw): 1,000,000 x 128 rows (``make_dataset`` seed 7) in 4 shards of
   250,000 at the graph parameters, one shard a card: (a) built with
   every shard on its card at once and saved, loaded on the cards and
   on ``[cuda:0] x 4``, exact truth from FLAT over the cards (held to one
   card's exact scan); beam (exact, binned) and dense batches of 1,024
   with ids and distance bits of the two placements held equal, beam
   recall@10 held to the band's floor, ``probe_block_dots`` f32,
   ``walk_seed_f32`` and ``walk_score_f32`` launched on every card, one
   beam batch's wall time on the cards against one card (in turns), each
   shard alone, the bytes between cards, each card's bytes and a
   per-card profile; (b) a ``MeshServe=1`` server over the cards, 1,024
   requests held to ``search_batch``, the bytes between cards per
   segment by kind (only seated queries, ``t_limit``, alive flags and
   the finalize's candidates may cross), the segment graphs captured and
   replayed on each card; (c) four processes over NCCL, one a card, each
   loading its shard of (a)'s folder: ids and bits held to (a), the
   beam batch held to at most half the one-card time, the all-gather's
   time.  ``--require-cards N`` fails the run on fewer than N cards:
   ``python3 chip_smoke.py --require-cards 4`` on a four-card machine.

Launch counts are zeroed just before phase 3 and read just after phase 5
(the walk's just before phase 7's beam searches and read after them),
and zeroed again before each graph build of phases 7 and 7b, before the
refine of phase 9c, before the dense searches of phase 10, before
phase 13b, before phase 14 and before phase 16a's searches on the
cards, and read after each (phase 13's after 13e, phase 16a's card by
card; FLAT launches no hand-written kernel but the cascade's).
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
import logging
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.perf_counter()

# the card's peaks, from sptag_tpu_torch.utils.roofline's table (phase 0):
# HBM bytes/s, float32 outside the tensor cores, int8 tensor-core ops
HBM_BYTES_S = None
PEAK_OPS_S = None
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


# the CUDA sources in sptag_tpu_torch/csrc, built in phase 1
KERNEL_SOURCES = ("block_dots", "walk_dots", "sketch_dots", "int8_dots",
                  "walk_body")

# A read kernel over an L2-resident buffer: the card's L2 -> SM read rate,
# for an estimate of a gather whose rows all come from L2 (the int8
# kernels' rows of phase 2).  A measuring tool of this script, not a
# kernel of the port.
L2_PROBE_CU = r"""
#include <cuda_runtime.h>
__global__ void l2_read(const int4* __restrict__ p, long long n, int reps,
                        int* out) {
  int acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int r = 0; r < reps; ++r) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      const int4 v = __ldcg(p + i);          // L2, not L1
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x7fffffff) out[0] = acc;     // keeps the loads
}
extern "C" int sptag_l2_read(const void* p, long long n16, int reps,
                             void* out, void* stream) {
  l2_read<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)p, n16, reps, (int*)out);
  return (int)cudaGetLastError();
}
"""
# bytes of the buffer the probe reads (a third of L2) and its passes
L2_PROBE_BYTES = 16 << 20
L2_PROBE_REPS = 64


def build_l2_probe(workdir: str) -> str:
    """nvcc the L2 read probe into `workdir`; the library's path."""
    from sptag_tpu_torch import _build

    src = os.path.join(workdir, "l2_probe.cu")
    with open(src, "w") as f:
        f.write(L2_PROBE_CU)
    so = os.path.join(workdir, "libl2_probe.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                          src], capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvcc failed on the L2 probe:\n{res.stdout}{res.stderr}")
    return so


def l2_read_gbs(so: str) -> float:
    """The card's L2 read rate in GB/s: the probe's reads of an L2-resident
    buffer, timed between CUDA events (median of 5 launches after a
    warm-up)."""
    import ctypes

    lib = ctypes.CDLL(so)
    lib.sptag_l2_read.restype = ctypes.c_int
    lib.sptag_l2_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    buf = torch.ones(L2_PROBE_BYTES // 4, dtype=torch.int32, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def run():
        rc = lib.sptag_l2_read(buf.data_ptr(), L2_PROBE_BYTES // 16,
                               L2_PROBE_REPS, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"the L2 probe did not launch ({rc})")
    ms = median_ms(run, reps=5)
    return L2_PROBE_BYTES * L2_PROBE_REPS / (ms * 1e-3) / 1e9
# the f32 dense-only headline index (phases 3 and 9e)
DENSE_PARAMS = [("DistCalcMethod", "L2"), ("BuildGraph", "0"),
                ("BKTNumber", "1"), ("BKTKmeansK", "32"), ("MaxCheck", "2048")]
# bench.py's graph parameters (_GRAPH_PARAMS), and the BKT knobs of its
# headline (_bkt_params)
GRAPH_PARAMS = [("BKTNumber", "1"), ("BKTKmeansK", "32"),
                ("TPTNumber", "8"), ("TPTLeafSize", "1000"),
                ("NeighborhoodSize", "32"), ("CEF", "256"),
                ("MaxCheckForRefineGraph", "512"), ("RefineIterations", "2"),
                ("MaxCheck", "2048"), ("RefineQueryGroup", "32"),
                ("FinalRefineSearchMode", "same")]
BEAM_PASSES = 2      # timed passes over each beam query set
# phase 6's beam batch of 1,024 with the walk's former distance kernel (one
# warp a dot, the epilogue in separate launches), on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 5), printed beside this run's
FORMER_BEAM_BATCH = {
    "off": {"untraced_ms": 44.38, "device_ms": 35.84,
            "device_launches": 3494},
    "on": {"untraced_ms": 52.96, "device_ms": 32.19,
           "device_launches": 4299}}
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


class FirstWalkDots:
    """Inside the ``with`` block, records the arguments of the walk's first
    call of each fixed-order kernel (``ops/walk_dots.py``): the seeding
    and the in-loop scoring with at least `min_q` queries, the norm helper
    on at least `min_rows` rows (the pivots' norms when an engine is
    built), for phase 2 to hold each kernel against its plain version at
    the main path's shapes.  The wrappers run unchanged and count their
    launches as always."""

    KINDS = ("walk_seed", "walk_score", "row_sqnorms")

    def __init__(self, module, min_q: int, min_rows: int = 1024):
        self.module, self.min_q, self.min_rows = module, min_q, min_rows
        self.args, self.saved = {}, {}
        # fresh and all slots of every such scoring call (device tensors:
        # counting adds no sync to the walk)
        self.slots = [0, 0]

    def __enter__(self):
        for kind in self.KINDS:
            fn = self.saved[kind] = getattr(self.module, kind)

            def wrapper(*a, _fn=fn, _kind=kind):
                rows = a[0].shape[0]
                take = a[0].dtype == torch.float32 and (
                    rows >= self.min_rows if _kind == "row_sqnorms"
                    else rows >= self.min_q) and (
                    _kind != "walk_score" or a[5] == self.module.GATHER)
                if take and _kind == "walk_score":
                    self.slots[0] = self.slots[0] + (a[2] >= 0).sum()
                    self.slots[1] += a[2].numel()
                if take and _kind not in self.args:
                    # the rows searched (a[1], the corpus or the pivots)
                    # are not copied
                    self.args[_kind] = tuple(
                        t.clone() if isinstance(t, torch.Tensor)
                        and (k != 1 or _kind == "row_sqnorms") else t
                        for k, t in enumerate(a))
                return _fn(*a)
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


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """The card's elapsed time per call with no host in the way: `calls`
    calls captured in one CUDA graph, median over `reps` replays between
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(ts)


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


# the bench's mutation stage (bench.py _mutate_measure): the delta shard,
# the background refine and swap, reader threads and a paced writer
MUTATE_S = 30.0
# chunk sizes of phase 9's graph-replay against eager-walk reading
GRAPH_SWEEP_Q = (1, 4, 16, 64, 128, 256)
MUTATE_READERS = 3
MUTATE_DELTA_CAP = 2048
MUTATE_REFINE_THRESHOLD = 128
MUTATE_WRITE_FRAC = 0.05
# recall@10 of the JAX package's KDT index on bench.py's KDT configuration
# (BENCH_r07.json: CPU, 200 queries): the kd-seeded walk, and the dense
# scan over the kd-cell partition with DenseReplicas=2
JAX_KDT_RECALL = {"beam": 0.9775, "dense": 0.9715}
KDT_RECALL_MIN = 0.96


def mutate_stream(pt, index, queries, seconds: float):
    """bench.py's mixed read/write stage: MUTATE_READERS threads search 4
    queries at a time while one writer, paced to MUTATE_WRITE_FRAC of all
    operations, adds batches of 1-8 standard-normal rows (default_rng(23))
    and deletes by content an earlier-added row in a quarter of its
    writes.  Each acked add is probed at once (staleness).  Returns the
    readings and the vectors deleted."""
    import threading

    k = K
    dim = index.feature_dim
    rng = np.random.default_rng(23)
    nq = len(queries)
    stop = threading.Event()
    errors = []
    lat_lock = threading.Lock()
    lat = []                    # (monotonic_end_ms, latency_s)
    ops = {"reads": 0, "writes": 0, "deletes": 0, "adds_rows": 0,
           "unfound_adds": 0}
    staleness_ms = []
    added_rows = []
    deleted_rows = []

    def reader(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                ix = r.integers(0, nq, 4)
                t0 = time.perf_counter()
                _, ids = index.search_batch(queries[ix], k)
                dt = time.perf_counter() - t0
                if ids.shape != (4, k):
                    raise RuntimeError(f"malformed result {ids.shape}")
                with lat_lock:
                    lat.append((time.monotonic() * 1000.0, dt))
                    ops["reads"] += 1
        except Exception as e:                           # noqa: BLE001
            errors.append(repr(e)[:300])

    def writer():
        try:
            while not stop.is_set():
                with lat_lock:
                    total = ops["reads"] + ops["writes"]
                    writes = ops["writes"]
                if total and writes / total >= MUTATE_WRITE_FRAC:
                    time.sleep(0.01)
                    continue
                if added_rows and rng.random() < 0.25:
                    vec = added_rows.pop(0)
                    index.delete(vec[None, :])
                    deleted_rows.append(vec)
                    with lat_lock:
                        ops["writes"] += 1
                        ops["deletes"] += 1
                    continue
                batch = rng.standard_normal(
                    (int(rng.integers(1, 9)), dim)).astype(np.float32)
                if index.add(batch) != pt.ErrorCode.Success:
                    raise RuntimeError("add failed")
                t_ack = time.perf_counter()
                probe = batch[0:1]
                found = False
                for _ in range(5):
                    _, pids = index.search_batch(probe, max(4, k))
                    if (pids[0] >= 0).any():
                        dd, _ = index.search_batch(probe, 1)
                        if dd[0, 0] <= 1e-3:
                            found = True
                            break
                    time.sleep(0.001)
                if found:
                    staleness_ms.append(
                        (time.perf_counter() - t_ack) * 1000.0)
                added_rows.append(batch[0])
                with lat_lock:
                    ops["writes"] += 1
                    ops["adds_rows"] += len(batch)
                    ops["unfound_adds"] += 0 if found else 1
        except Exception as e:                           # noqa: BLE001
            errors.append(repr(e)[:300])

    threads = [threading.Thread(target=reader, args=(100 + i,), daemon=True)
               for i in range(MUTATE_READERS)]
    threads.append(threading.Thread(target=writer, daemon=True))
    for _ in range(2):           # the walk's graphs: captured at a 2nd call
        index.search_batch(queries[:4], k)
        index.search_batch(queries[:1], max(4, k))
        index.search_batch(queries[:1], 1)
    base_swaps = index.mutation_state()["swap_count"]
    for t in threads:
        t.start()
    t_stage0 = time.monotonic()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    duration_s = time.monotonic() - t_stage0
    if any(t.is_alive() for t in threads):
        errors.append("a reader or the writer did not stop")
    t_wait = time.monotonic() + 60.0
    while time.monotonic() < t_wait and \
            index.mutation_state()["refine_in_flight"]:
        time.sleep(0.05)
    state = index.mutation_state()
    windows = [w for w in state["swap_windows_ms"]
               if w[1] >= t_stage0 * 1000.0]
    in_swap = [x for (t_ms, x) in lat
               if any(w0 <= t_ms <= w1 + x * 1000.0 for (w0, w1) in windows)]
    steady = [x for (t_ms, x) in lat
              if not any(w0 <= t_ms <= w1 + x * 1000.0
                         for (w0, w1) in windows)]

    def pct(vals, q):
        return float(np.percentile(vals, q)) * 1e3 if vals else None

    out = {"duration_s": duration_s,
           "read_qps": ops["reads"] / max(duration_s, 1e-9), **ops,
           "write_frac": ops["writes"] / max(ops["reads"] + ops["writes"], 1),
           "errors": errors, "acked_writes": ops["writes"],
           "swap_count": state["swap_count"] - base_swaps,
           "swap_windows": len(windows),
           "swap_ms": [w1 - w0 for (w0, w1) in windows],
           "delta_rows_end": state["delta_rows"],
           "staleness_ms_p50": (float(np.percentile(staleness_ms, 50))
                                if staleness_ms else None),
           "staleness_ms_max": max(staleness_ms) if staleness_ms else None,
           "read_p50_ms": pct([x for _, x in lat], 50),
           "read_p99_ms": pct([x for _, x in lat], 99),
           "swap_window_reads": len(in_swap),
           "swap_window_p50_ms": pct(in_swap, 50),
           "swap_window_p99_ms": pct(in_swap, 99),
           "steady_p50_ms": pct(steady, 50),
           "steady_p99_ms": pct(steady, 99)}
    return out, deleted_rows


def other_forests(index, queries, truth, seeds=(1, 2, 3)):
    """Beam recall@10 of `index`'s graph with its forest redrawn from each
    seed: the walk seeds from the forest's pivots, so this is the share of
    recall the forest's draw decides.  The index's own forest is put back."""
    forest, out = index._tree, []
    for seed in seeds:
        other = index._new_tree()
        other.build(index._host[:index._n], seed=seed)
        index._tree, index._dirty = other, True
        out.append(recall_at_k(index.search_batch(queries, K)[1], truth))
    index._tree, index._dirty = forest, True
    return out


def mutation_phase(pt, block_dots, data, folder, queries, workdir):
    """Phase 9: the f32 headline graph index (phase 7's folder, loaded)
    mutated: (a) 1,000 rows added inline in batches of 100; (b) bench.py's
    mutation stage for MUTATE_S seconds; (c) 4,000 original rows deleted
    by content in one call, then refine_index (compaction); (d) a save
    with WalEnabled=1, 1,000 adds and 100 deletes logged, load_index
    replaying the log.  Returns the first block-dot call of the
    compaction's refine pass and the launches of that refine."""
    midx = pt.load_index(folder)
    midx.set_parameter("BinnedTopK", "off")
    q1k = queries[:1024]
    n_orig = midx.num_samples
    _, truth_pre = midx.exact_search_batch(q1k, K)
    recall_pre = recall_at_k(midx.search_batch(q1k, K)[1], truth_pre)
    dense_pre = recall_at_k(
        midx.search_batch(q1k, K, search_mode="dense")[1], truth_pre)
    recall_pre_other = other_forests(midx, q1k, truth_pre)
    # (c)'s victims
    victims = np.random.default_rng(29).choice(n_orig, n_orig // 50,
                                               replace=False)

    # (a) inline add: every batch linked by one walk and an RNG re-prune
    midx.set_parameter("DeltaShardCapacity", "0")
    rows_a, _ = make_dataset(n=1000, nq=1, seed=11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(rows_a), 100):
        check(midx.add(rows_a[lo:lo + 100]) == pt.ErrorCode.Success,
              "9a: add failed")
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    new_ids = np.arange(n_orig, n_orig + len(rows_a))
    _, ids_a = midx.search_batch(rows_a, 1)
    _, ids_ax = midx.exact_search_batch(rows_a, 1)
    emit({"phase": "9a", "rows": len(rows_a), "batch": 100, "add_s": add_s,
          "rows_per_s": len(rows_a) / add_s,
          "found_by_beam": float(np.mean(ids_a[:, 0] == new_ids)),
          "found_by_exact": float(np.mean(ids_ax[:, 0] == new_ids)),
          "recall_at_10_before": recall_pre})
    check(bool((ids_ax[:, 0] == new_ids).all()),
          "9a: an added row is not its own exact nearest neighbour")
    t0 = time.perf_counter()
    midx.wait_for_rebuild()      # AddCountForRebuild queued a new forest
    rebuild_wait_s = time.perf_counter() - t0

    # one reader alone: the walk of a chunk of Q queries replayed as one
    # CUDA graph (padded to its bucket), then as eager launches (the
    # engine's graph cutoff set to 0); the same ids both ways.  Then
    # chunks of every size up to the cutoff: at most one graph a bucket
    from sptag_tpu_torch.algo import engine as engine_mod

    def alone_ms(nq, reps):
        ts, ids = [], []
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids.append(midx.search_batch(queries[nq * i:nq * i + nq], K)[1])
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), np.concatenate(ids)
    graph_vs_eager, replay_same = [], True
    cutoff = engine_mod._GRAPH_MAX_Q
    eng = midx._get_engine()
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for nq in GRAPH_SWEEP_Q:
        for _ in range(2):                # the second call captures
            midx.search_batch(queries[:nq], K)
        g_ms, g_ids = alone_ms(nq, 10)
        engine_mod._GRAPH_MAX_Q = 0
        e_ms, e_ids = alone_ms(nq, 5)
        engine_mod._GRAPH_MAX_Q = cutoff
        same = bool(np.array_equal(g_ids[:len(e_ids)], e_ids))
        replay_same &= same
        graph_vs_eager.append({"q": nq, "graph_ms": g_ms, "eager_ms": e_ms,
                               "ids_equal": same})
    read_graph_ms = graph_vs_eager[GRAPH_SWEEP_Q.index(4)]["graph_ms"]
    read_eager_ms = graph_vs_eager[GRAPH_SWEEP_Q.index(4)]["eager_ms"]
    for nq in range(1, cutoff + 1, 7):
        midx.search_batch(queries[:nq], K)
    torch.cuda.synchronize()
    # the graphs' pools stay allocated while the engine keeps them
    graph_cache = {"graphs": len(eng._graphs),
                   "buckets": list(engine_mod._GRAPH_BUCKETS),
                   "cache_cap": engine_mod._GRAPH_CACHE,
                   "held_bytes": torch.cuda.memory_allocated() - base_alloc,
                   "peak_over_base_bytes":
                   torch.cuda.max_memory_allocated() - base_alloc}
    emit({"phase": "9_graph_replay", "graph_vs_eager": graph_vs_eager,
          **graph_cache})
    check(replay_same, "9: graph replay ids differ from the eager walk's")
    check(graph_cache["graphs"] <= len(engine_mod._GRAPH_BUCKETS),
          f"9: {graph_cache['graphs']} graphs for one plan")

    # (b) the bench's mutation stage
    midx.set_parameter("DeltaShardCapacity", str(MUTATE_DELTA_CAP))
    midx.set_parameter("AutoRefineThreshold", str(MUTATE_REFINE_THRESHOLD))
    # device memory of the stream alone: readers, the engine they pin and
    # the one a swap builds beside it
    torch.cuda.reset_peak_memory_stats()
    stream, deleted_vecs = mutate_stream(pt, midx, queries, MUTATE_S)
    peak = torch.cuda.max_memory_allocated()
    dead = np.flatnonzero(midx._deleted[:midx._n])
    returned_dead = 0
    if deleted_vecs:
        _, ids_dv = midx.search_batch(np.stack(deleted_vecs), K)
        returned_dead += int(np.isin(ids_dv, dead).sum())
    _, ids_q = midx.search_batch(q1k, K)
    returned_dead += int(np.isin(ids_q, dead).sum())
    emit({"phase": "9b", "rebuild_wait_s": rebuild_wait_s,
          "read_alone_graph_ms": read_graph_ms,
          "read_alone_eager_ms": read_eager_ms, **stream,
          "deleted_ids": len(dead), "deleted_ids_returned": returned_dead,
          "max_memory_allocated_bytes": peak})
    check(not stream["errors"], f"9b: reader errors {stream['errors'][:3]}")
    check(stream["unfound_adds"] == 0,
          f"9b: {stream['unfound_adds']} acked adds not found by the probe")
    check(stream["swap_count"] >= 1, "9b: no background swap")
    check(returned_dead == 0, f"9b: {returned_dead} deleted ids returned")

    # (c) compaction
    midx.set_parameter("DeltaShardCapacity", "0")
    midx.set_parameter("AutoRefineThreshold", "0")
    midx.wait_for_rebuild()
    dels0 = midx.num_deleted
    t0 = time.perf_counter()
    code = midx.delete(data[victims])
    delete_s = time.perf_counter() - t0
    n_before, dels = midx.num_samples, midx.num_deleted
    block_dots.reset_launch_counts()
    with FirstCalls(block_dots) as first:
        t0 = time.perf_counter()
        midx.refine_index()
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0
    launches = block_dots.launch_counts()
    _, truth_post = midx.exact_search_batch(q1k, K)
    recall_post = recall_at_k(midx.search_batch(q1k, K)[1], truth_post)
    dense_post = recall_at_k(
        midx.search_batch(q1k, K, search_mode="dense")[1], truth_post)
    # the same live rows built afresh: the compaction's remap, forest
    # rebuild, refine pass and repair must lose nothing against it
    fresh = pt.create_instance("BKT", "Float")
    for name, value in [("DistCalcMethod", "L2"), ("BinnedTopK", "off")] \
            + GRAPH_PARAMS:
        fresh.set_parameter(name, value)
    t0 = time.perf_counter()
    fresh.build(midx._host[:midx._n].copy())
    fresh_build_s = time.perf_counter() - t0
    recall_fresh = recall_at_k(
        fresh.search_batch(q1k, K, search_mode="beam")[1], truth_post)
    dense_fresh = recall_at_k(
        fresh.search_batch(q1k, K, search_mode="dense")[1], truth_post)
    tree_equal = bool(np.array_equal(fresh._tree.nodes, midx._tree.nodes))
    graph_rows_equal = float(np.mean(np.all(fresh._graph == midx._graph,
                                            axis=1)))
    fresh.close()
    del fresh
    recall_other = other_forests(midx, q1k, truth_post)
    emit({"phase": "9c", "delete_rows": len(victims),
          "delete_code": int(code), "delete_s": delete_s,
          "victims_deleted": dels - dels0, "deleted_before_refine": dels,
          "num_samples_before": n_before,
          "num_samples_after": midx.num_samples, "refine_s": refine_s,
          "refine_stages_s": midx.build_stages, "refine_launches": launches,
          "beam_recall_at_10_before": recall_pre,
          "beam_recall_at_10_after": recall_post,
          "beam_recall_at_10_fresh_build": recall_fresh,
          "beam_recall_at_10_after_other_forests": recall_other,
          "beam_recall_at_10_before_other_forests": recall_pre_other,
          "after_within_0.01_of_before": recall_post >= recall_pre - 0.01,
          "dense_recall_at_10_before": dense_pre,
          "dense_recall_at_10_after": dense_post,
          "dense_recall_at_10_fresh_build": dense_fresh,
          "fresh_build_s": fresh_build_s, "fresh_tree_equal": tree_equal,
          "fresh_graph_rows_equal": graph_rows_equal})
    check(midx.num_samples == n_before - dels,
          f"9c: {n_before} rows - {dels} deleted != {midx.num_samples}")
    # the compaction's recall is held against a fresh build of the same
    # live rows.  Against the recall before the mutation it is printed:
    # the compaction redraws the forest over other rows, as SPTAG's
    # RefineIndex does, the walk seeds from that forest's pivots, and one
    # draw differs from another by far more than 0.01 (the "other_forests"
    # reading; PERF.md)
    check(recall_post >= recall_fresh - 0.01
          and dense_post >= dense_fresh - 0.01,
          f"9c: recall@10 after compaction beam {recall_post} / dense "
          f"{dense_post}, a fresh build of the same rows {recall_fresh} / "
          f"{dense_fresh}")

    # (d) the write-ahead log.  No background forest rebuild: the replay
    # links against the saved forest, as the live index does
    midx.set_parameter("AddCountForRebuild", "100000")
    midx.set_parameter("WalEnabled", "1")
    wal_folder = os.path.join(workdir, "bkt_wal")
    check(midx.save_index(wal_folder) == pt.ErrorCode.Success,
          "9d: save_index")
    rows_d, _ = make_dataset(n=1000, nq=1, seed=13)
    midx.add(rows_d)
    midx.delete(rows_d[:100])
    t0 = time.perf_counter()
    back = pt.load_index(wal_folder)
    load_s = time.perf_counter() - t0
    _, ids_live = midx.search_batch(q1k, K)
    _, ids_back = back.search_batch(q1k, K)
    _, rows_live = midx.search_batch(rows_d, 1)
    _, rows_back = back.search_batch(rows_d, 1)
    same = bool(np.array_equal(ids_live, ids_back)
                and np.array_equal(rows_live, rows_back))
    emit({"phase": "9d", "num_samples": [midx.num_samples,
                                         back.num_samples],
          "num_deleted": [midx.num_deleted, back.num_deleted],
          "acked_writes": midx.mutation_state()["acked_writes"],
          "load_with_replay_s": load_s, "ids_equal": same})
    check(midx.num_samples == back.num_samples
          and midx.num_deleted == back.num_deleted and same,
          "9d: the replayed index differs from the live one")
    midx.close()
    back.close()
    return first, launches


def dense_add_phase(pt, data, queries):
    """Phase 9e: adds to the dense-only headline index (BuildGraph=0,
    phase 3's configuration, built again).  An add leaves no graph row to
    link; it marks the dense layout stale and the next search rebuilds it
    whole, as in the JAX package.  Times a batch of 100 rows and a single
    row: the add, the next search of 1,024 queries (the rebuild) and the
    one after it, against a steady search."""
    didx = pt.create_instance("BKT", "Float")
    for name, value in DENSE_PARAMS:
        if not didx.set_parameter(name, value):
            fail(f"set_parameter {name}")
    didx.build(data)
    q1k = queries[:1024]

    def search_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        didx.search_batch(q1k, K)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    search_ms()                                  # materializes the layout
    steady_ms = statistics.median(search_ms() for _ in range(5))
    rows_e, _ = make_dataset(n=101, nq=1, seed=17)
    adds = []
    for lo, hi in ((0, 100), (100, 101)):
        n0 = didx.num_samples
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        code = didx.add(rows_e[lo:hi])
        torch.cuda.synchronize()
        add_ms = (time.perf_counter() - t0) * 1e3
        next_ms, after_ms = search_ms(), search_ms()
        d, ids = didx.search_batch(rows_e[lo:hi], 1)
        found = int(np.sum((ids[:, 0] == np.arange(n0, n0 + hi - lo))
                           & (d[:, 0] <= 1e-3)))
        adds.append({"rows": hi - lo, "code": int(code), "add_ms": add_ms,
                     "next_search_ms": next_ms,
                     "following_search_ms": after_ms, "found": found})
    emit({"phase": "9e", "n": didx.num_samples,
          "steady_search_ms": steady_ms, "adds": adds})
    # "found": added rows that the dense search returns as their own
    # nearest.  Printed, not held: a row is filed with its nearest tree
    # center while the probe ranks block means, so a row far from the
    # corpus's clusters can fall outside the probed blocks, in the JAX
    # package as here (tests/test_torch_mutation.py holds the two equal)
    for a in adds:
        check(a["code"] == 0, f"9e: BuildGraph=0 add of {a['rows']} rows "
              f"returned {a['code']}")
    didx.close()


KD_SINGLE_CALLS = 10      # single KDT queries replayed in phase 10


def kd_descent_checks(kidx, kq) -> dict:
    """Phase 10's kd descent on the card, on the built KDT index."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.ops import kd_descent, walk_body
    from sptag_tpu_torch.utils import metrics

    eng = kidx._get_engine()
    p = kidx.params
    bt = kidx._backtrack_for(p.max_check)
    trees = int(eng.kd_starts.shape[0])
    qp = kidx._prepare_query(kq)
    qd = torch.from_numpy(qp).to(eng.device)
    card = eng.kd_seeds(qd, bt).cpu()
    plain = kd_descent.kd_seeds(qd.cpu(), eng.kd_nodes.cpu(),
                                eng.kd_starts.cpu(), bt)
    host = kidx._tree.collect_seeds(qp, backtrack=bt)

    def groups(x):
        return np.sort(np.asarray(x).reshape(len(x), trees, 1 + bt), axis=2)
    kw = dict(max_check=p.max_check, beam_width=getattr(p, "beam_width", 16),
              nbp_limit=p.no_better_propagation_limit)
    want = eng.search(qp, K, seeds=host, **kw)
    old = teng._GRAPH_MAX_Q
    teng._GRAPH_MAX_Q = 0                   # the eager walk
    try:
        eager = eng.search(qp, K, kd_backtrack=bt, **kw)
    finally:
        teng._GRAPH_MAX_Q = old
    replayed = [eng.search(qp[:64], K, kd_backtrack=bt, **kw)
                for _ in range(3)]          # eager, capture, replay
    kidx.search_batch(kq[:1], K)            # eager: the key is seen
    with CapturedWalkCounts(walk_body) as captured:
        kidx.search_batch(kq[:1], K)        # captured and replayed
        kd_descent.reset_launch_counts()
        torch.cuda.synchronize()
        replays = teng.graph_stats().get(str(eng.device), {}).get(
            "walk_replays", 0)
        before = int(eng.kd_reads.cpu()[0])
        for _ in range(KD_SINGLE_CALLS):
            kidx.search_batch(kq[:1], K)
        single_reads = int(eng.kd_reads.cpu()[0]) - before
        replays = teng.graph_stats().get(str(eng.device), {}).get(
            "walk_replays", 0) - replays
    captured.check("10: KDT")
    return {"backtrack": bt, "trees": trees, "depth": eng.kd_depth,
            "seeds_equal_plain": bool(torch.equal(card, plain)),
            "groups_equal_host": bool(np.array_equal(groups(card),
                                                     groups(host))),
            "eager_ids_equal": bool(np.array_equal(eager[1], want[1])),
            "replayed_ids_equal": all(
                np.array_equal(r[1], want[1][:64]) for r in replayed),
            "single_replays": replays,
            "single_host_launches": kd_descent.launch_counts()["kd_descent"],
            "single_reads": single_reads,
            "single_resident": captured.row(),
            "node_reads": metrics.counter_value("search.kd_node_reads")}


def kdt_phase(pt, block_dots, dist_ops, workdir):
    """Phase 10: bench.py's KDT configuration (build_headline_kdt): 50,000
    x 100 float cosine, KDTNumber=2, the graph parameters; the kd-seeded
    walk and the dense scan with DenseReplicas=2 over 200 queries, save
    and load, 1,000 adds and 100 deletes.  Returns the first block-dot
    call of the dense search and its launches."""
    dev = torch.device("cuda")
    kdata, kq = make_dataset(n=50_000, d=100, nq=200)
    kidx = pt.create_instance("KDT", "Float")
    # bench.py's _GRAPH_PARAMS: GRAPH_PARAMS without the BKT forest knobs
    graph_params = [(n, v) for n, v in GRAPH_PARAMS
                    if not n.startswith("BKT")]
    for name, value in ([("DistCalcMethod", "Cosine"), ("KDTNumber", "2")]
                        + graph_params):
        if not kidx.set_parameter(name, value):
            fail(f"set_parameter {name}")
    block_dots.reset_launch_counts()
    t0 = time.perf_counter()
    kidx.build(kdata)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = block_dots.launch_counts()
    truth = exact_truth(dist_ops, torch.from_numpy(kidx._host).to(dev),
                        torch.from_numpy(kidx._prepare_query(kq)).to(dev),
                        cosine_base=1)
    kidx.search_batch(kq, K)                         # builds the engine
    ids_b, times_b = timed_batches(kidx, kq, len(kq), BEAM_PASSES * 4)
    recall_b = recall_at_k(ids_b, truth)
    kd_card = kd_descent_checks(kidx, kq)
    kidx.set_parameter("SearchMode", "dense")
    kidx.set_parameter("DenseReplicas", "2")
    block_dots.reset_launch_counts()
    with FirstCalls(block_dots) as first:
        t0 = time.perf_counter()
        kidx.search_batch(kq, K)                     # builds the layout
        first_dense_s = time.perf_counter() - t0
        ids_d, times_d = timed_batches(kidx, kq, len(kq))
    dense_launches = block_dots.launch_counts()
    recall_d = recall_at_k(ids_d, truth)
    kidx.set_parameter("SearchMode", "beam")
    kfolder = os.path.join(workdir, "kdt")
    check(kidx.save_index(kfolder) == pt.ErrorCode.Success, "10: save")
    _, ids_l = pt.load_index(kfolder).search_batch(kq, K)
    same = bool(np.array_equal(ids_l, ids_b))
    n0 = kidx.num_samples
    rows_k, _ = make_dataset(n=1000, d=100, nq=1, seed=12)
    t0 = time.perf_counter()
    kidx.add(rows_k)
    kidx.delete(rows_k[:100])
    mutate_s = time.perf_counter() - t0
    _, ids_k = kidx.search_batch(rows_k, K)
    dead = np.flatnonzero(kidx._deleted[:kidx._n])
    found = float(np.mean(ids_k[100:, 0] == np.arange(n0 + 100, n0 + 1000)))
    emit({"phase": 10, "n": len(kdata), "d": kdata.shape[1],
          "build_s": build_s, "build_stages_s": kidx.build_stages,
          "build_launches": build_launches,
          "beam": {"recall_at_10": recall_b, **batch_stats(times_b,
                                                           len(kq))},
          "dense_replicas_2": {"recall_at_10": recall_d,
                               "first_batch_s": first_dense_s,
                               **batch_stats(times_d, len(kq)),
                               "launches": dense_launches},
          "kd_descent": kd_card,
          "jax_recall": JAX_KDT_RECALL, "save_load_ids_equal": same,
          "add_delete_s": mutate_s, "deleted": len(dead),
          "added_found_by_beam": found,
          "deleted_returned": int(np.isin(ids_k, dead).sum())})
    check(recall_b >= KDT_RECALL_MIN,
          f"10: KDT beam recall@10 {recall_b} < {KDT_RECALL_MIN}")
    check(recall_d >= KDT_RECALL_MIN,
          f"10: KDT dense recall@10 {recall_d} < {KDT_RECALL_MIN}")
    check(same, "10: KDT beam ids differ after save -> load")
    check(kd_card["seeds_equal_plain"] and kd_card["groups_equal_host"],
          f"10: the kd descent kernel's seeds differ {kd_card}")
    check(kd_card["eager_ids_equal"] and kd_card["replayed_ids_equal"],
          f"10: the card-seeded walk's ids differ {kd_card}")
    check(kd_card["single_replays"] == KD_SINGLE_CALLS
          and kd_card["single_host_launches"] == 0
          and kd_card["node_reads"] >= kd_card["single_reads"] > 0,
          f"10: single KDT queries did not replay the descent {kd_card}")
    check(len(dead) >= 90 and not np.isin(ids_k, dead).any(),
          f"10: {len(dead)} of 100 deleted, or deleted ids returned")
    check(dense_launches["probe_block_dots_f32"]
          + dense_launches["group_block_dots_f32"] >= 1,
          f"10: the dense search launched no block-dot kernel "
          f"{dense_launches}")
    kidx.close()
    return first, dense_launches


# phase 11: the walk's options and the slot scheduler on phase 7's index
STRAGGLER_BUDGETS = (8192, 16384)   # one pool: L = 1,024, B = 128
STRAGGLER_QUERIES = 2048
SUBMITTERS = 4
SUBMIT_BATCH = 8
SWEEP_CAPACITIES = (1, 8, 32, 128, 256, 1024)   # QUERY_BUCKETS


def walk_profile(index, queries):
    """One batch's device time by kernel (torch.profiler), phase 6's way:
    the row gathers (kernels named *index* / *gather*), the contractions
    (cuBLAS *gemv* / *gemm* / *xmma* / *nvjet*), launches per walk
    iteration."""
    from torch.profiler import ProfilerActivity, profile

    index.search_batch(queries, K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        index.search_batch(queries, K)
        torch.cuda.synchronize()
    its = index._get_engine().last_iterations
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(*words):
        return sum(e.self_device_time_total for e in rows
                   if any(w in e.key.lower() for w in words)) / 1e3
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    return {"device_ms": busy, "gather_ms": ms("index", "gather"),
            "contraction_ms": ms("gemv", "gemm", "xmma", "cutlass",
                                 "nvjet"),
            "walk_iterations": its,
            "launches_per_iteration": sum(e.count for e in rows) / its,
            "top_device": [[e.key[:80], e.self_device_time_total / 1e3,
                            e.count] for e in top]}


def rerank_exact(host, queries, d, ids, dev) -> int:
    """Returned distances that are not the float32 distance of their id
    (within 1e-5 * (|q|^2 + |x|^2 + 2 sum |q_d x_d|) of the float64
    one): the exact re-rank of the bf16 walk's pool."""
    q = torch.from_numpy(queries).to(dev).double()
    x = torch.from_numpy(host[np.maximum(ids, 0)]).to(dev).double()
    exact = ((q[:, None, :] - x) ** 2).sum(-1)
    bound = 1e-5 * ((q * q).sum(-1)[:, None] + (x * x).sum(-1)
                    + 2.0 * (q[:, None, :] * x).abs().sum(-1))
    bad = ((torch.from_numpy(d).to(dev).double() - exact).abs() > bound) \
        & torch.from_numpy(ids >= 0).to(dev)
    return int(bad.sum().item())


def set_params(index, **kw):
    for name, value in kw.items():
        if not index.set_parameter(name, str(value)):
            fail(f"set_parameter {name}")


def paired_times(index, queries, a, b):
    """Batch p50 (ms, batches of 1,024) of two settings (name, params) of
    `index`, timed in turns a, b, b, a in one window; each turn builds
    its engine with one untimed batch first."""
    times = {a[0]: [], b[0]: []}
    for name, params in (a, b, b, a):
        set_params(index, **params)
        index.search_batch(queries[:1024], K)
        times[name] += timed_batches(index, queries, 1024, 1)[1]
    return {name: statistics.median(t) * 1e3 for name, t in times.items()}


def straggler_stream(index, sched, qs, mcs, want):
    """SUBMITTERS threads submit `qs` in batches of SUBMIT_BATCH through
    `index.submit_batch`, batch i at MaxCheck `mcs[i]`; the readings of
    one run: submit-to-resolve percentiles, wall time, ids equal to the
    monolithic walk's (`want`), resident walk iterations and segments."""
    import threading

    base = sched.stats()
    lat = [None] * len(qs)
    got = np.full((len(qs), K), -2, np.int32)
    done = threading.Event()
    left = [len(qs)]
    lock = threading.Lock()

    def resolved(f, i, t_sub):
        lat[i] = time.perf_counter() - t_sub
        if f.exception() is None:
            got[i] = f.result()[1]
        with lock:
            left[0] -= 1
            if not left[0]:
                done.set()

    def submitter(t):
        per = len(qs) // SUBMITTERS
        for lo in range(t * per, (t + 1) * per, SUBMIT_BATCH):
            t_sub = time.perf_counter()
            futs = index.submit_batch(qs[lo:lo + SUBMIT_BATCH], K,
                                      max_check=int(mcs[lo]))
            for j, f in enumerate(futs):
                f.add_done_callback(
                    lambda f, i=lo + j, t_sub=t_sub: resolved(f, i, t_sub))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(SUBMITTERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    done.wait(timeout=900)
    wall = time.perf_counter() - t0
    st = sched.stats()
    retired = st["retired"] - base["retired"]
    segs = {m: (st[f"segments_{m}"] - base[f"segments_{m}"],
                st[f"segment_s_{m}"] - base[f"segment_s_{m}"])
            for m in ("eager", "replayed")}
    lat_ms = sorted(x * 1e3 for x in lat if x is not None)
    return {"resolved": len(lat_ms), "wall_s": wall,
            "submit_to_resolve_ms_p50": statistics.median(lat_ms),
            "submit_to_resolve_ms_p99": float(np.percentile(lat_ms, 99)),
            "ids_equal_monolithic": int((got == want).all(1).sum()),
            "resident_iterations_mean": (st["resident_iters_sum"]
                                         - base["resident_iters_sum"])
            / max(retired, 1),
            "resident_iterations_max": st["resident_iters_max"],
            **{f"segments_{m}": n for m, (n, _) in segs.items()},
            **{f"segment_ms_{m}": (sec / n * 1e3 if n else None)
               for m, (n, sec) in segs.items()}}


def segment_sweep(index, queries):
    """The scheduler's segments eager and replayed at each capacity of
    the QUERY_BUCKETS ladder (SWEEP_CAPACITIES), on either side of
    `_GRAPH_MAX_SLOTS`: per capacity a scheduler that runs every segment
    eagerly and one that replays every segment, in turns eager, replayed,
    replayed, eager; each turn two untimed batches (the second captures)
    and three timed.  Per capacity: batch ms (median), ms per segment,
    and the monolithic walk's batch ms over the same queries (a graph
    replay up to 256 queries); ids held to the monolithic walk's."""
    from sptag_tpu_torch.algo.scheduler import BeamSlotScheduler

    eng = index._get_engine()
    mc = int(index.params.max_check)
    out = []
    for n in SWEEP_CAPACITIES:
        q = queries[:n]
        want = eng.search(q, K, max_check=mc)[1]
        eng.search(q, K, max_check=mc)
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.search(q, K, max_check=mc)
            t.append((time.perf_counter() - t0) * 1e3)
        row = {"queries": n, "monolithic_ms": statistics.median(t)}
        walls = {"eager": [], "replayed": []}
        segs = {"eager": [0, 0.0], "replayed": [0, 0.0]}
        same = True
        for mode in ("eager", "replayed", "replayed", "eager"):
            sched = BeamSlotScheduler(
                eng, graph_max_slots=1024 if mode == "replayed" else 0)
            try:
                for _ in range(2):
                    same &= bool(np.array_equal(
                        sched.search_batch(q, K, mc)[1], want))
                b = sched.stats()
                for _ in range(3):
                    t0 = time.perf_counter()
                    got = sched.search_batch(q, K, mc)[1]
                    walls[mode].append((time.perf_counter() - t0) * 1e3)
                    same &= bool(np.array_equal(got, want))
                a = sched.stats()
            finally:
                sched.stop()
            segs[mode][0] += a[f"segments_{mode}"] - b[f"segments_{mode}"]
            segs[mode][1] += (a[f"segment_s_{mode}"]
                              - b[f"segment_s_{mode}"])
        for mode in walls:
            row[f"{mode}_ms"] = statistics.median(walls[mode])
            row[f"segment_ms_{mode}"] = (segs[mode][1] / segs[mode][0] * 1e3
                                         if segs[mode][0] else None)
        row["segments_per_batch"] = segs["eager"][0] / 6
        row["ids_equal_monolithic"] = same
        out.append(row)
    return out


def scheduler_phase(pt, gidx, queries, truth, beam, kfolder, kq):
    """Phase 11 on phase 7's f32 200k graph index (and phase 10's KDT
    folder): (a) the bf16 shadow, exact and binned walks; (b) packed
    neighbours in f32 and bf16; (c) the segmented walk; (d) the slot
    scheduler: parity, the straggler stream, KDT parity; (f) a blob round
    trip and the card-memory estimate; (e) a background swap with
    scheduled queries in flight (last: it mutates the index)."""
    import threading

    dev = gidx.device
    host = gidx._host[:gidx._n]
    q1k = queries[:1024]

    # ---- 11a: the bf16 shadow ------------------------------------------
    set_params(gidx, BinnedTopK="off", BeamScoreDtype="f32")
    f32_profile = walk_profile(gidx, q1k)
    f32, bf16 = ("f32", {"BeamScoreDtype": "f32"}), \
        ("bf16", {"BeamScoreDtype": "bf16"})
    out = {}
    for binned in ("off", "on"):
        set_params(gidx, BinnedTopK=binned)
        times = paired_times(gidx, queries, f32, bf16)
        set_params(gidx, BeamScoreDtype="bf16")
        res = [gidx.search_batch(queries[lo:lo + 1024], K)
               for lo in range(0, len(queries), 1024)]
        d_all = np.concatenate([r[0] for r in res])
        ids_b = np.concatenate([r[1] for r in res])
        eng = gidx._get_engine()
        r = recall_at_k(ids_b, truth)
        out[binned] = {"recall_at_10": r,
                       "f32_recall_at_10": beam[binned]["recall_at_10"],
                       "batch_ms_p50": times["bf16"],
                       "f32_batch_ms_p50": times["f32"],
                       "distances_not_exact": rerank_exact(
                           host, queries, d_all, ids_b, dev)}
        check(abs(r - beam[binned]["recall_at_10"]) <= 0.01,
              f"11a: bf16 walk (BinnedTopK={binned}) recall@10 {r} more "
              f"than 0.01 from the f32 walk's "
              f"{beam[binned]['recall_at_10']}")
        check(out[binned]["distances_not_exact"] == 0,
              f"11a: {out[binned]['distances_not_exact']} bf16-walk "
              f"distances are not their ids' exact float32 distances")
    set_params(gidx, BinnedTopK="off")
    bf16_profile = walk_profile(gidx, q1k)
    # the contraction alone at a walk iteration's shape (1,024 queries x
    # B*m = 2,048 candidate rows): the bf16 product with float32 dots,
    # its plain form (upcast rows, a float32 contraction), and float32
    from sptag_tpu_torch.ops import distance as dist_ops

    gen = torch.Generator(device=dev).manual_seed(11)
    cq = torch.randn((1024, host.shape[1]), generator=gen, device=dev)
    cc = torch.randn((1024, 2048, host.shape[1]), generator=gen,
                     device=dev)
    bq, bc = cq.to(torch.bfloat16), cc.to(torch.bfloat16)
    contraction = {
        "bf16_product_ms": median_ms(
            lambda: dist_ops.bf16_gathered_dot(bq, bc)),
        "bf16_upcast_plain_ms": median_ms(
            lambda: dist_ops.bf16_gathered_dot_plain(bq, bc)),
        "f32_ms": median_ms(
            lambda: torch.einsum("qd,qcd->qc", cq, cc))}
    del cq, cc, bq, bc
    emit({"phase": "11a", "walks": out, "contraction_1024x2048": contraction,
          "shadow_bytes": eng.data_score.nbytes,
          "engine_bytes": eng.device_bytes(),
          "profile_exact_walk_1024": {"f32": f32_profile,
                                      "bf16": bf16_profile}})

    # ---- 11b: packed neighbours ------------------------------------------
    rows = {}
    for score in ("f32", "bf16"):
        set_params(gidx, BeamScoreDtype=score, BeamPackedNeighbors=0)
        d0, i0 = gidx.search_batch(q1k, K)
        set_params(gidx, BeamPackedNeighbors=1)
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        d1, i1 = gidx.search_batch(q1k, K)           # builds the engine
        eng = gidx._get_engine()
        grown = torch.cuda.memory_allocated() - m0
        same = bool(np.array_equal(i0, i1) and np.array_equal(d0, d1))
        times = paired_times(gidx, queries,
                             ("unpacked", {"BeamPackedNeighbors": 0}),
                             ("packed", {"BeamPackedNeighbors": 1}))
        set_params(gidx, BeamPackedNeighbors=1)
        rows[score] = {"ids_and_distances_equal_unpacked": same,
                       "profile_exact_walk_1024": walk_profile(gidx, q1k),
                       "nbr_vecs_bytes": eng.nbr_vecs.nbytes,
                       "nbr_sq_bytes": eng.nbr_sq.nbytes,
                       "allocated_delta_bytes": grown,
                       "batch_ms_p50": times["packed"],
                       "unpacked_batch_ms_p50": times["unpacked"]}
        check(same, f"11b: packed {score} walk differs from the unpacked "
                    f"one")
    set_params(gidx, BeamScoreDtype="f32", BeamPackedNeighbors=0)
    emit({"phase": "11b", "packed": rows})

    # ---- 11c: the segmented walk -------------------------------------------
    d0, i0 = gidx.search_batch(q1k, K)
    T = gidx._get_engine().walk_plan(K, 2048, 16, None, 3)[3]
    S = max(1, T // 4)
    set_params(gidx, BeamSegmentIters=S)
    d1, i1 = gidx.search_batch(q1k, K)
    times = paired_times(gidx, queries,
                         ("monolithic", {"BeamSegmentIters": 0}),
                         ("segmented", {"BeamSegmentIters": S}))
    set_params(gidx, BeamSegmentIters=0)
    same = bool(np.array_equal(i0, i1) and np.array_equal(d0, d1))
    emit({"phase": "11c", "T": T, "segment_iters": S,
          "ids_and_distances_equal_monolithic": same,
          "batch_ms_p50": times["segmented"],
          "monolithic_batch_ms_p50": times["monolithic"]})
    check(same, "11c: the segmented walk differs from the monolithic one")

    # ---- 11d: the slot scheduler ------------------------------------------
    set_params(gidx, ContinuousBatching=1)
    _, i_sb = gidx.search_batch(q1k, K)
    sub = [None] * SUBMITTERS
    errors = []

    def thread_batch(t):
        try:
            lo = t * len(q1k) // SUBMITTERS
            futs = gidx.submit_batch(q1k[lo:lo + len(q1k) // SUBMITTERS], K)
            sub[t] = np.stack([f.result(timeout=600)[1] for f in futs])
        except Exception as e:                           # noqa: BLE001
            errors.append(repr(e)[:300])
    threads = [threading.Thread(target=thread_batch, args=(t,))
               for t in range(SUBMITTERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    i_threads = np.concatenate(sub) if not errors else None
    parity = {"search_batch_ids_equal": bool(np.array_equal(i_sb, i0)),
              "submit_batch_4_threads_ids_equal": bool(
                  i_threads is not None and np.array_equal(i_threads, i0)),
              "queries_differing": int(((i_sb != i0).any(1)).sum()),
              "errors": errors}
    check(parity["search_batch_ids_equal"]
          and parity["submit_batch_4_threads_ids_equal"],
          f"11d: scheduled ids differ from the monolithic walk's {parity}")

    # the straggler stream: 4 submitters, MaxCheck alternating per batch
    qs = queries[:STRAGGLER_QUERIES]
    mcs = np.array([STRAGGLER_BUDGETS[(i // SUBMIT_BATCH) % 2]
                    for i in range(len(qs))])
    set_params(gidx, ContinuousBatching=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mono = {mc: gidx.search_batch(qs[mcs == mc], K, max_check=int(mc))[1]
            for mc in STRAGGLER_BUDGETS}
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    want = np.empty((len(qs), K), np.int32)
    for mc in STRAGGLER_BUDGETS:
        want[mcs == mc] = mono[mc]
    set_params(gidx, ContinuousBatching=1)
    sched = gidx._get_scheduler()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = [straggler_stream(gidx, sched, qs, mcs, want) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()
    # the slot state of one row (the visited table's N + 1 bools, the
    # spare queue, the pool); a captured segment holds a second copy
    pool = max(sched._pools.values(), key=lambda p: p.L)
    slot_bytes = sum(t.nbytes // t.shape[0] for t in pool.state.values()
                     if t is not None) + 8
    stream = {"queries": len(qs), "budgets": list(STRAGGLER_BUDGETS),
              "walk_plans": [list(gidx._get_engine().walk_plan(
                  K, mc, 16, None, 3)) for mc in STRAGGLER_BUDGETS],
              "monolithic_wall_s": mono_s, "runs": runs,
              "graphs_captured": st["graphs_captured"],
              "slot_state_bytes_per_slot": slot_bytes,
              "slot_state_bytes_at_max_slots": slot_bytes * pool.max_slots,
              "allocated_before_bytes": base_bytes,
              "peak_allocated_bytes": peak,
              "live_after": st["live"], "pending_after": st["pending"]}
    check(all(r["resolved"] == len(qs) for r in runs) and st["live"] == 0
          and st["pending"] == 0,
          f"11d: straggler stream left {st['live']} live, "
          f"{st['pending']} pending, resolved "
          f"{[r['resolved'] for r in runs]} of {len(qs)}")
    check(all(r["ids_equal_monolithic"] == len(qs) for r in runs),
          f"11d: straggler stream ids equal the monolithic walk's for "
          f"{[r['ids_equal_monolithic'] for r in runs]} of {len(qs)}")
    sweep = segment_sweep(gidx, queries)
    check(all(r["ids_equal_monolithic"] for r in sweep),
          "11d: eager or replayed scheduler segments changed the ids")

    # KDT through the scheduler, on phase 10's saved index
    kidx = pt.load_index(kfolder)
    _, ki0 = kidx.search_batch(kq, K)
    set_params(kidx, ContinuousBatching=1)
    _, ki1 = kidx.search_batch(kq, K)
    kst = kidx._scheduler.stats()
    kidx.close()
    kdt = {"ids_equal": bool(np.array_equal(ki0, ki1)),
           "live_after": kst["live"], "pools": kst["pools"]}
    check(kdt["ids_equal"] and kst["live"] == 0,
          f"11d: KDT scheduled ids differ from the monolithic walk's {kdt}")
    emit({"phase": "11d", "parity": parity, "straggler_stream": stream,
          "segment_sweep": sweep, "kdt": kdt})

    # ---- 11f: blobs and the card-memory estimate ------------------------
    set_params(gidx, ContinuousBatching=0)
    config, blobs = gidx.save_index_blobs()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    back = pt.load_index_blobs(config, blobs)
    _, ib = back.search_batch(q1k, K)                  # builds the engine
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - m0
    est = pt.estimated_hbm_usage(back.num_samples, back.feature_dim,
                                 "Float", back._graph.shape[1],
                                 dense_mode=False)
    same = bool(np.array_equal(ib, i0))
    emit({"phase": "11f", "blob_bytes": [len(b) for b in blobs],
          "ids_equal": same, "estimated_hbm_usage": est,
          "engine_device_bytes": sum(
              back._get_engine().device_bytes().values()),
          "memory_allocated_delta": alloc})
    check(same, "11f: the blob round trip changed the ids")
    back.close()
    del back, blobs

    # ---- 11e: a background swap with scheduled queries in flight --------
    set_params(gidx, ContinuousBatching=1, DeltaShardCapacity=2048,
               AutoRefineThreshold=128)
    old = gidx._get_scheduler()
    n0 = gidx.num_samples
    swaps0 = gidx.mutation_state()["swap_count"]
    futs = gidx.submit_batch(q1k, K, max_check=8192)
    rows_e, _ = make_dataset(n=200, d=gidx.feature_dim, nq=1, seed=17)
    t0 = time.perf_counter()
    check(gidx.add(rows_e) == pt.ErrorCode.Success, "11e: add failed")
    errs = [f.exception(timeout=600) for f in futs]
    t_wait = time.monotonic() + 120.0
    while time.monotonic() < t_wait and (
            gidx.mutation_state()["refine_in_flight"]
            or gidx.mutation_state()["swap_count"] == swaps0):
        time.sleep(0.05)
    swap_s = time.perf_counter() - t0
    old._thread.join(timeout=60)
    _, ids_new = gidx.search_batch(rows_e[:32], 1)
    new = gidx._scheduler
    swap = {"in_flight": len(futs), "errors": sum(e is not None
                                                  for e in errs),
            "swaps": gidx.mutation_state()["swap_count"] - swaps0,
            "add_to_swap_s": swap_s, "old_worker_exited": not old.alive,
            "new_engine_rows": None if new is None else new._engine.n,
            "added_rows_found": int((ids_new[:, 0]
                                     == np.arange(n0, n0 + 32)).sum())}
    emit({"phase": "11e", **swap})
    check(swap["errors"] == 0 and swap["swaps"] >= 1
          and swap["old_worker_exited"]
          and swap["new_engine_rows"] == n0 + len(rows_e),
          f"11e: swap with queries in flight: {swap}")
    set_params(gidx, ContinuousBatching=0)


# phase 12: the socket search server on phase 7's saved folder
SERVE_QUERIES = 1024
SERVE_CONNECTIONS = 4
# the open-loop ramp (bench.py _loadgen_measure): offered QPS doubling per
# step of RAMP_STEP_S seconds, judged against a p99 of RAMP_SLO_MS
RAMP_START_QPS = 64.0
RAMP_MAX_QPS = 8192.0
RAMP_STEP_S = 2.0
RAMP_SLO_MS = 250.0
# the walk's former CUDA-graph cache per snapshot (engine._GRAPH_CACHE):
# 12d ramps at it first, then at the default, in the same call
RAMP_AB_GRAPH_CACHE = 8
RAMP_OPTIONS = ["", "$resultnum:1 ", "$maxcheck:256 ", "$maxcheck:2048 ",
                "$searchmode:dense ", "$resultnum:1 $maxcheck:256 "]
# the observability run: concurrent clients, every response sampled by the
# quality monitor, the flight recorder on with slow-query dumps
LOAD_CLIENTS = 6
LOAD_S = 8.0
LOAD_MAXCHECKS = (512, 1024, 4096)
SLOW_QUERY_MS = 20.0
# the server's own flight-recorder events (serve/server.py) and the slot
# scheduler's (algo/scheduler.py), under the JAX package's names
SERVER_EVENTS = {"decode", "enqueue", "queue_wait", "execute", "encode",
                 "drain", "request"}
SCHEDULER_EVENTS = {"pending", "slot_assign", "segment", "retire"}


class ServerRunner:
    """A SearchServer on its own asyncio loop in a daemon thread (the
    repository's test and bench harness shape)."""

    def __init__(self, server):
        import asyncio
        import threading

        self.server = server
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def boot():
                self.addr = await server.start("127.0.0.1", 0)
                ready.set()

            self._boot = self.loop.create_task(boot())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True,
                                       name="chip-smoke-serve-loop")
        self.thread.start()
        if not ready.wait(60):
            fail("the server did not start")

    def stop(self) -> None:
        import asyncio

        asyncio.run_coroutine_threadsafe(self.server.stop(),
                                         self.loop).result(120)

        async def drain():
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(drain(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def b64_query(v) -> str:
    import base64

    return "#" + base64.b64encode(
        np.ascontiguousarray(v, np.float32).tobytes()).decode()


def read_frames(sock, n):
    """Read one response frame per expected reply: (header, body)."""
    from sptag_tpu_torch.serve import wire

    def read_exact(m):
        buf = b""
        while len(buf) < m:
            chunk = sock.recv(m - len(buf))
            if not chunk:
                raise OSError("server closed")
            buf += chunk
        return buf

    out = []
    for _ in range(n):
        h = wire.PacketHeader.unpack(read_exact(wire.HEADER_SIZE))
        out.append((h, read_exact(h.body_length) if h.body_length else b""))
    return out


def lifecycle_replay(addr, here) -> dict:
    """12a: tests/fixtures/wrapper_lifecycle.bytes frame by frame, checked
    as tests/test_wrapper_bytes.py does (it builds FLAT on the card)."""
    import socket

    from sptag_tpu_torch.serve import wire

    with open(os.path.join(here, "tests", "fixtures",
                           "wrapper_lifecycle.bytes"), "rb") as f:
        stream = f.read()
    sock = socket.create_connection(addr, timeout=120)
    replies, off = [], 0
    try:
        while off < len(stream):
            h = wire.PacketHeader.unpack(stream[off:off + wire.HEADER_SIZE])
            end = off + wire.HEADER_SIZE + h.body_length
            sock.sendall(stream[off:end])
            off = end
            (rh, body), = read_frames(sock, 1)
            if rh.packet_type == wire.PacketType.SearchResponse:
                replies.append(wire.RemoteSearchResult.unpack(body))
    finally:
        sock.close()
    names = [r.results[0].index_name if r is not None and r.results
             else None for r in replies]
    ok = (len(replies) == 5 and names[0] == "admin:ok:built"
          and replies[0].results[0].ids[0] == 2
          and names[1] == "admin:ok:added"
          and replies[2].status == wire.ResultStatus.Success
          and replies[2].results[0].ids[0] == 0
          and names[3] == "admin:ok:deleted"
          and names[4] == "admin:ok:deleted")
    return {"replies": names, "self_query_id": (
        replies[2].results[0].ids[0] if len(replies) > 2
        and replies[2].results else None), "ok": ok}


def pool_search(addr, texts, connections=SERVE_CONNECTIONS):
    """Every text through one AnnClientPool of pipelined connections; the
    results in order and the wall seconds."""
    from sptag_tpu_torch.serve.client import AnnClientPool

    pool = AnnClientPool(addr[0], addr[1], connections=connections,
                         timeout_s=120.0)
    pool.connect()
    try:
        t0 = time.perf_counter()
        futs = [pool.search_async(t) for t in texts]
        res = [f.result() for f in futs]
        return res, time.perf_counter() - t0
    finally:
        pool.close()


def served_arrays(results, k):
    from sptag_tpu_torch.serve import wire

    ids = np.full((len(results), k), -1, np.int64)
    d = np.full((len(results), k), np.inf)
    bad = 0
    for i, r in enumerate(results):
        if r.status != wire.ResultStatus.Success or not r.results:
            bad += 1
            continue
        row = r.results[0]
        ids[i, :len(row.ids)] = row.ids
        d[i, :len(row.dists)] = row.dists
    return d, ids, bad


def hold_parity(label, d, ids, bad, ref_d, ref_i, host, q) -> dict:
    """Ids equal to the in-process search at every separated rank (the
    repository's rule for float32 results), distances within phase 2's
    float32 bound, 1e-5 (|q|^2 + |x|^2 + 2 sum |q_d x_d|)."""
    tol = 2e-5 * float(np.abs(ref_d[np.isfinite(ref_d)]).max())
    diff = separated_ids_equal(ids, ref_i, ref_d, tol)
    live = ids >= 0
    x = host.astype(np.float64)[np.maximum(ids, 0)]
    qd = q.astype(np.float64)[:, None, :]
    exact = ((qd - x) ** 2).sum(-1)
    bound = 1e-5 * ((qd * qd).sum(-1) + (x * x).sum(-1)
                    + 2 * np.abs(qd * x).sum(-1))
    dist_ok = bool((np.abs(d - exact) <= bound)[live].all())
    rows_equal = int((ids == ref_i).all(1).sum())
    out = {"errors": bad, "rows_ids_equal": rows_equal,
           "ids_differing_at_separated_ranks": diff,
           "distances_within_f32_bound": dist_ok}
    check(bad == 0 and diff == 0 and dist_ok,
          f"{label}: {bad} errors, {diff} ids off the in-process search, "
          f"distances within bound {dist_ok}")
    return out


def open_loop_ramp(addr, queries, batch_sizes, label,
                   max_misses: int = 2, max_steps: int = 0,
                   profile_first: bool = True, allowed=None,
                   on_step=None, phase: str = "12d",
                   connections: int = 1) -> dict:
    """12d: bench.py's _loadgen_measure without admission control:
    Zipfian keys, bursty modulated-Poisson arrivals, the option palette,
    offered QPS doubling per step until `max_misses` steps miss the SLO
    (or the top rate, or `max_steps` steps); open loop over `connections`
    connections, requests dealt round-robin.
    QPS at SLO is the last rate before the first miss.  The card's busy
    share over the first step from torch.profiler (unless not
    `profile_first`).  A reply whose status is in `allowed` (default:
    Success only) is no error; each status is counted.  `on_step(i)` runs
    as step i starts."""
    import socket
    import threading

    from torch.profiler import ProfilerActivity, profile

    from sptag_tpu_torch.serve import wire

    allowed = {int(wire.ResultStatus.Success)} if allowed is None \
        else {int(a) for a in allowed}
    rng = np.random.default_rng(17)
    nq = len(queries)
    zipf_p = 1.0 / np.arange(1, nq + 1, dtype=np.float64) ** 1.1
    zipf_p /= zipf_p.sum()
    texts = {}
    socks = [socket.create_connection(addr, timeout=30)
             for _ in range(connections)]
    for sock in socks:
        sock.settimeout(None)
    pending, done = {}, {}
    lock = threading.Lock()

    def receiver(sock):
        try:
            while True:
                (h, body), = read_frames(sock, 1)
                t = time.perf_counter()
                with lock:
                    t_sent = pending.pop(h.resource_id, None)
                if t_sent is None:
                    continue
                res = wire.RemoteSearchResult.unpack(body)
                done[h.resource_id] = (
                    t - t_sent, res.status if res is not None else -1)
        except OSError:
            pass

    for sock in socks:
        threading.Thread(target=receiver, args=(sock,), daemon=True,
                         name="chip-smoke-ramp-recv").start()
    next_rid = [1]

    def fire(text):
        rid = next_rid[0]
        next_rid[0] += 1
        body = wire.RemoteQuery(text).pack()
        with lock:
            pending[rid] = time.perf_counter()
        socks[rid % connections].sendall(wire.PacketHeader(
            wire.PacketType.SearchRequest, wire.PacketProcessStatus.Ok,
            len(body), 0, rid).pack() + body)
        return rid

    def qtext(i, opt):
        if i not in texts:
            texts[i] = b64_query(queries[i])
        return "$indexname:main " + opt + texts[i]

    def run_step(offered, profiled):
        n_req = int(min(offered * RAMP_STEP_S, 4000))
        ts, t_cur, burst = [], 0.0, False
        while len(ts) < n_req:
            t_cur += rng.exponential(1.0 / (offered * (2.4 if burst
                                                       else 0.8)))
            ts.append(t_cur)
            if rng.random() < (0.09 if burst else 0.01):
                burst = not burst
        keys = rng.choice(nq, size=n_req, p=zipf_p)
        opt_ix = rng.integers(0, len(RAMP_OPTIONS), size=n_req)
        n_batches = len(batch_sizes)
        prof = None
        if profiled:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            # CUPTI initialises at the session's first launch: here, before
            # the step's clock starts, not in its first requests
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        rids = []
        t0 = time.perf_counter()
        for j in range(n_req):
            dt = ts[j] - (time.perf_counter() - t0)
            if dt > 0:
                time.sleep(dt)
            rids.append(fire(qtext(int(keys[j]),
                                   RAMP_OPTIONS[int(opt_ix[j])])))
        send_s = time.perf_counter() - t0
        t_drain = time.perf_counter() + max(2.0, 6 * RAMP_SLO_MS / 1e3)
        while time.perf_counter() < t_drain and any(
                r in pending for r in rids):
            time.sleep(0.01)
        wall = time.perf_counter() - t0
        busy = None
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            busy = sum(e.self_device_time_total
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e6
        lat, errors, statuses = [], 0, {}
        for r in rids:
            c = done.pop(r, None)
            if c is None:
                with lock:
                    pending.pop(r, None)
                continue
            lat.append(c[0])
            errors += int(c[1]) not in allowed
            statuses[int(c[1])] = statuses.get(int(c[1]), 0) + 1
        sizes = batch_sizes[n_batches:]
        p50 = float(np.percentile(lat, 50)) * 1e3 if lat else None
        p99 = float(np.percentile(lat, 99)) * 1e3 if lat else None
        row = {"offered_qps": offered,
               "sent_qps": n_req / max(send_s, 1e-9),
               "answered_qps": len(lat) / max(wall, 1e-9),
               "requests": n_req, "answered": len(lat),
               "unanswered": n_req - len(lat), "errors": errors,
               "statuses": statuses, "p50_ms": p50, "p99_ms": p99,
               "batches": len(sizes),
               "batch_size": ({"p50": float(np.median(sizes)),
                               "mean": float(np.mean(sizes)),
                               "max": int(max(sizes))} if sizes else None)}
        if busy is not None:
            row["card_busy_s"] = busy
            row["card_idle_share"] = 1.0 - busy / wall
            row["step_wall_s"] = wall
        ok = (p99 is not None and p99 <= RAMP_SLO_MS and errors == 0
              and row["unanswered"] == 0)
        return ok, row

    steps, qps_at_slo, offered, below = [], 0.0, RAMP_START_QPS, []
    misses = 0
    try:
        # warm-up, closed loop: each option at each padded walk size twice
        # (the walk captures a CUDA graph at a key's second sighting)
        for opt in RAMP_OPTIONS:
            for burst in (1, 4, 16, 64):
                for _ in range(2):
                    for j in range(burst):
                        fire(qtext(j, opt))
                    t_warm = time.perf_counter() + 60
                    while pending and time.perf_counter() < t_warm:
                        time.sleep(0.005)
        done.clear()
        # the card's busy share is read over the first step; the ramp ends
        # at the top rate or after the second step that misses the SLO
        while offered <= RAMP_MAX_QPS and not (
                max_steps and len(steps) >= max_steps):
            if on_step is not None:
                on_step(len(steps))
            ok, row = run_step(offered,
                               profiled=profile_first and not steps)
            steps.append(row)
            emit({"phase": f"{phase}_step", **label, **row})
            if not ok:
                misses += 1
                if misses == max_misses:
                    break
            elif not misses:
                below.append(row)
                qps_at_slo = offered
            offered *= 2.0
    finally:
        for sock in socks:
            sock.close()
    check(all(s["errors"] == 0 for s in below),
          f"{phase}: errors below the knee: {[s['errors'] for s in below]}")
    return {"qps_at_slo": qps_at_slo, "slo_ms": RAMP_SLO_MS,
            "steps": len(steps), "errors": sum(s["errors"] for s in steps),
            "statuses": {k: sum(s["statuses"].get(k, 0) for s in steps)
                         for k in {k for s in steps for k in s["statuses"]}},
            "unanswered": sum(s["unanswered"] for s in steps)}


def load_with_observability(addr, queries, index) -> dict:
    """12e: concurrent clients at ever-new padded sizes and budgets
    (fresh walk captures, then the scheduler's) while the quality
    monitor replays every answer through the exact scan."""
    import threading

    from sptag_tpu_torch.serve.client import AnnClientPool
    from sptag_tpu_torch.serve import wire

    rng = np.random.default_rng(23)
    counts = {"sent": 0, "errors": 0}
    lock = threading.Lock()

    def client(seed, stop_at):
        r = np.random.default_rng(seed)
        pool = AnnClientPool(addr[0], addr[1], connections=2,
                             timeout_s=120.0)
        pool.connect()
        try:
            while time.perf_counter() < stop_at:
                burst = int(r.choice((1, 3, 7, 20, 60, 200)))
                mc = int(r.choice(LOAD_MAXCHECKS))
                mode = "dense" if r.random() < 0.25 else "beam"
                keys = r.integers(0, len(queries), burst)
                futs = [pool.search_async(
                    f"$indexname:main $maxcheck:{mc} $searchmode:{mode} "
                    + b64_query(queries[k])) for k in keys]
                bad = sum(f.result().status != wire.ResultStatus.Success
                          for f in futs)
                with lock:
                    counts["sent"] += burst
                    counts["errors"] += bad
        finally:
            pool.close()

    halves = {}
    for cb in ("0", "1"):
        index.set_parameter("ContinuousBatching", cb)
        stop_at = time.perf_counter() + LOAD_S / 2
        ths = [threading.Thread(target=client, args=(int(rng.integers(1e9)),
                                                     stop_at),
                                name=f"chip-smoke-load-{i}")
               for i in range(LOAD_CLIENTS)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(300)
        halves[cb] = dict(counts)
    index.set_parameter("ContinuousBatching", "0")
    return {"clients": LOAD_CLIENTS, "requests": counts["sent"],
            "errors": counts["errors"], "by_continuous_batching": halves}


def server_phase(pt, block_dots, graph_folder, queries, workdir, here,
                 device=None) -> None:
    """Phase 12: the port's socket SearchServer over phase 7's saved f32
    graph folder, loaded from a service INI onto the card, at the JAX
    package's serving defaults (batch window 2 ms, batches of at most
    1,024, ContinuousBatching off)."""
    import threading

    from sptag_tpu_torch.ops import walk_dots as walk_ops
    from sptag_tpu_torch.serve import server as sserver
    from sptag_tpu_torch.serve import service as sservice
    from sptag_tpu_torch.utils import flightrec, metrics, qualmon

    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    ini = os.path.join(workdir, "service.ini")
    with open(ini, "w") as f:
        f.write("[Service]\nListenAddr=127.0.0.1\nListenPort=0\n"
                "EnableRemoteAdmin=1\n"
                f"[QueryConfig]\nDefaultMaxResultNumber={K}\n"
                "[Index]\nList=main\n"
                f"[Index_main]\nIndexFolder={graph_folder}\n")
    t0 = time.perf_counter()
    ctx = sservice.ServiceContext.from_ini(ini, device=device)
    load_s = time.perf_counter() - t0
    index = ctx.indexes["main"]
    q = queries[:SERVE_QUERIES]
    # the in-process reference; it also materializes both engines, which
    # the default AllowSearchModeOverride=auto asks of a $searchmode
    ref = {m: index.search_batch(q, K, search_mode=m)
           for m in ("beam", "dense")}

    batch_sizes = []
    server = sserver.SearchServer(ctx)
    execute = server.executor.execute_batch

    def counted(texts, **kw):
        batch_sizes.append(len(texts))
        return execute(texts, **kw)

    server.executor.execute_batch = counted
    run = ServerRunner(server)
    out = {"load_s": load_s}

    # ---- 12a: the lifecycle fixture ---------------------------------------
    out["a"] = lifecycle_replay(run.addr, here)
    check(out["a"]["ok"], f"12a: lifecycle replies {out['a']}")

    # ---- 12b: parity with the in-process search ---------------------------
    out["b"] = {}
    for mode in ("beam", "dense"):
        before = block_dots.launch_counts()["probe_block_dots_f32"]
        walk_before = walk_ops.launch_counts()
        n_batches = len(batch_sizes)
        res, wall = pool_search(run.addr, [
            f"$indexname:main $searchmode:{mode} " + b64_query(v)
            for v in q])
        d, ids, bad = served_arrays(res, K)
        row = hold_parity(f"12b {mode}", d, ids, bad, *ref[mode],
                          index._host, q)
        sizes = batch_sizes[n_batches:]
        row.update({"wall_s": wall, "qps": len(q) / wall,
                    "batches": len(sizes),
                    "batch_size_p50": float(np.median(sizes)),
                    "probe_block_dots_f32_launches":
                        block_dots.launch_counts()["probe_block_dots_f32"]
                        - before,
                    # eager walks and captures count; a graph replay
                    # launches the captured kernels without the wrapper
                    "walk_launches": {
                        k: v - walk_before[k]
                        for k, v in walk_ops.launch_counts().items()}})
        out["b"][mode] = row
    check(out["b"]["dense"]["probe_block_dots_f32_launches"] >= 1,
          "12b: the server's dense requests launched no probe_block_dots "
          "f32")

    # ---- 12c: streaming through the slot scheduler -------------------
    index.set_parameter("ContinuousBatching", "1")
    streamed0 = metrics.counter_value("server.streamed_responses")
    res, wall = pool_search(run.addr, ["$indexname:main $searchmode:beam "
                                       + b64_query(v) for v in q])
    d, ids, bad = served_arrays(res, K)
    out["c"] = hold_parity("12c", d, ids, bad, *ref["beam"], index._host,
                           q)
    out["c"].update({"wall_s": wall, "streamed_responses":
                     metrics.counter_value("server.streamed_responses")
                     - streamed0})
    index.set_parameter("ContinuousBatching", "0")
    check(out["c"]["streamed_responses"] >= len(q) // 2,
          f"12c: only {out['c']['streamed_responses']} responses streamed")
    emit({"phase": "12abc", **out})

    # ---- 12d: the open-loop ramp -------------------------------------------
    # first at the walk's former graph cache, then at the default
    from sptag_tpu_torch.algo import engine as walk_engine

    default_cache = walk_engine._GRAPH_CACHE
    out["d"] = {}
    for cache in (RAMP_AB_GRAPH_CACHE, default_cache):
        walk_engine._GRAPH_CACHE = cache
        try:
            label = {"graph_cache": cache}
            # the former cache's ramp only needs its knee
            out["d"][str(cache)] = {**label, **open_loop_ramp(
                run.addr, queries, batch_sizes, label,
                max_misses=1 if cache == RAMP_AB_GRAPH_CACHE else 2)}
        finally:
            walk_engine._GRAPH_CACHE = default_cache
    run.stop()

    # ---- 12e: observability under load -------------------------------------
    flight_dir = os.path.join(workdir, "flight")
    server = sserver.SearchServer(ctx, quality_sample_rate=1.0,
                                  flight_recorder=True,
                                  flight_dump_dir=flight_dir,
                                  slow_query_threshold_ms=SLOW_QUERY_MS)
    run = ServerRunner(server)
    # the slow-query log would flood stderr; the dumps are what is held
    serve_log = logging.getLogger("sptag_tpu_torch.serve.server")
    level = serve_log.level
    serve_log.setLevel(logging.ERROR)
    out["e"] = load_with_observability(run.addr, queries, index)
    drained = qualmon.drain(60.0)
    snap = qualmon.snapshot()
    # stop() joins the server's IO thread: every dump is whole after it
    run.stop()
    serve_log.setLevel(level)
    dumps = sorted((os.path.join(flight_dir, fn)
                    for fn in os.listdir(flight_dir)
                    if fn.endswith(".json")), key=os.path.getmtime) \
        if os.path.isdir(flight_dir) else []
    # the newest dump holding both the server's and the scheduler's events
    kinds = {}
    for path in reversed(dumps):
        with open(path) as f:
            kinds = {}
            for ev in json.load(f).get("flightEvents", []):
                kinds.setdefault(ev["tier"], set()).add(ev["kind"])
        if SERVER_EVENTS <= kinds.get("server", set()) \
                and SCHEDULER_EVENTS <= kinds.get("scheduler", set()):
            break
    out["e"].update({
        "shadow_drained": drained,
        "shadow_recall": {key: {"recall": w["recall"],
                                "samples": w["samples"]}
                          for key, w in snap["windows"].items()},
        "shadow_counters": snap["counters"],
        "flight_dumps": len(dumps),
        "dump_tiers": {t: sorted(k) for t, k in kinds.items()},
        "walk_graphs": len(index._get_engine()._graphs)})
    check(out["e"]["errors"] == 0,
          f"12e: {out['e']['errors']} failed requests under load")
    check(SERVER_EVENTS <= kinds.get("server", set())
          and SCHEDULER_EVENTS <= kinds.get("scheduler", set()),
          f"12e: no slow-query dump holds the server's and the "
          f"scheduler's events: {out['e']['dump_tiers']}")
    flightrec.configure(enabled=False)
    qualmon.configure(sample_rate=0.0)

    # ---- 12f: a clean stop --------------------------------------------
    t_end = time.perf_counter() + 10
    while time.perf_counter() < t_end:
        # phase 12's own threads: any non-daemon one, a scheduler worker
        # or a serving thread still alive
        left = [t.name for t in threading.enumerate()
                if t.is_alive() and t not in threads_before and (
                    not t.daemon
                    or t.name.startswith(("beam-sched", "sptag-serve")))]
        if not left:
            break
        time.sleep(0.1)
    out["f"] = {"threads_left": left}
    check(not left, f"12f: threads left after stop: {left}")
    for i in ctx.indexes.values():
        if hasattr(i, "close"):
            i.close()
    out["wall_s"] = time.perf_counter() - t_phase
    emit({"phase": "12def", "d": out["d"], "e": out["e"], "f": out["f"],
          "wall_s": out["wall_s"]})


# ---- phase 13: the control plane, the aggregator, the wrappers, the CLIs ---
# the f32 L2 headline cut into two shards of global rows [lo, hi)
SHARDS = ((0, 100_000), (100_000, 200_000))
# the CLI builds use the graph parameters, and serve beam by default
SHARD_PARAMS = [("DistCalcMethod", "L2")] + GRAPH_PARAMS \
    + [("SearchMode", "beam")]
CLI_THREADS = 8
CLUSTER_QUERIES = 1024
# concurrent AnnClients of 13c, each a thread sending one query at a time
CLUSTER_CLIENTS = 16
# 13d: the open-loop ramp's steps through the aggregator, and the SLO
# engine's p99 objective: tight on purpose, so that the burn-rate engine
# pages during the ramp and the controller acts within it
CLUSTER_RAMP_STEPS = 4
# the aggregator answers one connection's requests one at a time (the JAX
# package's aggregator.py), so its ramp deals requests over connections
CLUSTER_RAMP_CONNECTIONS = 16
CLUSTER_SLO_P99_MS = 5.0
# 13d: device traces taken one after another on shard 0 under load, each
# with an overlapping one that must get 409
DEVICE_TRACES = 3
CANARY_MS = 250.0
ANN_ADDS = 1000
ANN_DELETES = 100
# the JAX package's device-memory ledger components (sptag_tpu/utils/
# devmem.py's call sites)
JAX_COMPONENTS = {"corpus", "graph", "tree", "dense_blocks", "int8_blocks",
                  "packed_neighbors", "slot_pool", "delta_shard", "sketch",
                  "host_corpus", "shard_blocks"}
# series the control plane publishes on /metrics (name prefixes)
CONTROL_SERIES = ("sptag_tpu_admission_", "sptag_tpu_slo_",
                  "sptag_tpu_canary_", "sptag_tpu_controller_")


def run_processes(cmds, here, timeout_s=900):
    """Start every command together; (rc, stdout, stderr, wall seconds)
    of each, in order."""
    import threading

    out = [None] * len(cmds)

    def one(i, cmd):
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        try:
            so, se = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out[i] = (p.returncode, so, se, time.perf_counter() - t0)

    threads = [threading.Thread(target=one, args=(i, c),
                                name=f"chip-smoke-cli-{i}")
               for i, c in enumerate(cmds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def cli_phase(pt, data, queries, workdir, here) -> dict:
    """13a: each shard written as a BIN: vector file and built by
    ``python -m sptag_tpu_torch.tools.index_builder`` (no device flag: the
    card), both processes started together; shard 0's exact top-10 from
    FLAT on the card as the truth file of ``tools.index_searcher``, whose
    recall and result ids are held to an in-process search_batch of the
    folder at the same MaxCheck."""
    import re

    from sptag_tpu_torch.io import format as fmt
    from sptag_tpu_torch.tools.index_searcher import calc_recall, load_truth

    out, cmds, folders = {}, [], []
    d = data.shape[1]
    for s, (lo, hi) in enumerate(SHARDS):
        path = os.path.join(workdir, f"shard{s}.bin")
        fmt.write_matrix(path, data[lo:hi])
        folders.append(os.path.join(workdir, f"cli_shard{s}"))
        cmds.append([sys.executable, "-m",
                     "sptag_tpu_torch.tools.index_builder", "-d", str(d),
                     "-v", "Float", "-i", "BIN:" + path, "-o", folders[-1],
                     "-a", "BKT", "-t", str(CLI_THREADS)]
                    + [f"Index.{k}={v}" for k, v in SHARD_PARAMS])
    builds = []
    for (rc, so, se, wall), cmd in zip(run_processes(cmds, here), cmds):
        m = re.search(r"built index in ([0-9.]+)s on device=(\w+)", se)
        builds.append({"rc": rc, "process_s": wall,
                       "build_s": float(m.group(1)) if m else None,
                       "device": m.group(2) if m else None})
        if rc != 0:
            print(se[-4000:], file=sys.stderr, flush=True)
    out["builds"] = builds
    check(all(b["rc"] == 0 and b["device"] == "cuda" for b in builds),
          f"13a: the builder CLI did not build both shards on cuda: {builds}")
    if any(b["rc"] != 0 for b in builds):
        fail("13a: a shard build failed")

    # the truth file: shard 0's exact top-10 from FLAT on the card
    lo, hi = SHARDS[0]
    q = queries[:CLUSTER_QUERIES]
    flat = pt.create_instance("FLAT", "Float")
    flat.set_parameter("DistCalcMethod", "L2")
    flat.build(data[lo:hi])
    _, truth_ids = flat.search_batch(q, K)
    del flat
    truth_path = os.path.join(workdir, "shard0_truth.txt")
    with open(truth_path, "w") as f:
        for row in truth_ids:
            f.write(" ".join(str(int(v)) for v in row) + "\n")
    qpath = os.path.join(workdir, "queries.bin")
    fmt.write_matrix(qpath, q)
    res_path = os.path.join(workdir, "shard0_results.txt")
    max_check = dict(GRAPH_PARAMS)["MaxCheck"]
    (rc, so, se, wall), = run_processes([[
        sys.executable, "-m", "sptag_tpu_torch.tools.index_searcher", "-x",
        folders[0], "-q", "BIN:" + qpath, "-r", truth_path, "-k", str(K),
        "-m", max_check, "-b", str(CLUSTER_QUERIES), "-o", res_path]], here)
    rows = [ln.split() for ln in so.splitlines()
            if ln.split() and ln.split()[0] == max_check]
    cli_recall = float(rows[0][4]) if rows else None
    cli_qps = float(rows[0][6]) if rows else None
    if rc != 0:
        print(se[-4000:], file=sys.stderr, flush=True)
    loaded = pt.load_index(folders[0])
    loaded.set_parameter("MaxCheck", max_check)
    _, ids = loaded.search_batch(q, K)
    recall = calc_recall(ids, load_truth(truth_path, K), K)
    cli_ids = np.loadtxt(res_path, dtype=np.int64, ndmin=2) \
        if rc == 0 else None
    out["searcher"] = {"rc": rc, "process_s": wall,
                       "recall_at_10": cli_recall, "qps": cli_qps,
                       "in_process_recall_at_10": recall,
                       "ids_equal_in_process": bool(
                           cli_ids is not None
                           and np.array_equal(cli_ids, ids))}
    check(rc == 0 and cli_recall is not None
          and cli_recall == float(f"{recall:.4f}")
          and out["searcher"]["ids_equal_in_process"],
          f"13a: the searcher CLI's recall {cli_recall} (ids equal "
          f"{out['searcher']['ids_equal_in_process']}) is not the "
          f"in-process recall {recall}")
    out["folders"] = folders
    out["loaded"] = loaded
    return out


def resume_phase(pt, block_dots, data, cli_loaded, cli_folder, workdir):
    """13b: shard 0 built in-process with checkpoint_dir, interrupted at
    its first refine pass (refine_once raising, as
    tests/test_build_ckpt.py does), resumed, and built again without an
    interruption; the resumed graph and tree are held equal to 13a's CLI
    folder."""
    from sptag_tpu_torch.graph.rng import RelativeNeighborhoodGraph as RNG

    lo, hi = SHARDS[0]
    rows = data[lo:hi]

    def make():
        idx = pt.create_instance("BKT", "Float")
        for name, value in SHARD_PARAMS + [("NumberOfThreads",
                                            str(CLI_THREADS))]:
            if not idx.set_parameter(name, value):
                fail(f"set_parameter {name}")
        return idx

    ck = os.path.join(workdir, "ckpt")
    real = RNG.refine_once
    calls = {"n": 0}

    def interrupted(self, *a, **kw):
        calls["n"] += 1
        raise RuntimeError("interrupted at the first refine pass")

    RNG.refine_once = interrupted
    t0 = time.perf_counter()
    try:
        make().build(rows, checkpoint_dir=ck)
        fail("13b: the interrupted build did not raise")
    except RuntimeError:
        pass
    finally:
        RNG.refine_once = real
    torch.cuda.synchronize()
    interrupted_s = time.perf_counter() - t0
    stages = sorted(os.listdir(os.path.join(ck, os.listdir(ck)[0])))
    resumed = make()
    t0 = time.perf_counter()
    with FirstCalls(block_dots) as first:
        resumed.build(rows, checkpoint_dir=ck)
        torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    plain = make()
    t0 = time.perf_counter()
    plain.build(rows, checkpoint_dir=os.path.join(workdir, "ckpt_plain"))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    folder = os.path.join(workdir, "resumed_shard0")
    resumed.save_index(folder)
    files = {}
    for name in (resumed.params.tree_file, resumed.params.graph_file):
        with open(os.path.join(folder, name), "rb") as a, \
                open(os.path.join(cli_folder, name), "rb") as b:
            files[name] = a.read() == b.read()
    out = {"interrupted_s": interrupted_s, "resumed_s": resumed_s,
           "uninterrupted_s": plain_s, "stages_at_interrupt": stages,
           "refine_calls_before_interrupt": calls["n"],
           "build_resumed": bool(resumed.build_resumed),
           "graph_equal_cli": bool(np.array_equal(resumed._graph,
                                                  cli_loaded._graph)),
           "graph_equal_uninterrupted": bool(np.array_equal(
               resumed._graph, plain._graph)),
           "files_equal_cli": files,
           "checkpoints_left": sorted(os.listdir(ck))}
    check(out["build_resumed"] and out["graph_equal_cli"]
          and all(files.values()) and not out["checkpoints_left"],
          f"13b: resumed build {out}")
    for idx in (resumed, plain):
        idx.close()
    return out, first


def ann_client_search(addr, q, mode, clients=CLUSTER_CLIENTS):
    """Every query through `clients` wrappers.AnnClient connections, one
    query at a time each, with metadata: (results, per-query seconds,
    wall seconds)."""
    import threading

    from sptag_tpu_torch.wrappers import AnnClient

    results, lat = [None] * len(q), [0.0] * len(q)

    def worker(w):
        c = AnnClient(addr[0], addr[1])
        c.SetTimeoutMilliseconds(120_000)
        c.SetSearchParam("searchmode", mode)
        try:
            for i in range(w, len(q), clients):
                t0 = time.perf_counter()
                results[i] = c.Search(q[i], K, "Float", True)
                lat[i] = time.perf_counter() - t0
        finally:
            c._transport.close()

    threads = [threading.Thread(target=worker, args=(w,),
                                name=f"chip-smoke-annclient-{w}")
               for w in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, np.asarray(lat), time.perf_counter() - t0


def merged_arrays(results):
    """(dists, global ids from the metadata, failures) of merged replies."""
    from sptag_tpu_torch.serve import wire

    ids = np.full((len(results), K), -1, np.int64)
    d = np.full((len(results), K), np.inf)
    bad = 0
    for i, r in enumerate(results):
        if r is None or r.status != wire.ResultStatus.Success \
                or len(r.results) != 1 or not r.results[0].metas:
            bad += 1
            continue
        row = r.results[0]
        ids[i, :len(row.metas)] = [int(m) for m in row.metas]
        d[i, :len(row.dists)] = row.dists
    return d, ids, bad


def in_process_merge(shard_results):
    """The two shards' search_batch results merged as merge_top_k does:
    global ids, ascending (distance, shard-local id)."""
    ds, gs, ls = [], [], []
    for (lo, _), (d, ids) in zip(SHARDS, shard_results):
        ds.append(d)
        ls.append(ids)
        gs.append(np.where(ids >= 0, ids + lo, -1))
    d, g, loc = (np.concatenate(a, axis=1) for a in (ds, gs, ls))
    d = np.where(g >= 0, d, np.inf)
    order = np.lexsort((loc, d), axis=1)[:, :K]
    return (np.take_along_axis(d, order, 1),
            np.take_along_axis(g, order, 1))


def write_shard_ini(path, folder, extra="", port=0):
    with open(path, "w") as f:
        f.write(f"[Service]\nListenAddr=127.0.0.1\nListenPort={port}\n"
                "AllowSearchModeOverride=on\n" + extra +
                f"[QueryConfig]\nDefaultMaxResultNumber={K}\n"
                "[Index]\nList=main\n"
                f"[Index_main]\nIndexFolder={folder}\n")


def http_get(port, path, timeout=120):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_listening(port, proc, what, timeout_s=180.0) -> None:
    import socket

    t_end = time.perf_counter() + timeout_s
    while time.perf_counter() < t_end:
        if proc.poll() is not None:
            fail(f"13d: the {what} exited with {proc.returncode}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.2)
    fail(f"13d: the {what} did not listen on {port}")


def control_phase(queries, serve_folders, workdir, here) -> dict:
    """13d: each shard's ``python -m sptag_tpu_torch.serve.server`` and
    ``python -m sptag_tpu_torch.serve.aggregator`` as processes of their
    own with AdmissionControl, a tight SLO p99 objective (so that the
    burn-rate engine pages and the controller acts), canaries, the
    controller and the metrics listener; the shards warmed directly, then
    phase 12d's ramp through the aggregator, a device trace taken under
    load on shard 0's listener and an overlapping one; SIGTERM ends each
    process, which must exit 0."""
    import threading

    from sptag_tpu_torch.serve import wire

    # the controller's MaxCheck floor is the shards' MaxCheck: it pages and
    # audits its holds, but new walk plans (and their graph captures) do
    # not enter the ramp
    control = (f"AdmissionControl=1\nSloP99Ms={CLUSTER_SLO_P99_MS}\n"
               "SloFastWindowS=5\nSloSlowWindowS=10\n"
               f"CanaryIntervalMs={CANARY_MS}\nController=1\n"
               "ControllerCooldownMs=2000\nControllerMaxCheckFloor="
               f"{dict(GRAPH_PARAMS)['MaxCheck']}\n")
    procs, ports, mports = {}, {}, {}
    logs = {}

    def start(name, module, ini):
        logs[name] = open(os.path.join(workdir, f"{name}.log"), "w")
        # -X faulthandler: a fatal signal leaves the threads' stacks in
        # the process's log, which a failed check prints
        procs[name] = subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-m", module, "-c", ini]
            + (["-m", "socket"] if module.endswith("server") else []),
            cwd=here, stdout=logs[name], stderr=subprocess.STDOUT)

    for s, folder in enumerate(serve_folders):
        name = f"server{s}"
        ports[name], mports[name] = free_port(), free_port()
        ini = os.path.join(workdir, f"{name}_control.ini")
        write_shard_ini(ini, folder, f"MetricsPort={mports[name]}\n"
                        + control, port=ports[name])
        start(name, "sptag_tpu_torch.serve.server", ini)
    t0 = time.perf_counter()
    for name in ("server0", "server1"):
        wait_listening(ports[name], procs[name], name)
    servers_up_s = time.perf_counter() - t0
    # warm each shard directly (first walks, graph captures at the ramp's
    # padded sizes), as an operator does before it takes traffic
    for name in ("server0", "server1"):
        for opt in RAMP_OPTIONS:
            for burst in (1, 4, 16, 64):
                for _ in range(2):
                    pool_search(("127.0.0.1", ports[name]), [
                        "$indexname:main " + opt + b64_query(v)
                        for v in queries[:burst]])
    probe_file = os.path.join(workdir, "canary_probes.txt")
    with open(probe_file, "w") as f:
        for v in queries[:8]:
            f.write(f"$resultnum:{K} {b64_query(v)}\n")
    ports["aggregator"], mports["aggregator"] = free_port(), free_port()
    agg_ini = os.path.join(workdir, "aggregator.ini")
    with open(agg_ini, "w") as f:
        f.write("[Service]\nListenAddr=127.0.0.1\n"
                f"ListenPort={ports['aggregator']}\nSearchTimeout=120\n"
                f"MergeTopK=true\nMetricsPort={mports['aggregator']}\n"
                + control + f"CanaryProbeFile={probe_file}\n"
                f"CanaryK={K}\n[Servers]\nNumber=2\n"
                f"[Server_0]\nAddress=127.0.0.1\nPort={ports['server0']}\n"
                f"[Server_1]\nAddress=127.0.0.1\nPort={ports['server1']}\n")
    start("aggregator", "sptag_tpu_torch.serve.aggregator", agg_ini)
    wait_listening(ports["aggregator"], procs["aggregator"], "aggregator")

    mport0 = mports["server0"]

    def take_trace(trace_dir):
        """One 200 ms trace on shard 0's listener and an overlapping one:
        the first's status, wall seconds and failure body, the
        overlapping one's status, the trace's events, kernel events and
        the path's kernel names."""
        first = {}

        def long_get():
            try:
                first["r"] = http_get(
                    mport0,
                    f"/debug/devicetrace?duration_ms=200&dir={trace_dir}",
                    timeout=60)
            except OSError as e:                         # timed out
                first["r"] = (None, repr(e).encode())

        t = threading.Thread(target=long_get, name="chip-smoke-trace")
        t0 = time.perf_counter()
        t.start()
        # the trace runs in the server process: wait for its directory
        t_end = time.perf_counter() + 30
        while not os.path.isdir(trace_dir) and t.is_alive() \
                and time.perf_counter() < t_end:
            time.sleep(0.002)
        try:
            second = http_get(mport0, "/debug/devicetrace?duration_ms=50",
                              timeout=60)[0]
        except OSError:
            second = None
        t.join(90)
        seconds = time.perf_counter() - t0
        status, body = first.get("r", (None, b""))
        events, names = [], set()
        trace_json = os.path.join(trace_dir, "trace.json")
        if os.path.exists(trace_json):
            with open(trace_json) as f:
                events = json.load(f).get("traceEvents", [])
            names = {ev.get("name", "") for ev in events}
        return {"first": status, "seconds": seconds,
                "error": (None if status == 200
                          else body[:400].decode("utf8", "replace")),
                "overlapping": second, "events": len(events),
                "kernel_events_all": sum(ev.get("cat") == "kernel"
                                         for ev in events),
                "kernel_events": sorted(
                    n for n in names if "walk_score_kernel" in n
                    or "block_major_f32_kernel" in n)}

    admission_at_step = []

    def on_step(i):
        admission_at_step.append({
            n: {k: v for k, v in json.loads(http_get(
                mports[n], "/debug/admission")[1]).items()
                if k in ("state", "signals")}
            for n in ("server0", "aggregator")})

    ramp = open_loop_ramp(
        ("127.0.0.1", ports["aggregator"]), queries, [],
        {"tier": "aggregator"}, max_misses=CLUSTER_RAMP_STEPS,
        max_steps=CLUSTER_RAMP_STEPS, profile_first=False, on_step=on_step,
        phase="13d", connections=CLUSTER_RAMP_CONNECTIONS,
        allowed=(wire.ResultStatus.Success, wire.ResultStatus.Overloaded))

    def scrape(name):
        code, body = http_get(mports[name], "/metrics")
        series, bad = set(), 0
        for ln in body.decode().splitlines():
            if not ln or ln.startswith("#"):
                continue
            key, _, value = ln.rpartition(" ")
            try:
                float(value)
            except ValueError:
                bad += 1
                continue
            series.add(key)
        return {"status": code, "unparsed": bad,
                "series": {p: sum(1 for n in series if n.startswith(p))
                           for p in CONTROL_SERIES}}

    def debug(name, route):
        return json.loads(http_get(mports[name], route)[1])

    tiers = ("server0", "server1", "aggregator")
    metrics_out = {n: scrape(n) for n in tiers}
    slo = {n: debug(n, "/debug/slo") for n in tiers}
    canaries = {n: {k: (v["probes"], v["failures"]) for k, v in
                    slo[n].get("canary", {}).get("indexes", {}).items()}
                for n in tiers}
    adm = {n: debug(n, "/debug/admission") for n in tiers}
    ctl = {n: debug(n, "/debug/controller") for n in tiers}
    mem = {n: debug(n, "/debug/memory") for n in ("server0", "server1")}
    # the device trace last: a profile slows its process for seconds
    # (the profiler's stop), and the tiers' admission reads lifetime
    # latency percentiles (ROADMAP.md section 3).  Load goes to shard 0
    # directly while it runs, beam and dense
    from sptag_tpu_torch.serve.client import AnnClientPool

    stop_load = threading.Event()
    trace_load = {"requests": 0, "errors": 0, "overloaded": 0}

    def load():
        pool = AnnClientPool("127.0.0.1", ports["server0"], connections=4,
                             timeout_s=120.0)
        pool.connect()
        i = 0
        try:
            while not stop_load.is_set():
                opt = ("$searchmode:dense ", "")[i % 2]
                lo = (i * 16) % 4000
                futs = [pool.search_async("$indexname:main " + opt
                                          + b64_query(v))
                        for v in queries[lo:lo + 16]]
                for f in futs:
                    try:
                        status = f.result().status
                    except Exception:                    # noqa: BLE001
                        status = None
                    trace_load["requests"] += 1
                    trace_load["overloaded"] += (
                        status == wire.ResultStatus.Overloaded)
                    trace_load["errors"] += status not in (
                        wire.ResultStatus.Success,
                        wire.ResultStatus.Overloaded)
                i += 1
        finally:
            pool.close()

    loader = threading.Thread(target=load, name="chip-smoke-trace-load")
    loader.start()
    time.sleep(0.2)
    traces = []
    for i in range(DEVICE_TRACES):
        traces.append(take_trace(os.path.join(workdir, f"devicetrace{i}")))
        if procs["server0"].poll() is not None or traces[-1]["first"] is None:
            break
    stop_load.set()
    loader.join(120)
    exit_codes = {}
    for name in ("aggregator", "server0", "server1"):
        procs[name].terminate()
        try:
            exit_codes[name] = procs[name].wait(timeout=60)
        except subprocess.TimeoutExpired:
            # hung: SIGABRT makes faulthandler write every thread's stack
            # into the log before the process dies
            procs[name].send_signal(signal.SIGABRT)
            try:
                exit_codes[name] = procs[name].wait(timeout=20)
            except subprocess.TimeoutExpired:
                procs[name].kill()
                exit_codes[name] = procs[name].wait()
        logs[name].close()
    out = {"servers_up_s": servers_up_s, "ramp": ramp,
           "admission_at_step": admission_at_step,
           "sheds": {n: adm[n].get("counters", {}).get("sheds")
                     for n in tiers},
           "admission_state": {n: adm[n].get("state") for n in tiers},
           "slo_state": {n: {k: v.get("state") for k, v in
                             slo[n].get("objectives", {}).items()}
                         for n in tiers},
           "controller_decisions": {
               n: ctl[n].get("audit", {}).get("counters") for n in tiers},
           "controller_epoch": {n: ctl[n].get("epoch") for n in tiers},
           "canary_probes_failures": canaries, "metrics": metrics_out,
           "memory": {n: {"components": m["components"],
                          "ledger_device_bytes": m["ledger_device_bytes"],
                          "memory_allocated": m.get("live_arrays_bytes"),
                          "allocated_minus_ledger": m.get("untracked_bytes")}
                      for n, m in mem.items()},
           "devicetrace": {"traces": traces, "load": trace_load},
           "exit_codes": exit_codes}
    overloaded = int(wire.ResultStatus.Overloaded)
    # past the knee a request may still be on its way when a step's drain
    # window ends (`unanswered`, printed); none may fail
    check(ramp["errors"] == 0,
          f"13d: requests failed other than by admission's overload status "
          f"({overloaded}): {ramp['statuses']}")
    check(all(c and all(p > 0 and f == 0 for p, f in c.values())
              for c in canaries.values()),
          f"13d: canary probes failed or none ran: {canaries}")
    check(all(m["status"] == 200 and m["unparsed"] == 0
              for m in metrics_out.values())
          and all(metrics_out["server0"]["series"].values()),
          f"13d: /metrics {metrics_out}")
    check(all(set(m["components"]) <= JAX_COMPONENTS
              and {"corpus", "graph", "tree"} <= set(m["components"])
              and m.get("live_arrays_bytes") is not None
              and m["ledger_device_bytes"] <= m["live_arrays_bytes"]
              for m in mem.values()),
          f"13d: /debug/memory {out['memory']}")
    check(len(traces) == DEVICE_TRACES
          and all(t["first"] == 200 and t["overlapping"] == 409
                  and t["kernel_events"] for t in traces)
          and trace_load["errors"] == 0,
          f"13d: device traces {out['devicetrace']}")
    check(all(rc == 0 for rc in exit_codes.values()),
          f"13d: exit codes {exit_codes}")
    for name, rc in exit_codes.items():
        if rc != 0:
            with open(os.path.join(workdir, f"{name}.log")) as f:
                print(f"chip_smoke: 13d: the end of the {name}'s log:\n"
                      + f.read()[-12000:], file=sys.stderr, flush=True)
    return out


def cluster_phase(pt, block_dots, walk_ops, data, queries, truth, workdir,
                  here) -> tuple:
    """Phase 13 on the f32 L2 headline cut into two shards: (a) the CLIs,
    (b) a resumable build, (c) two port servers behind the port's
    aggregator with MergeTopK, (d) the control plane under the open-loop
    ramp, (e) AnnIndex, (f) a clean stop.  Returns the first block-dot
    calls of 13b's build and of 13c's dense requests and the launches of
    13b-13e (in-process), for phase 2's rows, and 13c's shard folders,
    merged beam recall and in-process merge (phase 15c's mesh)."""
    import contextlib
    import threading

    from sptag_tpu_torch.serve import aggregator as sagg
    from sptag_tpu_torch.serve import server as sserver
    from sptag_tpu_torch.serve import service as sservice
    from sptag_tpu_torch.utils import devmem
    from sptag_tpu_torch.utils import trace as trace_mod
    from sptag_tpu_torch.wrappers import AnnIndex

    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    q = queries[:CLUSTER_QUERIES]

    # ---- 13a: the CLIs ------------------------------------------------------
    out_a = cli_phase(pt, data, queries, workdir, here)
    cli_loaded = out_a.pop("loaded")
    cli_folders = out_a.pop("folders")
    emit({"phase": "13a", **out_a})

    # ---- 13b: a resumable build (launches counted from here on) ------------
    block_dots.reset_launch_counts()
    walk_ops.reset_launch_counts()
    out_b, first_b = resume_phase(pt, block_dots, data, cli_loaded,
                                  cli_folders[0], workdir)
    emit({"phase": "13b", **out_b})
    cli_loaded.close()
    del cli_loaded

    # ---- 13c: two servers behind the aggregator ----------------------------
    # the CLI folders with each row's global id as its metadata
    serve_folders, ctxs = [], []
    for s, ((lo, hi), folder) in enumerate(zip(SHARDS, cli_folders)):
        idx = pt.load_index(folder)
        idx.metadata = pt.MetadataSet(str(i).encode()
                                      for i in range(lo, hi))
        serve_folders.append(os.path.join(workdir, f"serve_shard{s}"))
        if idx.save_index(serve_folders[-1]) != pt.ErrorCode.Success:
            fail("13c: save_index of a shard with metadata")
        idx.close()
        ini = os.path.join(workdir, f"shard{s}.ini")
        write_shard_ini(ini, serve_folders[-1])
        ctxs.append(sservice.ServiceContext.from_ini(ini))
    refs = {m: [c.indexes["main"].search_batch(q, K, search_mode=m)
                for c in ctxs] for m in ("beam", "dense")}
    runs = [ServerRunner(sserver.SearchServer(c)) for c in ctxs]
    actx = sagg.AggregatorContext(listen_addr="127.0.0.1",
                                  search_timeout_s=120.0, merge_top_k=True)
    actx.servers = [sagg.RemoteServer(*r.addr) for r in runs]
    agg = ServerRunner(sagg.AggregatorService(actx))
    out_c = {}
    # the dense requests' first block-dot call, for phase 2
    first_c = FirstCalls(block_dots)
    for mode in ("beam", "dense"):
        with first_c if mode == "dense" else contextlib.nullcontext():
            res, lat, wall = ann_client_search(agg.addr, q, mode)
        d, ids, bad = merged_arrays(res)
        ref_d, ref_i = in_process_merge(refs[mode])
        row = hold_parity(f"13c {mode}", d, ids, bad, ref_d, ref_i, data, q)
        row.update({"recall_at_10": recall_at_k(ids, truth[:len(q)]),
                    "qps": len(q) / wall, "wall_s": wall,
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                    "p99_ms": float(np.percentile(lat, 99)) * 1e3})
        out_c[mode] = row
    agg.stop()
    for r in runs:
        r.stop()
    emit({"phase": "13c", "clients": CLUSTER_CLIENTS, **out_c})
    # for phase 15c's mesh over the same two folders
    out13 = {"serve_folders": serve_folders,
             "beam_recall": out_c["beam"]["recall_at_10"],
             "beam_merge": in_process_merge(refs["beam"])}

    # ---- 13d: the control plane under the ramp -----------------------------
    # a restart: each tier its own process, so that no tier reads the
    # latency histograms earlier phases left in this one's registry
    for c in ctxs:
        for i in c.indexes.values():
            i.close()
    del ctxs, refs
    out_d = control_phase(queries, serve_folders, workdir, here)
    emit({"phase": "13d", **out_d})

    # ---- 13e: AnnIndex ----------------------------------------------------
    ann = AnnIndex.Load(serve_folders[0])
    index = ann.index
    _, want = index.search_batch(q, K)
    t0 = time.perf_counter()
    lone = np.asarray([ann.Search(v, K).ids for v in q])
    lone_s = time.perf_counter() - t0
    with_meta = [ann.SearchWithMetaData(v, K) for v in q]
    meta_ids = np.asarray([r.ids for r in with_meta])
    metas_ok = all(m == str(int(i) + SHARDS[0][0]).encode()
                   for r in with_meta for i, m in zip(r.ids, r.metas)
                   if i >= 0)
    batch = ann.BatchSearch(q, len(q), K, True)
    added = make_dataset(n=ANN_ADDS, d=data.shape[1], nq=1, seed=11)[0]
    n0 = index.num_samples
    meta_blob = b"".join(f"added{i}\n".encode() for i in range(ANN_ADDS))
    add_ok = ann.AddWithMetaData(added, meta_blob, ANN_ADDS)
    _, found = index.search_batch(added, 1)
    _, found_x = index.exact_search_batch(added, 1)
    new_ids = np.arange(n0, n0 + ANN_ADDS)
    victims = data[SHARDS[0][0]:SHARDS[0][0] + ANN_DELETES]
    del_ok = ann.Delete(victims, ANN_DELETES)
    # a delete by content removes the rows its search finds
    gone = np.asarray([i for i in range(ANN_DELETES)
                       if not index.contains_sample(i)])
    _, vic = index.search_batch(victims, K)
    _, before = index.search_batch(q, K)
    folder = os.path.join(workdir, "annindex_saved")
    save_ok = ann.Save(folder)
    again = AnnIndex.Load(folder)
    _, after = again.index.search_batch(q, K)
    out_e = {"lone_search_s": lone_s,
             "search_ids_equal": bool(np.array_equal(lone, want)),
             "search_with_metadata_ids_equal": bool(
                 np.array_equal(meta_ids, want)),
             "metadata_is_global_id": metas_ok,
             "batch_search_ids_equal": bool(np.array_equal(
                 np.asarray([r.ids for r in batch]), want)),
             "add": add_ok, "delete": del_ok, "save": save_ok,
             "added_found_by_search": float(np.mean(found[:, 0] == new_ids)),
             "added_found_by_exact": float(np.mean(found_x[:, 0]
                                                   == new_ids)),
             "deleted": len(gone),
             "deleted_returned": int(np.isin(vic, gone).sum()
                                     + np.isin(before, gone).sum()),
             "ids_equal_after_save_load": bool(np.array_equal(before,
                                                              after))}
    emit({"phase": "13e", **out_e})
    check(out_e["search_ids_equal"]
          and out_e["search_with_metadata_ids_equal"] and metas_ok
          and out_e["batch_search_ids_equal"] and add_ok and del_ok
          and save_ok and out_e["added_found_by_exact"] == 1.0
          and len(gone) > 0 and out_e["deleted_returned"] == 0
          and out_e["ids_equal_after_save_load"],
          f"13e: AnnIndex {out_e}")
    launches = {**block_dots.launch_counts(), **walk_ops.launch_counts()}
    for i in (index, again.index):
        i.close()
    del ann, again, index

    # ---- 13f: a clean stop ------------------------------------------------
    t_end = time.perf_counter() + 15
    while True:
        left = [t.name for t in threading.enumerate()
                if t.is_alive() and t not in threads_before and (
                    not t.daemon or t.name.startswith(
                        ("beam-sched", "sptag-serve", "canary",
                         "metrics-http")))]
        if not left or time.perf_counter() > t_end:
            break
        time.sleep(0.1)
    subprocesses_ok = all(b["rc"] == 0 for b in out_a["builds"]) \
        and out_a["searcher"]["rc"] == 0 \
        and all(rc == 0 for rc in out_d["exit_codes"].values())
    emit({"phase": "13f", "threads_left": left,
          "subprocesses_exit_0": subprocesses_ok,
          "exit_codes": {**{f"builder{i}": b["rc"]
                            for i, b in enumerate(out_a["builds"])},
                         "searcher": out_a["searcher"]["rc"],
                         **out_d["exit_codes"]},
          "tracing_after": trace_mod.tracing(),
          "launches_13b_13e": launches,
          "wall_s": time.perf_counter() - t_phase,
          "ledger_components_after": devmem.component_bytes()})
    check(not left and subprocesses_ok and not trace_mod.tracing(),
          f"13f: threads left {left}, subprocesses exit 0 "
          f"{subprocesses_ok}")
    return first_b, first_c, launches, out13


# ---- phase 14: the tiered corpus cascade -------------------------------------

# bench.py's capacity stage (_capacity_measure): per-tier budgets
CASCADE_B1, CASCADE_B2 = 8192, 1024
# recall@10 floor of every cascade configuration of 14a (the JAX package
# reached 1.000 at 50k rows)
CASCADE_RECALL_MIN = 0.97
# the fp re-rank budget of the dense cascade (14b), JAX's own test value
CASCADE_DENSE_B2 = 128
# 14f: host_all FLAT at this many rows
CAPACITY_N = 1_000_000


class FirstCascadeCalls:
    """Inside the ``with`` block, records the arguments of the main path's
    first call of each cascade kernel with at least `min_q` queries: the
    Hamming scan, the gathered int8 tier (GATHER), the int8 walk scoring
    (GATHER) and the block-dot kernels on int8 blocks with float32
    queries, for phase 2 to hold each against its plain version at the
    path's shapes.  The wrappers run unchanged and count their launches as
    always; the large row sources are kept by reference, not copied."""

    def __init__(self, min_q: int = 1024):
        from sptag_tpu_torch.ops import (block_dots, int8_dots, sketch_dots,
                                         walk_dots)

        self.min_q = min_q
        # the first call of each int8 kernel variant the main path runs
        # ((kernel, mode, epilogue, D, ids or mask) -> arguments), for
        # phase 2 to hold each bit for bit
        self.variants = {}
        self.targets = [(sketch_dots, "hamming", "sketch_hamming"),
                        (int8_dots, "int8_gather_dots", "int8_gather_dots"),
                        (walk_dots, "walk_score", "walk_score_i8"),
                        (block_dots, "probe_block_dots",
                         "probe_block_dots_f32i8"),
                        (block_dots, "group_block_dots",
                         "group_block_dots_f32i8")]
        self.args, self.saved = {}, []

    def _take(self, name, a) -> bool:
        if name in self.args or a[0].device.type != "cuda":
            return False
        if name == "sketch_hamming":
            return a[0].shape[0] >= self.min_q
        if name == "int8_gather_dots":
            return a[0].shape[0] >= self.min_q and a[9] == 0
        if name == "walk_score_i8":
            return (a[1].dtype == torch.int8 and a[0].shape[0] >= self.min_q
                    and a[5] == 0)
        # block dots: a[0] blocks, a[1] queries
        return (a[0].dtype == torch.int8 and a[1].dtype == torch.float32
                and a[1].shape[0] >= self.min_q)

    @staticmethod
    def _variant(name, a):
        """The int8 kernels' variant key of a card call, else None."""
        if a[0].device.type != "cuda":
            return None
        if name == "int8_gather_dots":
            return (name, a[9], a[7], a[0].shape[1], a[5] is not None)
        if name == "walk_score_i8" and a[1].dtype == torch.int8:
            return (name, a[5], a[4], a[0].shape[1], a[2] is not None)
        return None

    def __enter__(self):
        keep = {"sketch_hamming": (1, 2), "int8_gather_dots": (3, 5),
                "walk_score_i8": (1, 3), "probe_block_dots_f32i8": (0,),
                "group_block_dots_f32i8": (0,)}
        for module, attr, name in self.targets:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def wrapper(*a, _fn=fn, _name=name):
                key = self._variant(_name, a)
                if self._take(_name, a) or (key is not None
                                            and key not in self.variants):
                    args = tuple(
                        t.clone() if isinstance(t, torch.Tensor)
                        and k not in keep[_name] else t
                        for k, t in enumerate(a))
                    if self._take(_name, a):
                        self.args[_name] = args
                    if key is not None:
                        self.variants.setdefault(key, args)
                return _fn(*a)
            setattr(module, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)


def timed_search(index, queries, batch=1024, **kw):
    """One pass in batches: (dists, ids, per-batch wall seconds)."""
    ds, ids, times = [], [], []
    for lo in range(0, len(queries), batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = index.search_batch(queries[lo:lo + batch], K, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        ds.append(d)
        ids.append(i)
    return np.concatenate(ds), np.concatenate(ids), times


def ledger_reading():
    """(device bytes, host bytes, component bytes) off the memory ledger,
    after a garbage collection."""
    import gc

    from sptag_tpu_torch.utils import devmem

    gc.collect()
    torch.cuda.synchronize()
    dev = devmem.device_bytes()
    return dev, devmem.total_bytes() - dev, devmem.component_bytes()


def ledger_delta(before, after) -> dict:
    comp = {c: after[2].get(c, 0) - before[2].get(c, 0)
            for c in set(after[2]) | set(before[2])}
    return {"device_bytes": int(after[0] - before[0]),
            "host_bytes": int(after[1] - before[1]),
            "components": {c: int(v) for c, v in sorted(comp.items())
                           if v}}


def cascade_flat_phase(pt, data, queries, truth, workdir) -> dict:
    """14a: bench.py's capacity configurations on FLAT over the phase-3
    corpus, and the sketch prefilter with its saved calibration."""
    from sptag_tpu_torch.ops import sketch_dots

    n, dim = data.shape
    b1, b2 = CASCADE_B1, CASCADE_B2
    tiers = {"CascadeSearch": "1", "TierBudgetSketch": str(b1),
             "TierBudgetInt8": str(b2)}
    configs = [("fp_only", {}),
               ("int8_fp", {**tiers, "TierBudgetSketch": str(2 * n)}),
               ("cascade", tiers),
               ("host", {**tiers, "CorpusTier": "host"}),
               ("host_all", {**tiers, "CorpusTier": "host_all"})]
    n_pad = -(-n // 128) * 128
    w = (dim + 31) // 32
    out, res = {"n": n, "queries": len(queries), "tier_budget_sketch": b1,
                "tier_budget_int8": b2, "rows": {}}, {}
    for label, params in configs:
        before = ledger_reading()
        fidx = pt.create_instance("FLAT", "Float")
        fidx.set_parameter("DistCalcMethod", "L2")
        for name, value in params.items():
            fidx.set_parameter(name, value)
        t0 = time.perf_counter()
        fidx.build(data)
        fidx.search_batch(queries[:1024], K)     # materializes the tiers
        first_s = time.perf_counter() - t0
        d, ids, times = timed_search(fidx, queries)
        usage = ledger_delta(before, ledger_reading())
        res[label] = (d, ids)
        rec = recall_at_k(ids, truth)
        out["rows"][label] = {
            "recall_at_10": rec, "build_and_first_batch_s": first_s,
            **batch_stats(times, 1024), **usage,
            "vectors_per_gb": n / max(usage["device_bytes"], 1) * 1e9}
        del fidx
    rows = out["rows"]
    fp_dev = max(rows["fp_only"]["device_bytes"], 1)
    for label in ("int8_fp", "cascade", "host", "host_all"):
        rows[label]["capacity_ratio_vs_fp"] = (
            fp_dev / max(rows[label]["device_bytes"], 1))
    same = {t: bool(np.array_equal(res[t][1], res["cascade"][1])
                    and res[t][0].tobytes() == res["cascade"][0].tobytes())
            for t in ("host", "host_all")}
    fp_host_side = {t: (rows[t]["host_bytes"] >= n * dim * 4
                        and "corpus" not in rows[t]["components"])
                    for t in ("host", "host_all")}
    host_all_bound = n_pad * (4 * w + 1) + 4 * dim + (1 << 20)
    out.update({"host_tiers_equal_device_bitwise": same,
                "fp_bytes_host_side_only": fp_host_side,
                "host_all_device_bound": host_all_bound})
    check(all(same.values()),
          f"14a: host tiers differ from the device tier {same}")
    check(all(fp_host_side.values()),
          f"14a: fp bytes not host-side only {fp_host_side}")
    check(0 < rows["host_all"]["device_bytes"] <= host_all_bound,
          f"14a: host_all device bytes {rows['host_all']['device_bytes']} "
          f"above {host_all_bound}")
    low = {t: rows[t]["recall_at_10"] for t in ("int8_fp", "cascade",
                                                "host", "host_all")
           if rows[t]["recall_at_10"] < CASCADE_RECALL_MIN}
    check(not low, f"14a: cascade recall@10 below {CASCADE_RECALL_MIN}: "
                   f"{low}")

    # the sketch prefilter: calibrated, then SketchRerank=4096; the saved
    # calibration reused by a loaded index (one Hamming launch a chunk: no
    # calibration scan)
    sidx = pt.create_instance("FLAT", "Float")
    sidx.set_parameter("DistCalcMethod", "L2")
    sidx.set_parameter("SketchPrefilter", "true")
    sidx.build(data)
    h0 = sketch_dots.launch_counts()["sketch_hamming"]
    t0 = time.perf_counter()
    _, ids_first = sidx.search_batch(queries[:1024], K)
    first_s = time.perf_counter() - t0
    cal_launches = sketch_dots.launch_counts()["sketch_hamming"] - h0
    cal_r = sidx._sketch[3]
    _, ids_s, times_s = timed_search(sidx, queries)
    folder = os.path.join(workdir, "flat_sketch")
    check(sidx.save_index(folder) == pt.ErrorCode.Success, "14a: save")
    cal_file = os.path.exists(os.path.join(folder, "sketch_cal.bin"))
    loaded = pt.load_index(folder)
    h0 = sketch_dots.launch_counts()["sketch_hamming"]
    _, ids_l = loaded.search_batch(queries[:1024], K)
    load_launches = sketch_dots.launch_counts()["sketch_hamming"] - h0
    sidx.set_parameter("SketchRerank", "4096")
    _, ids_r, times_r = timed_search(sidx, queries)
    out["sketch_prefilter"] = {
        "calibrated_rerank": cal_r, "first_batch_s": first_s,
        "hamming_launches_first_batch": cal_launches,
        "recall_at_10": recall_at_k(ids_s, truth),
        **batch_stats(times_s, 1024),
        "sketch_cal_bin_written": cal_file,
        "loaded_calibration": list(loaded._loaded_cal or ()),
        "hamming_launches_first_batch_after_load": load_launches,
        "ids_equal_after_load": bool(np.array_equal(ids_l, ids_first)),
        "rerank_4096": {"recall_at_10": recall_at_k(ids_r, truth),
                        **batch_stats(times_r, 1024)}}
    sp_ = out["sketch_prefilter"]
    check(cal_r and cal_r > 0 and cal_launches == 2 and cal_file
          and load_launches == 1 and sp_["ids_equal_after_load"]
          and sp_["loaded_calibration"][-1:] == [cal_r],
          f"14a: sketch calibration / sketch_cal.bin {sp_}")
    del sidx, loaded
    return out


def grouped_recall(idx, queries, truth) -> dict:
    """The phase-3 queries twice over (8,192: enough a block for groups of
    32) in one grouped call, G = 32 and U = 4 nprobe (an int8 layout
    groups only from G = 32, and G <= U)."""
    idx.set_parameter("DenseQueryGroup", "32")
    idx.set_parameter("DenseUnionFactor", "4")
    q2 = np.concatenate([queries, queries])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids = idx.search_batch(q2, K)
    torch.cuda.synchronize()
    out = {"queries": len(q2), "group": idx.last_effective_group,
           "s": time.perf_counter() - t0,
           "recall_at_10": recall_at_k(ids[:len(queries)], truth)}
    idx.set_parameter("DenseQueryGroup", "0")
    idx.set_parameter("DenseUnionFactor", "2")
    return out


def cascade_dense_phase(idx, queries, truth, recall_off) -> dict:
    """14b: the dense cascade on phase 3's index, both tiers, and the
    grouped scan (the float32 x int8 group kernel) against the same
    grouping without the cascade."""
    out = {"tier_budget_int8": CASCADE_DENSE_B2,
           "grouped_off": grouped_recall(idx, queries, truth)}
    idx.set_parameter("CascadeSearch", "1")
    idx.set_parameter("TierBudgetInt8", str(CASCADE_DENSE_B2))
    res = {}
    for tier in ("device", "host"):
        idx.set_parameter("CorpusTier", tier)
        before = ledger_reading()
        idx.search_batch(queries[:1024], K)          # builds the layout
        d, ids, times = timed_search(idx, queries)
        res[tier] = (d, ids)
        out[tier] = {"recall_at_10": recall_at_k(ids, truth),
                     **batch_stats(times, 1024),
                     **ledger_delta(before, ledger_reading())}
    same = bool(np.array_equal(res["device"][1], res["host"][1])
                and res["device"][0].tobytes() == res["host"][0].tobytes())
    idx.set_parameter("CorpusTier", "device")
    out["grouped"] = grouped_recall(idx, queries, truth)
    idx.set_parameter("CascadeSearch", "0")
    idx.set_parameter("TierBudgetInt8", "0")
    out.update({"recall_off": recall_off,
                "device_host_equal_bitwise": same})
    check(same, "14b: dense cascade device and host tiers differ")
    check(all(out[t]["recall_at_10"] >= recall_off - 0.1
              for t in ("device", "host")),
          f"14b: dense cascade recall below {recall_off} - 0.1: {out}")
    g_off = out["grouped_off"]["recall_at_10"]
    check(out["grouped"]["group"] == 32
          and out["grouped"]["recall_at_10"] >= g_off - 0.1,
          f"14b: grouped dense cascade {out['grouped']} (the same grouping "
          f"without the cascade: {g_off})")
    return out


def cascade_beam_phase(pt, graph_folder, queries, truth, recall_off,
                       workdir) -> dict:
    """14c: the beam cascade on phase 7's loaded folder: both tiers, the
    segmented and scheduled walks against the monolithic one, and 1,024
    lone requests through the socket server against search_batch."""
    from sptag_tpu_torch.serve import server as sserver
    from sptag_tpu_torch.serve import service as sservice

    q = queries[:1024]
    g = pt.load_index(graph_folder)
    g.set_parameter("SearchMode", "beam")
    g.set_parameter("CascadeSearch", "1")
    out, res = {"recall_off": recall_off}, {}
    for tier in ("device", "host"):
        g.set_parameter("CorpusTier", tier)
        g.search_batch(q, K)                         # builds the engine
        d, ids, times = timed_search(g, q)
        eng = g._get_engine()
        parts = eng.device_bytes()
        T = eng.walk_plan(K, int(g.get_parameter("MaxCheck")))[3]
        g.set_parameter("BeamSegmentIters", str(max(1, T // 4)))
        ds, ids_s = g.search_batch(q, K)
        g.set_parameter("BeamSegmentIters", "0")
        g.set_parameter("ContinuousBatching", "1")
        dc, ids_c = g.search_batch(q, K)
        g.set_parameter("ContinuousBatching", "0")
        res[tier] = (d, ids)
        out[tier] = {
            "recall_at_10": recall_at_k(ids, truth), **batch_stats(times,
                                                                   1024),
            "engine_device_bytes": parts,
            "host_fp_bytes": (0 if eng.fp_host is None
                              else int(eng.fp_host.nbytes)),
            "segmented_equal": bool(np.array_equal(ids_s, ids)
                                    and ds.tobytes() == d.tobytes()),
            "scheduled_equal": bool(np.array_equal(ids_c, ids)
                                    and dc.tobytes() == d.tobytes())}
        check(out[tier]["segmented_equal"] and out[tier]["scheduled_equal"],
              f"14c {tier}: segmented / scheduled walks differ from the "
              f"monolithic walk")
        check(out[tier]["recall_at_10"] >= recall_off - 0.1,
              f"14c {tier}: beam cascade recall "
              f"{out[tier]['recall_at_10']} below {recall_off} - 0.1")
    # the two tiers walk in different spaces by design (the device tier's
    # in-loop norms are the float32 rows', the host tier's the int8
    # rows'), so their pools may differ; the re-rank is one fixed-order
    # kernel, so an id both return at a rank carries the same bits
    (dd, di), (hd, hi) = res["device"], res["host"]
    both = di == hi
    out["device_host"] = {
        "rows_ids_equal": int(both.all(1).sum()),
        "slots_ids_equal": float(both.mean()),
        "equal_ids_equal_bits": bool((dd[both] == hd[both]).all())}
    check(out["device_host"]["equal_ids_equal_bits"],
          "14c: an id both tiers return carries other distance bits")
    g.close()

    # lone requests through the server, cascade on (device tier)
    ini = os.path.join(workdir, "cascade_service.ini")
    with open(ini, "w") as f:
        f.write("[Service]\nListenAddr=127.0.0.1\nListenPort=0\n"
                f"[QueryConfig]\nDefaultMaxResultNumber={K}\n"
                "[Index]\nList=main\n"
                f"[Index_main]\nIndexFolder={graph_folder}\n")
    ctx = sservice.ServiceContext.from_ini(ini)
    index = ctx.indexes["main"]
    for name, value in (("SearchMode", "beam"), ("CascadeSearch", "1")):
        index.set_parameter(name, value)
    ref_d, ref_i = index.search_batch(q, K)
    run = ServerRunner(sserver.SearchServer(ctx))
    try:
        results, wall = pool_search(run.addr, [
            "$indexname:main $searchmode:beam " + b64_query(v) for v in q])
    finally:
        run.stop()
    d, ids, bad = served_arrays(results, K)
    out["served"] = hold_parity("14c served", d, ids, bad, ref_d, ref_i,
                                index._host, q)
    out["served"].update({"wall_s": wall, "qps": len(q) / wall})
    index.close()
    return out


def cascade_kdt_phase(pt, dist_ops, kfolder) -> dict:
    """14d: the KDT walk with the cascade on phase 10's folder."""
    kq = make_dataset(n=50_000, d=100, nq=200)[1]
    kidx = pt.load_index(kfolder)
    dev = kidx.device
    truth = exact_truth(dist_ops, torch.from_numpy(kidx._host).to(dev),
                        torch.from_numpy(kidx._prepare_query(kq)).to(dev),
                        cosine_base=1)
    kidx.set_parameter("SearchMode", "beam")
    _, ids0 = kidx.search_batch(kq, K)
    out = {"recall_off": recall_at_k(ids0, truth)}
    kidx.set_parameter("CascadeSearch", "1")
    for tier in ("device", "host"):
        kidx.set_parameter("CorpusTier", tier)
        kidx.search_batch(kq, K)
        _, ids, times = timed_search(kidx, kq)
        out[tier] = {"recall_at_10": recall_at_k(ids, truth),
                     **batch_stats(times, len(kq))}
        check(out[tier]["recall_at_10"] >= out["recall_off"] - 0.1,
              f"14d {tier}: KDT cascade recall {out[tier]} below "
              f"{out['recall_off']} - 0.1")
    kidx.close()
    return out


def cascade_mutation_phase(pt, data, queries) -> dict:
    """14e: deletes and delta-shard adds on a FLAT cascade index: every
    tier hides the tombstones and finds the added rows."""
    base_n = min(50_000, len(data))
    rows = data[:base_n]
    q = queries[:256]
    out = {}
    for tier in ("device", "host", "host_all"):
        m = pt.create_instance("FLAT", "Float")
        for name, value in (("DistCalcMethod", "L2"), ("CascadeSearch", "1"),
                            ("TierBudgetSketch", str(CASCADE_B1)),
                            ("TierBudgetInt8", str(CASCADE_B2)),
                            ("CorpusTier", tier),
                            ("DeltaShardCapacity", "256")):
            m.set_parameter(name, value)
        m.build(rows)
        _, before = m.search_batch(q, K)
        victims = np.unique(before[:, :3])[:200]
        m.delete(rows[victims])
        m.add(q[:64])
        d, ids = m.search_batch(q[:64], K)
        _, after = m.search_batch(q, K)
        _, oracle = m.exact_search_batch(q, K)
        # a row's distance to itself: 0 up to the float32 rounding of
        # |q|^2 + |x|^2 - 2 q.x
        qn = (q[:64].astype(np.float64) ** 2).sum(1)
        out[tier] = {
            "deleted": len(victims),
            "deleted_returned": int(np.isin(after, victims).sum()),
            "deleted_in_oracle": int(np.isin(oracle, victims).sum()),
            "added_found_at_rank_0": float(np.mean(ids[:, 0] >= base_n)),
            "added_self_distance_max": float(d[:, 0].max()),
            "self_distance_within_f32": bool((d[:, 0] <= 4e-5 * qn).all())}
        o = out[tier]
        check(o["deleted_returned"] == 0 and o["deleted_in_oracle"] == 0
              and o["added_found_at_rank_0"] == 1.0
              and o["self_distance_within_f32"],
              f"14e {tier}: mutation through the cascade {o}")
        del m
    return out


def cascade_capacity_phase(pt) -> dict:
    """14f: host_all FLAT at CAPACITY_N rows of the headline distribution:
    recall against the index's own streamed exact scan, QPS, the ledger."""
    big, bq = make_dataset(n=CAPACITY_N, nq=1024, seed=7)
    before = ledger_reading()
    c = pt.create_instance("FLAT", "Float")
    for name, value in (("DistCalcMethod", "L2"), ("CascadeSearch", "1"),
                        ("TierBudgetSketch", str(CASCADE_B1)),
                        ("TierBudgetInt8", str(CASCADE_B2)),
                        ("CorpusTier", "host_all")):
        c.set_parameter(name, value)
    t0 = time.perf_counter()
    c.build(big)
    c.search_batch(bq[:256], K)
    build_s = time.perf_counter() - t0
    _, ids, times = timed_search(c, bq)
    usage = ledger_delta(before, ledger_reading())
    t0 = time.perf_counter()
    _, truth = c.exact_search_batch(bq, K)
    oracle_s = time.perf_counter() - t0
    dim = big.shape[1]
    n_pad = -(-CAPACITY_N // 128) * 128
    bound = n_pad * (4 * ((dim + 31) // 32) + 1) + 4 * dim + (1 << 20)
    out = {"n": CAPACITY_N, "queries": len(bq), "build_and_warm_s": build_s,
           "recall_at_10": recall_at_k(ids, truth), **batch_stats(times,
                                                                  1024),
           **usage, "fp_device_bytes_would_be": CAPACITY_N * dim * 4,
           "oracle_s": oracle_s, "device_bound": bound}
    check(0 < usage["device_bytes"] <= bound
          and usage["host_bytes"] >= CAPACITY_N * dim * 4,
          f"14f: host_all device bytes {usage['device_bytes']} (bound "
          f"{bound}), host bytes {usage['host_bytes']}")
    return out


def cascade_phase(pt, dist_ops, data, queries, truth, idx, recall_off,
                  graph_folder, beam_recall, kfolder, workdir):
    """Phase 14.  Returns the first calls of the cascade kernels and their
    launches over the phase."""
    from sptag_tpu_torch.ops import (block_dots, int8_dots, sketch_dots,
                                     walk_dots)

    t_phase = time.perf_counter()
    for module in (block_dots, int8_dots, sketch_dots, walk_dots):
        module.reset_launch_counts()
    first = FirstCascadeCalls()
    with first:
        out = {"a": cascade_flat_phase(pt, data, queries, truth, workdir),
               "b": cascade_dense_phase(idx, queries, truth, recall_off),
               "c": cascade_beam_phase(pt, graph_folder, queries,
                                       truth[:1024], beam_recall, workdir),
               "d": cascade_kdt_phase(pt, dist_ops, kfolder),
               "e": cascade_mutation_phase(pt, data, queries),
               "f": cascade_capacity_phase(pt)}
    launches = {**sketch_dots.launch_counts(), **int8_dots.launch_counts(),
                "walk_score_i8": walk_dots.launch_counts()["walk_score_i8"],
                **{k: v for k, v in block_dots.launch_counts().items()
                   if k.endswith("f32i8")}}
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    for part in "abcdef":
        emit({"phase": f"14{part}", **out.pop(part)})
    emit({"phase": 14, **out})
    missing = [k for k, v in launches.items() if v < 1]
    check(not missing, f"14: cascade kernels not launched: {missing}")
    missing = [k for k in launches if k not in first.args]
    check(not missing, f"14: no main-path call recorded for {missing}")
    return first, launches


def l2_estimate(l2_bytes: int, l2_gbs) -> dict:
    """An estimate, not a floor: the time to move `l2_bytes` from L2 to
    the SMs at the measured L2 read rate (GB/s), in a model where every
    byte comes from L2.  The probe reads past L1 (``__ldcg``); a kernel
    whose rows hit L1 can beat it."""
    return {"l2_bytes": int(l2_bytes), "l2_read_gbs": l2_gbs,
            "l2_only_estimate_ms": (l2_bytes / (l2_gbs * 1e9) * 1e3
                                    if l2_gbs else None)}


def int8_variant_rows(first) -> list:
    """Every int8 kernel variant phase 14's main path ran (kernel, mode,
    epilogue, D, ids or mask): walk_score_i8 held bit for bit to
    walk_score_f32 over the dequantized rows, int8_gather_dots to its
    plain version, on the variant's first call."""
    from sptag_tpu_torch.ops import int8_dots
    from sptag_tpu_torch.ops import walk_dots as wd

    out = []
    for key, args in sorted(first.variants.items(), key=str):
        if key[0] == "walk_score_i8":
            q, x8, idx, xn, epi, mode, C, scale = args
            got = wd.walk_score(q, x8, idx, xn, epi, mode, C, scale)
            want = wd.walk_score(q, wd.dequantize(x8, scale).contiguous(),
                                 idx, xn, epi, mode, C)
        else:
            got = int8_dots.int8_gather_dots(*args)
            want = int8_dots.int8_gather_dots_reference(*args)
        torch.cuda.synchronize()
        out.append({"kernel": key[0], "mode": int(key[1]),
                    "epilogue": int(key[2]), "D": int(key[3]),
                    "ids_or_mask": bool(key[4]), "Q": int(args[0].shape[0]),
                    "bit_equal": bool(torch.equal(got, want))})
    emit({"phase": "2_int8_variants", "variants": out})
    check(all(v["bit_equal"] for v in out) and len(out) >= 2,
          f"2: int8 kernel variants differ from their references: {out}")
    return out


def cascade_kernel_rows(first, launches, l2_gbs) -> list:
    """Phase 2 for the cascade's Hamming, gathered int8 and int8 walk
    kernels on the arguments of their first main-path call in phase 14:
    exact against the plain versions for the integer kernels, and for
    walk_score_i8 bit-equal to walk_score_f32 over the dequantized rows
    (and within the float32 bound of the plain version), with times,
    bound and the library yardstick; the two int8 gathers also with an
    estimate of their time were every row read from L2 at the measured L2
    read rate."""
    from sptag_tpu_torch.ops import int8_dots, sketch_dots
    from sptag_tpu_torch.ops import distance as dist_ops
    from sptag_tpu_torch.ops import walk_dots as wd

    rows = []
    int8_variant_rows(first)
    for name in ("sketch_hamming", "int8_gather_dots", "walk_score_i8"):
        if name not in first.args:
            continue
        args = first.args[name]
        extra = {}
        if name == "sketch_hamming":
            qb, sk, inv = args
            call = lambda: sketch_dots.hamming(qb, sk, inv)  # noqa: E731
            ref = lambda: sketch_dots.hamming_reference(     # noqa: E731
                qb, sk, inv)
            lib = None
            (Q, W), N = qb.shape, sk.shape[0]
            nbytes = Q * W * 4 + N * W * 4 + N + Q * N * 4
            ops, peak = 3.0 * Q * N * W, PEAK_OPS_S["f32"]
            shape = {"Q": Q, "N": N, "W": W}
            source, replaces = ("sptag_tpu_torch/csrc/sketch_dots.cu",
                                "sptag_tpu/ops/cascade.py:151")
            extra["library_call"] = (
                "none: PyTorch has no popcount and no fused XOR-popcount; "
                "the plain version counts bits with SWAR over (Q, N) int64 "
                "tensors, one word at a time")
            extra["peak_used"] = "float32 CUDA-core rate for the integer ops"
        elif name == "int8_gather_dots":
            qq, qs, qn, x, ids, inv, scale, metric, base, mode = args
            call = lambda: int8_dots.int8_gather_dots(       # noqa: E731
                qq, qs, qn, x, ids, inv, scale, metric, base, mode)
            ref = lambda: int8_dots.int8_gather_dots_reference(  # noqa
                qq, qs, qn, x, ids, inv, scale, metric, base, mode)
            pre = x[ids.clamp_min(0).long()]
            lib = lambda: dist_ops.int_contract(            # noqa: E731
                "qd,qcd->qc", qq, pre)
            (Q, C), D = ids.shape, qq.shape[1]
            live = ids >= 0
            distinct = int(torch.unique(ids[live]).numel())
            n_live = int(live.sum().item())
            nbytes = distinct * (D + 1) + Q * D + Q * 8 + Q * C * 8
            ops, peak = 4.0 * Q * C * D, PEAK_OPS_S["i8"]
            shape = {"Q": Q, "C": C, "D": D, "mode": mode, "metric": metric}
            source, replaces = ("sptag_tpu_torch/csrc/int8_dots.cu",
                                "sptag_tpu/ops/cascade.py:192")
            # what a gather moves from L2: every live slot's row, the ids,
            # the output
            l2_bytes = n_live * D + Q * C * 8
            extra.update({"library_call": "int_contract over the rows "
                          "gathered beforehand (the bare dot)",
                          "distinct_rows": distinct,
                          **l2_estimate(l2_bytes, l2_gbs)})
        else:
            q, x8, idx, xn, epi, mode, C, scale = args
            call = lambda: wd.walk_score(                   # noqa: E731
                q, x8, idx, xn, epi, mode, C, scale)
            ref = lambda: wd.walk_score_i8_reference(       # noqa: E731
                q, x8, idx, xn, epi, mode, C, scale)
            xf = wd.dequantize(x8, scale).contiguous()
            same = torch.equal(call(), wd.walk_score(q, xf, idx, xn, epi,
                                                     mode, C))
            safe = idx.clamp_min(0)
            pre = xf[safe]
            lib = lambda: torch.einsum("qd,qcd->qc", q, pre)  # noqa: E731
            fresh = idx >= 0
            Q, D = q.shape
            distinct = int(torch.unique(idx[fresh]).numel())
            n_fresh = int(fresh.sum().item())
            nbytes = (distinct * (D + 4) + Q * D * 4 + Q * C * 4
                      + idx.numel() * 8)
            ops, peak = 2.0 * n_fresh * D, PEAK_OPS_S["f32"]
            shape = {"Q": Q, "C": C, "D": D, "mode": mode, "epilogue": epi}
            source, replaces = ("sptag_tpu_torch/csrc/walk_dots.cu",
                                "sptag_tpu/algo/engine.py:636")
            extra.update({"library_call": "einsum over the rows dequantized "
                          "and gathered beforehand (the bare dot)",
                          "bit_equal_to_walk_score_f32_on_dequantized": same,
                          "fresh_share": n_fresh / idx.numel(),
                          **l2_estimate(n_fresh * D + Q * C * 12,
                                        l2_gbs)})
            check(same, "walk_score_i8 differs from walk_score_f32 on the "
                        "dequantized rows")
        got, want = call(), ref()
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        if name == "walk_score_i8":
            absdot = torch.einsum("qd,qcd->qc", q.abs(), pre.abs())
            tol = 1e-5 * ((q * q).sum(1)[:, None] + xn[safe] + 2 * absdot)
            ok = bool((err <= tol.double() + 1e-30).all())
        else:
            ok = bool(torch.equal(got, want))
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = ops / peak * 1e3
        card_ms, card_rows = device_ms(call)
        timing = {"ms_back_to_back": median_ms(call, calls=BACK_TO_BACK),
                  "device_ms": card_ms, "device_ms_by_kernel": card_rows,
                  "host_ms": host_ms(call)}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "path": "cascade",
               "launches": launches[name],
               "max_abs_err": float(err.max().item()), "ms": median_ms(call),
               "plain_ms": median_ms(ref, reps=10),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": median_ms(lib) if lib is not None else None}
        if lib is not None:
            timing["library_ms_back_to_back"] = median_ms(
                lib, calls=BACK_TO_BACK)
        emit({"phase": 2, **row, **timing, **extra, "shape": shape,
              "bytes": nbytes, "ops": ops, "within_tolerance": ok})
        check(ok, f"{name} (cascade): kernel disagrees with its plain "
                  f"version (max |err| {row['max_abs_err']})")
        rows.append(row)
    return rows


def block_dot_row(block_dots, kind, t, path, counts, blocks, q, ids) -> dict:
    """Phase 2 for one block-dot kernel on one path's arguments: the
    kernel against its plain version, its block reads, times, library
    yardstick and bound; emits the row's JSON line and returns the row of
    the final kernels line."""
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
    qs = q.element_size()
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
        nbytes = (distinct * P * D * es + Q * D * qs + ids.numel() * 4
                  + Q * npb * P * 4)
        ops = 2.0 * Q * npb * P * D
        lib = ("qd,qjpd->qjp", q, blocks[ids.long()])
    else:
        NG, U = ids.shape
        G = Q // NG
        shape = {"NG": NG, "U": U, "G": G, "P": P, "D": D, "C": C}
        nbytes = (distinct * P * D * es + Q * D * qs + ids.numel() * 4
                  + NG * U * G * P * 4)
        ops = 2.0 * NG * U * G * P * D
        lib = ("gqd,gupd->guqp", q.reshape(NG, G, D), blocks[ids.long()])
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    # float32 queries against int8 blocks run in float32 FFMA
    ops_ms = ops / PEAK_OPS_S["i8" if t == "i8" else "f32"] * 1e3
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
    # 128^2 * D = 2^21 < 2^24.  int8 blocks are widened beforehand
    eq, a, b = lib
    if t != "f32":
        a, b = a.float(), b.float()
    library_ms = median_ms(lambda: torch.einsum(eq, a, b))
    timing["library_ms_back_to_back"] = median_ms(
        lambda: torch.einsum(eq, a, b), calls=BACK_TO_BACK)
    # the card's own time of the einsum, beside the kernel's device_ms
    timing["library_device_ms"], timing["library_device_ms_by_kernel"] = \
        device_ms(lambda: torch.einsum(eq, a, b))
    lib_err = float((torch.einsum(eq, a, b).double()
                     - want.double()).abs().max().item())
    del lib, a, b
    # the card's elapsed time per call with no host in the way: calls
    # replayed from one CUDA graph (the prep and the launch gaps included)
    timing["graph_ms"] = graph_ms(lambda: fn(blocks, q, ids))
    if t == "f32i8":
        # the float32 kernel at the same arguments on the widened blocks:
        # bit for bit the same dots, and the time of the float32 staging
        wide = blocks.float()
        same = bool(torch.equal(got, fn(wide, q, ids)))
        timing["bit_equal_to_f32_kernel_on_widened_blocks"] = same
        timing["f32_control_ms"] = median_ms(lambda: fn(wide, q, ids))
        timing["f32_control_device_ms"], \
            timing["f32_control_device_ms_by_kernel"] = device_ms(
                lambda: fn(wide, q, ids))
        timing["f32_control_graph_ms"] = graph_ms(lambda: fn(wide, q, ids))
        del wide
        check(same, f"{kind} f32i8 ({path}): not the float32 kernel's bits "
                    f"on the widened blocks")
        # the JAX package's XLA branch of the dense scan (float queries
        # against int8 blocks take no Pallas kernel there)
        replaces = ("sptag_tpu/algo/dense.py:321"
                    if kind == "probe_block_dots"
                    else "sptag_tpu/algo/dense.py:433")
    else:
        replaces = ("sptag_tpu/ops/pallas_kernels.py:151"
                    if kind == "probe_block_dots"
                    else "sptag_tpu/ops/pallas_kernels.py:214")
    row = {"name": f"{kind}_{t}", "route": "cuda",
           "source": "sptag_tpu_torch/csrc/block_dots.cu",
           "replaces": replaces,
           "path": path, "launches": counts[f"{kind}_{t}"],
           "max_abs_err": float(err.max().item()), "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    emit({"phase": 2, **row, **timing, "shape": shape,
          "distinct_blocks": distinct, **reads, "bytes": nbytes, "ops": ops,
          "within_tolerance": ok, "library_max_abs_err": lib_err})
    check(ok,
          f"{kind} {t} ({path}): kernel disagrees with its plain version "
          f"(max |err| {row['max_abs_err']})")
    return row


def walk_dots_rows(walk_ops, first, launches: dict) -> list:
    """Phase 2 for the walk's fixed-order distance kernels: each against
    its plain version on the arguments of phase 7's first call (in-loop
    scoring: 1,024 queries, B * m gathered slots each, the slots that are
    not fresh -1; seeding: every pivot; the norm helper: the pivots' norms
    at the engine's build), with the same times and bound as the
    block-dot rows.  The kernels' times include the fused epilogue; the
    library call is the bare dot (one einsum over the rows pre-gathered,
    one matrix product, one einsum of a row with itself).  The bound
    counts what this run's data needs: the scoring reads each distinct
    fresh row once and scores only fresh slots."""
    rows = []
    for kind, path in (("walk_score", "walk_scoring"),
                       ("walk_seed", "walk_seeding"),
                       ("row_sqnorms", "pivot_norms")):
        if kind not in first.args:
            fail(f"phase 7 made no {kind} call of the main path's shape")
        args = first.args[kind]
        fn = getattr(walk_ops, kind)
        extra = {}
        if kind == "walk_score":
            q, x, idx, xn, epi, mode, C = args
            name = "walk_score_f32"
            ref = lambda: walk_ops.walk_score_reference(  # noqa: E731
                q, x, idx, xn, epi, mode, C)
            fresh = idx >= 0
            safe = idx.clamp_min(0)
            pre = x[safe]
            lib = lambda: torch.einsum("qd,qcd->qc", q, pre)  # noqa: E731
            absdot = torch.einsum("qd,qcd->qc", q.abs(), pre.abs())
            xn_out = xn[safe]
            Q, D = q.shape
            distinct = int(torch.unique(idx[fresh]).numel())
            n_fresh = int(fresh.sum().item())
            nbytes = (distinct * (D + 1) + Q * D + Q * C) * 4 + idx.numel() * 8
            ops = 2.0 * n_fresh * D
            shape = {"Q": Q, "C": C, "D": D, "mode": mode, "epilogue": epi}
            extra = {"library_call": "einsum over the rows pre-gathered: "
                                     "the bare dot, no epilogue, no mask",
                     "distinct_rows": distinct,
                     "fresh_share": n_fresh / idx.numel(),
                     # over every in-loop scoring call of phase 7's
                     # first exact and binned beam batches
                     "fresh_share_walk": float(first.slots[0])
                     / max(first.slots[1], 1)}
        elif kind == "walk_seed":
            q, x, xn, epi = args
            name = "walk_seed_f32"
            ref = lambda: walk_ops.walk_seed_reference(  # noqa: E731
                q, x, xn, epi)
            lib = lambda: q @ x.T                             # noqa: E731
            absdot = q.abs() @ x.abs().T
            xn_out = xn[None, :]
            (Q, D), P = q.shape, x.shape[0]
            nbytes = (Q * D + P * (D + 1) + Q * P) * 4
            ops = 2.0 * Q * P * D
            shape = {"Q": Q, "P": P, "D": D, "epilogue": epi}
            extra = {"library_call": "q @ x.T: the bare dot, no epilogue"}
        else:
            (x,) = args
            name = "walk_sqnorm_f32"
            ref = lambda: (x * x).sum(1)                       # noqa: E731
            lib = lambda: torch.einsum("nd,nd->n", x, x)      # noqa: E731
            q, absdot, xn_out = x, 0.0, 0.0
            N, D = x.shape
            nbytes = (N * D + N) * 4
            ops = 2.0 * N * D
            shape = {"N": N, "D": D}
        call = lambda: fn(*args)                              # noqa: E731
        got, want = call(), ref()
        torch.cuda.synchronize()
        qn = (q * q).sum(1)
        scale = (qn[:, None] + xn_out + 2 * absdot if kind != "row_sqnorms"
                 else qn)
        err = (got.double() - want.double()).abs()
        ok = bool((err <= 1e-5 * scale.double() + 1e-30).all())
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = ops / PEAK_OPS_S["f32"] * 1e3
        card_ms, card_rows = device_ms(call)
        timing = {"ms_back_to_back": median_ms(call, calls=BACK_TO_BACK),
                  "device_ms": card_ms, "device_ms_by_kernel": card_rows,
                  "host_ms": host_ms(call),
                  "library_ms_back_to_back": median_ms(lib,
                                                       calls=BACK_TO_BACK),
                  "library_device_ms": device_ms(lib)[0]}
        row = {"name": name, "route": "cuda",
               "source": "sptag_tpu_torch/csrc/walk_dots.cu",
               "replaces": ("sptag_tpu/ops/distance.py:232"
                            if kind == "walk_seed"
                            else "sptag_tpu/ops/distance.py:249"
                            if kind == "walk_score"
                            else "sptag_tpu/ops/distance.py:175"),
               "path": path, "launches": launches[name],
               "max_abs_err": float(err.max().item()),
               "ms": median_ms(call), "plain_ms": median_ms(ref),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": median_ms(lib)}
        emit({"phase": 2, **row, **timing, **extra, "shape": shape,
              "bytes": nbytes, "ops": ops, "within_tolerance": ok})
        check(ok, f"{name} ({path}): kernel disagrees with its plain "
                  f"version (max |err| {row['max_abs_err']})")
        rows.append(row)
    return rows


# bodies held kernel against plain version, and timed, from a seeded state
WALK_BODY_BODIES = 8


def walk_body_row(walk_body, eng, queries, launches: dict) -> dict:
    """Phase 2 for the exact walk body's kernels (ops/walk_body.py): on
    phase 7's engine at the main path's plan and 1,024 queries, the fused
    body (pop + expand, scoring, merge: three launches) against the plain
    body (the PyTorch glue around the same scoring launch) on every state
    tensor after each of WALK_BODY_BODIES bodies from the seeded state;
    then each path's device time and kernels a body over those bodies
    (``torch.profiler``), its host time, and the bytes bound of the glue
    (each row's beam read and written, its B * m graph ids, visited bytes
    and candidate slots moved once)."""
    from torch.profiler import ProfilerActivity, profile

    from sptag_tpu_torch.algo import engine as teng

    k_eff, L, B, T, limit = eng.walk_plan(K, 2048, 16, None, 3)
    m = int(eng.graph.shape[1])
    Q = 1024
    q = torch.from_numpy(np.ascontiguousarray(queries[:Q])).to(eng.device)
    seeded = eng.seed_state(q, L)
    t_limit = torch.full((Q,), T, dtype=torch.int64, device=eng.device)

    def clone():
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in seeded.items()}

    def walk(state, fused):
        w = teng._Walk(eng, state, t_limit, k_eff, L, B, limit, 4, 0)
        if not fused:
            w.fused = False
        return w

    walk_body.reset_launch_counts()
    plain, fused = walk(clone(), False), walk(clone(), True)
    unequal = []
    for step in range(WALK_BODY_BODIES):
        plain.body()
        fused.body()
        a, b = plain.state(), fused.state()
        for key in teng.STATE_KEYS:
            x, y = a[key], b[key]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                unequal.append(f"{key}@{step}")
    torch.cuda.synchronize()
    body_launches = walk_body.launch_counts()
    del plain, fused
    timing = {}
    for mode in ("fused", "plain"):
        w = walk(clone(), mode == "fused")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WALK_BODY_BODIES):
                w.body()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kernel = {}
        for e in events:
            by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) \
                + e.time_range.elapsed_us() / 1e3 / WALK_BODY_BODIES
        w = walk(clone(), mode == "fused")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WALK_BODY_BODIES):
            w.body()
        host = (time.perf_counter() - t0) / WALK_BODY_BODIES * 1e3
        torch.cuda.synchronize()
        timing[mode] = {"device_ms_per_body": sum(by_kernel.values()),
                        "kernels_per_body": len(events) / WALK_BODY_BODIES,
                        "host_ms_per_body": host,
                        "device_ms_by_kernel": by_kernel}
        del w
    C = B * m
    nbytes = Q * (2 * L * (8 + 4 + 1) + C * (4 + 1 + 8 + 4 + 8))
    row = {"name": "walk_body", "route": "cuda",
           "source": "sptag_tpu_torch/csrc/walk_body.cu",
           "replaces": "sptag_tpu/algo/engine.py:540 (XLA glue, no Pallas)",
           "path": "walk_body",
           "launches": {k: launches.get(k, 0) for k in walk_body.KERNELS},
           "launches_held": body_launches,
           "plan": {"Q": Q, "L": L, "B": B, "m": m, "inject": 4},
           "bodies_equal": not unequal, "unequal": unequal[:20],
           "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, **timing}
    emit({"phase": 2, **row})
    check(not unequal, f"walk_body: the fused body differs from the plain "
                       f"body at {unequal[:20]}")
    check(body_launches == {**dict.fromkeys(walk_body.BODY_KERNELS,
                                            WALK_BODY_BODIES),
                            "walk_resident": 0},
          f"walk_body: launches {body_launches}")
    return row


# the resident walk's cluster sizes and row counts timed by phase 2
RESIDENT_CLUSTERS = (1, 2, 4, 8)
RESIDENT_ROWS = (4, 16, 256)
# replays of a single query's captured walk counted by phases 2 and 10
RESIDENT_REPLAYS = 10


class CapturedWalkCounts:
    """The walk body's kernel launches and the bodies walked (all, and
    those that ran as one resident launch: ``search.walk_bodies``,
    ``search.walk_resident_bodies``) over a ``with`` block, which starts
    at a single query's capturing call on the main path (search_batch:
    the key's first call walks eagerly, its second captures the walk and
    replays it).  `check` holds the block to the resident walk: one
    capture, the resident kernel launched twice (the capture's warm-up and
    the capture itself), no body kernel launched, and every body walked
    resident."""

    def __init__(self, walk_body):
        self.walk_body = walk_body

    @staticmethod
    def read() -> list:
        from sptag_tpu_torch.algo import engine as teng
        from sptag_tpu_torch.utils import metrics

        return [metrics.counter_value("search.walk_bodies"),
                metrics.counter_value("search.walk_resident_bodies"),
                sum(row.get("walk_captures", 0)
                    for row in teng.graph_stats().values())]

    def __enter__(self):
        torch.cuda.synchronize()
        self.walk_body.reset_launch_counts()
        self.before = self.read()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.launches = self.walk_body.launch_counts()
        self.bodies, self.resident_bodies, self.captures = (
            a - b for a, b in zip(self.read(), self.before))
        return False

    def row(self) -> dict:
        return {"launches": self.launches, "walk_captures": self.captures,
                "walk_bodies": self.bodies,
                "walk_resident_bodies": self.resident_bodies}

    def check(self, where: str) -> None:
        check(self.captures == 1
              and self.launches == {**dict.fromkeys(
                  self.walk_body.BODY_KERNELS, 0), "walk_resident": 2}
              and self.resident_bodies == self.bodies > 0,
              f"{where}: a single query's captured walk did not run as one "
              f"resident launch {self.row()}")


def ptxas_lines(source: str, kernel: str) -> list:
    """ptxas's lines (registers, shared memory, spills) for the entry
    functions of `source` whose names hold `kernel`: from this process's
    build, or, where an earlier process built the library, from a build
    of the source into a scratch directory."""
    from sptag_tpu_torch import _build

    log = _build.build_log.get(source, "")
    if not log:
        with tempfile.TemporaryDirectory() as scratch:
            res = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(scratch, "lib.so"),
                 os.path.join(_build.CSRC_DIR, source + ".cu")],
                capture_output=True, text=True)
            log = res.stdout + res.stderr
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = kernel in ln
            if on:
                out.append(ln.strip())
        elif on and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def walk_resident_row(walk_body, index, queries) -> dict:
    """Phase 2 for the resident walk (ops/walk_body.py's walk_resident):
    on `eng` at the single-query cell's plan (k 10, MaxCheck 2048) with a
    single query's replay bucket (the query and three copies, as a replay
    pads it), and at 16 and 256 distinct queries, the resident kernel's T
    bodies in one launch and T three-launch bodies (pop + expand, scoring,
    merge) each against T plain bodies (the PyTorch glue around the same
    scoring) from the same seeded state, every state tensor bit for bit;
    each path's device time a walk (``torch.profiler``, the walk's
    kernels) and elapsed time a walk (``graph_ms``: a CUDA graph of 20
    walks, each from a copy of the seeded state, the copies included on
    both sides), at every cluster size; the resident kernel's launches, the
    cluster size the rule picks, and its ptxas lines; then a single query
    through `index.search_batch` (CapturedWalkCounts), replayed
    RESIDENT_REPLAYS times."""
    from sptag_tpu_torch.algo import engine as teng

    eng = index._get_engine()
    k_eff, L, B, T, limit = eng.walk_plan(K, 2048, 16, None, 3)
    m = int(eng.graph.shape[1])
    D = int(eng.data.shape[1])
    sms = torch.cuda.get_device_properties(eng.device).multi_processor_count
    cluster_for = walk_body.cluster_for

    def seeded_for(Q):
        if Q == 4:
            q = np.repeat(queries[:1], 4, axis=0)
        else:
            q = queries[:Q]
        q = torch.from_numpy(np.ascontiguousarray(q)).to(eng.device)
        state = eng.seed_state(q, L)
        t_limit = torch.full((Q,), T, dtype=torch.int64, device=eng.device)
        return state, t_limit

    def run(seeded, t_limit, body):
        """T bodies of `body`: "plain", "three" (launches) or "resident"."""
        state = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in seeded.items()}
        w = teng._Walk(eng, state, t_limit, k_eff, L, B, limit,
                       4 if state.get("spare_ids") is not None else 0, 0)
        if body != "resident":
            w.resident = False
            w.fused = body == "three"
        elif not w.resident:
            raise RuntimeError("walk_resident: the rule refuses the plan")
        w.run_all(T)
        return w.state()

    def differ(want, got, where):
        for key in teng.STATE_KEYS:
            x, y = want[key], got[key]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                unequal.append(f"{key}@Q{Q}/{where}")

    def walk_ms(fn):
        _, rows = device_ms(fn)
        walk_rows = {k: v for k, v in rows.items() if "walk_" in k}
        return sum(walk_rows.values()), walk_rows

    unequal, sweep = [], {}
    three = {}
    for Q in RESIDENT_ROWS:
        seeded, t_limit = seeded_for(Q)
        want = run(seeded, t_limit, "plain")
        differ(want, run(seeded, t_limit, "three"), "three")
        dev_ms, by_kernel = walk_ms(lambda: run(seeded, t_limit, "three"))
        three[Q] = {"device_ms": dev_ms,
                    "elapsed_ms": graph_ms(
                        lambda: run(seeded, t_limit, "three")),
                    "device_ms_by_kernel": by_kernel}
        sweep[Q] = {}
        for cl in RESIDENT_CLUSTERS:
            walk_body.cluster_for = lambda Q, sms, cl=cl: cl
            try:
                differ(want, run(seeded, t_limit, "resident"),
                       f"cluster{cl}")
                sweep[Q][cl] = {
                    "device_ms": walk_ms(lambda: run(seeded, t_limit,
                                                     "resident"))[0],
                    "elapsed_ms": graph_ms(lambda: run(seeded, t_limit,
                                                       "resident"))}
            finally:
                walk_body.cluster_for = cluster_for
        torch.cuda.synchronize()
    walk_body.reset_launch_counts()
    seeded, t_limit = seeded_for(4)
    for _ in range(3):
        run(seeded, t_limit, "resident")
    torch.cuda.synchronize()
    launches = walk_body.launch_counts()
    index.search_batch(queries[:1], K)          # eager: the key is seen
    with CapturedWalkCounts(walk_body) as single:
        for _ in range(1 + RESIDENT_REPLAYS):
            index.search_batch(queries[:1], K)
    chosen = cluster_for(4, sms)
    smem = walk_body.resident_smem(L, B, m, 4, eng.n, D)
    row = {"name": "walk_resident", "route": "cuda",
           "source": "sptag_tpu_torch/csrc/walk_body.cu",
           "replaces": "the walk body's three launches of a captured walk "
                       "(walk_pop_expand, walk_score_f32, walk_merge)",
           "path": "walk_resident",
           "plan": {"L": L, "B": B, "m": m, "T": T, "N": eng.n, "D": D,
                    "inject": 4},
           "bits_equal": not unequal, "unequal": unequal[:20],
           "cluster_chosen_at_4_rows": chosen, "sms": sms,
           "smem_bytes": smem,
           "ptxas": ptxas_lines("walk_body", "walk_resident_kernel"),
           "launches_3_walks": launches, "single_query": single.row(),
           "three_launch": {str(q): v for q, v in three.items()},
           "resident": {str(q): {str(c): v for c, v in by.items()}
                        for q, by in sweep.items()}}
    emit({"phase": 2, **row})
    check(not unequal, f"walk_resident: differs from the plain body at "
                       f"{unequal[:20]}")
    check(launches == {**dict.fromkeys(walk_body.BODY_KERNELS, 0),
                       "walk_resident": 3},
          f"walk_resident: launches {launches}")
    single.check("walk_resident")
    return row


# ---- phase 15: observability (device half) and the mesh --------------------

# the probe's readings may exceed the data sheet by timer noise at most
PROBE_MAX_RATIO = 1.05
SENTINEL_REQUESTS = 1024
# the sentinel server's slot pools (BeamSlots) and per-family compile
# budget while it warms up
SENTINEL_SLOTS = 256
TRACESAN_WARM_BUDGET = 64
MESH_SERVE_REQUESTS = 256
# 15d: a slice of the headline cut into 4 shards, 2 a process
MH_ROWS, MH_SHARDS, MH_PROCS = 50_000, 4, 2
MH_QUERIES = 1024


def roofline_phase(rows, card) -> dict:
    """15a: the card's capability from the table, the measured probe on a
    fresh cache against it, and perf_report over phase 2's rows."""
    from sptag_tpu_torch.tools import perf_report
    from sptag_tpu_torch.utils import roofline

    cap = roofline.capability()
    emit({"roofline": perf_report.capability_dict(cap)})
    with tempfile.TemporaryDirectory() as cache:
        os.environ["SPTAG_TPU_ROOFLINE_CACHE"] = cache
        try:
            t0 = time.perf_counter()
            probed = roofline.probe_capability()
            probe_s = time.perf_counter() - t0
        finally:
            os.environ.pop("SPTAG_TPU_ROOFLINE_CACHE", None)
    if probed is None:
        fail("15a: the roofline probe failed")
    out = {"nvidia_smi": card, "device": cap.device_kind,
           "source": cap.source, "hbm_gbps": cap.hbm_gbps,
           "peak_flops_f32": cap.peak_flops_f32,
           "peak_flops_bf16": cap.peak_flops_bf16,
           "peak_flops_int8": cap.peak_flops_int8,
           "probe_s": probe_s,
           "probe_flops_f32": probed.peak_flops_f32,
           "probe_gbps": probed.hbm_gbps,
           "probe_f32_over_table": probed.peak_flops_f32
           / cap.peak_flops_f32,
           "probe_gbps_over_table": probed.hbm_gbps / cap.hbm_gbps}
    check(cap.source == "table", f"15a: capability source {cap.source}")
    check(out["probe_f32_over_table"] <= PROBE_MAX_RATIO
          and out["probe_gbps_over_table"] <= PROBE_MAX_RATIO,
          f"15a: the probe exceeds the table: {out}")
    for line in perf_report.render_kernels(
            rows, perf_report.capability_dict(cap)):
        print(line, flush=True)
    return out


def sentinel_phase(pt, graph_folder, queries, workdir) -> dict:
    """15b: a port server over phase 7's folder with [Service]
    TraceSanitizer armed, the slot scheduler and FlightDeviceSampleRate=1:
    warm-up, then 1,024 requests in steady state with every family's
    compile budget at its warm-up count; the roofline gauges, and a
    forced slow query's log line."""
    import logging as logging_mod

    from sptag_tpu_torch.serve import server as sserver
    from sptag_tpu_torch.serve import service as sservice
    from sptag_tpu_torch.utils import metrics
    from sptag_tpu_torch.utils import recompile_guard as rg

    ini = os.path.join(workdir, "sentinel.ini")
    write_shard_ini(ini, graph_folder,
                    "TraceSanitizer=1\n"
                    f"TraceSanCompileBudget={TRACESAN_WARM_BUDGET}\n"
                    "SlowQueryThresholdMs=1000000\n")
    ctx = sservice.ServiceContext.from_ini(ini)
    if not rg.tracesan_enabled():
        fail("15b: [Service] TraceSanitizer did not arm the sentinel")
    index = ctx.indexes["main"]
    for name, value in (("SearchMode", "beam"), ("ContinuousBatching", "1"),
                        ("BeamSlots", str(SENTINEL_SLOTS)),
                        ("FlightDeviceSampleRate", "1")):
        if not index.set_parameter(name, value):
            fail(f"15b: set_parameter {name}")
    server = sserver.SearchServer(ctx)
    run = ServerRunner(server)
    texts = [f"$resultnum:{K} " + b64_query(v)
             for v in queries[:SENTINEL_REQUESTS]]
    try:
        with rg.track_compiles("15b.warm") as warm:
            # the load and a lone request (the forced slow query's
            # shape), each twice: a graph is captured at a key's second
            # sighting
            for _ in range(2):
                pool_search(run.addr, texts)
                pool_search(run.addr, texts[:1], connections=1)
        warm_counts = rg.compile_counts()
        # steady state: no family may compile again
        for family, count in warm_counts.items():
            rg.set_compile_budget(family, count)
        trips0 = rg.tracesan_counters()["budget_trips"]
        flagged0 = rg.violation_count()
        with rg.track_compiles("15b.steady") as steady:
            res, wall = pool_search(run.addr, texts)
        d, ids, bad = served_arrays(res, K)
        trips = rg.tracesan_counters()["budget_trips"] - trips0
        flagged = rg.violation_count() - flagged0
        gflops = metrics.gauge_value("engine.achieved_gflops")
        gbps = metrics.gauge_value("engine.achieved_gbps")
        pct = metrics.gauge_value("engine.roofline_pct_peak")
        h = metrics.histogram_or_none("engine.segment_device_ns")
        # a forced slow query: its log line carries the attribution
        lines = []

        class Catch(logging_mod.Handler):
            def emit(self, record):
                lines.append(record.getMessage())
        catch = Catch()
        srv_log = logging_mod.getLogger(sserver.__name__)
        srv_log.addHandler(catch)
        server.slow_query_threshold_ms = 1e-6
        try:
            pool_search(run.addr, texts[:1], connections=1)
        finally:
            server.slow_query_threshold_ms = 1e6
            srv_log.removeHandler(catch)
        slow = [ln for ln in lines if ln.startswith("slow query")]
        trips_after = rg.tracesan_counters()["budget_trips"] - trips0
        stats = index._scheduler.stats() if index._scheduler else {}
    finally:
        run.stop()
        index.close()
    out = {"requests": len(texts), "steady_wall_s": wall,
           "steady_qps": len(texts) / wall, "unanswered": bad,
           "warm": {"compiles": warm.count, "kinds": warm.kinds,
                    "by_family": warm_counts},
           "steady": {"compiles": steady.count, "kinds": steady.kinds,
                      "budget_trips": trips, "flagged_transfers": flagged},
           "budget_trips_with_the_slow_query": trips_after,
           "violations": rg.violations()[:5],
           "engine_achieved_gflops": gflops,
           "engine_achieved_gbps": gbps,
           "engine_roofline_pct_peak": pct,
           "segment_device_ns_samples": h.count if h is not None else 0,
           "scheduler": {k: stats.get(k) for k in (
               "retired", "segments_eager", "segments_replayed",
               "graphs_captured")},
           "slow_query_line": slow[0] if slow else None}
    rg.disable_tracesan()
    check(bad == 0, f"15b: {bad} unanswered requests")
    check(trips == 0 and trips_after == 0 and flagged == 0,
          f"15b: steady state {trips} budget trips ({trips_after} with "
          f"the slow query), {flagged} flagged transfers "
          f"({rg.violations()[:5]})")
    check(gflops > 0 and 0 < pct <= 100,
          f"15b: engine gauges gflops {gflops}, pct_peak {pct}")
    check(bool(slow) and "gflops=" in slow[0] and "pct_peak=" in slow[0],
          f"15b: the forced slow query's log line {slow[:1]}")
    return out


def mesh_phase(pt, block_dots, data, queries, truth, out13,
               workdir) -> dict:
    """15c: phase 13c's two serve-shard folders as a 2-shard mesh on
    [cuda:0, cuda:0]: the monolithic and scheduled beam walks, the dense
    scan (probe_block_dots launched a shard), the agreement with 13c's
    in-process merge, and a MeshServe=1 server."""
    from sptag_tpu_torch.parallel import sharded
    from sptag_tpu_torch.serve import server as sserver
    from sptag_tpu_torch.serve import service as sservice

    folder = os.path.join(workdir, "mesh2")
    os.makedirs(folder)
    for s, shard in enumerate(out13["serve_folders"]):
        os.symlink(shard, os.path.join(folder, f"shard_{s:03d}"))
    sharded.write_manifest(folder, len(SHARDS), SHARDS[-1][1], data.shape[1],
                           0, [])
    mesh = sharded.Mesh(["cuda:0"] * len(SHARDS))
    t0 = time.perf_counter()
    m = sharded.ShardedBKTIndex.load(folder, mesh=mesh, dense=True)
    load_s = time.perf_counter() - t0
    q = queries[:CLUSTER_QUERIES]
    tq = truth[:len(q)]
    m.search(q, K)                                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_b, i_b = m.search(q, K)
    mesh_ms = (time.perf_counter() - t0) * 1e3
    # the two shards' separate batches, back to back, at the same plan
    shard_ms = []
    for eng in m.engines:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.search(q, m._merge_k_local(K), m.max_check, m.beam_width, None,
                   m.nbp_limit)
        torch.cuda.synchronize()
        shard_ms.append((time.perf_counter() - t0) * 1e3)
    recall_b = recall_at_k(i_b, tq)
    # the mesh scheduler
    m.enable_continuous_batching()
    try:
        futs = m.submit_batch(q, K)
        got = [f.result(timeout=300) for f in futs]
    finally:
        m.retire_scheduler()
    d_s = np.stack([g[0] for g in got])
    i_s = np.stack([g[1] for g in got])
    sched_equal = bool(np.array_equal(i_s, i_b)
                       and d_s.tobytes() == d_b.tobytes())
    # the dense scan: probe_block_dots on the card in each shard
    block_dots.reset_launch_counts()
    d_d, i_d = m.search_dense(q, K)
    dense_launches = block_dots.launch_counts()
    recall_d = recall_at_k(i_d, tq)
    # 13c's in-process merge of the shards' own beam searches
    ref_d, ref_i = out13["beam_merge"]
    tol = 2e-5 * float(np.abs(d_b).max())
    same_rows = [not separated_ids_equal(i_b[r:r + 1], ref_i[r:r + 1],
                                         ref_d[r:r + 1], tol)
                 for r in range(len(q))]
    # a MeshServe=1 server over the mesh
    ctx = sservice.ServiceContext(sservice.ServiceSettings(
        listen_addr="127.0.0.1", default_max_result=K, mesh_serve=True))
    ctx.add_index("mesh", sharded.ServingAdapter(m, data.shape[1]))
    run = ServerRunner(sserver.SearchServer(ctx))
    try:
        texts = [f"$resultnum:{K} " + b64_query(v)
                 for v in q[:MESH_SERVE_REQUESTS]]
        res, wall = pool_search(run.addr, texts)
        armed = m._scheduler is not None
    finally:
        run.stop()
        m.retire_scheduler()
    sd, si, bad = served_arrays(res, K)
    want_d, want_i = m.search(q[:MESH_SERVE_REQUESTS], K)
    served_ids = bool(np.array_equal(si, want_i))
    served_d = bool(np.array_equal(sd.astype(np.float32), want_d))
    served_equal = bad == 0 and served_ids and served_d
    out = {"load_s": load_s, "queries": len(q),
           "beam_recall_at_10": recall_b,
           "phase_13c_merged_recall": out13["beam_recall"],
           "mesh_batch_ms": mesh_ms, "shard_batch_ms": shard_ms,
           "scheduled_equals_monolithic": sched_equal,
           "dense_recall_at_10": recall_d,
           "dense_launches": dense_launches,
           "rows_equal_13c_merge_at_separated_ranks": float(
               np.mean(same_rows)),
           "mesh_serve": {"armed": armed, "requests": len(texts),
                          "wall_s": wall, "unanswered": bad,
                          "ids_equal_search_batch": served_ids,
                          "distances_equal_search_batch": served_d}}
    check(recall_b >= out13["beam_recall"] - 0.01,
          f"15c: mesh beam recall {recall_b} below 13c's "
          f"{out13['beam_recall']} - 0.01")
    check(sched_equal, "15c: the mesh scheduler differs from the "
                       "monolithic mesh walk")
    check(dense_launches.get("probe_block_dots_f32", 0) >= len(SHARDS),
          f"15c: the dense mesh launched {dense_launches}")
    check(out["rows_equal_13c_merge_at_separated_ranks"] == 1.0,
          f"15c: mesh ids differ from 13c's merge: "
          f"{out['rows_equal_13c_merge_at_separated_ranks']}")
    check(armed and served_equal,
          f"15c: MeshServe armed {armed}, answers equal {served_equal}, "
          f"unanswered {bad}")
    return out


MH_WORKER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
import chip_smoke as cs
from sptag_tpu_torch.parallel import multihost
from sptag_tpu_torch.parallel.sharded import Mesh
rank, port, folder = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", num_processes=cs.MH_PROCS,
                     process_id=rank)
data, queries = cs.make_dataset(n=200_000, nq=4096, seed=7)
data = data[:cs.MH_ROWS]
per = cs.MH_ROWS // cs.MH_SHARDS
local = cs.MH_SHARDS // cs.MH_PROCS
params = dict(cs.GRAPH_PARAMS)
idx = multihost.build_process_sharded(
    lambda s: data[s * per:(s + 1) * per], cs.MH_ROWS, data.shape[1], 0,
    mesh=Mesh(["cuda:0"] * local), params=params, save_to=folder)
d, i = idx.search(queries[:cs.MH_QUERIES], cs.K)
np.savez(f"{folder}/rank{rank}.npz", d=d, i=i)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def multiprocess_phase(queries, workdir, here) -> dict:
    """15d: two processes on cuda:0 over gloo, each building 2 of the 4
    shards of a 50,000-row slice of the headline; their ids against a
    one-process 4-shard mesh over the same shard folders."""
    from sptag_tpu_torch.parallel import sharded

    folder = os.path.join(workdir, "mesh_mp")
    os.makedirs(folder)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_WORKER, str(r), str(port), folder, here],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(MH_PROCS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r, o in enumerate(outs):
            print(f"15d rank {r} (rc {rcs[r]}):\n{o[-3000:]}",
                  file=sys.stderr, flush=True)
        fail(f"15d: the processes exited {rcs}")
    got = [np.load(os.path.join(folder, f"rank{r}.npz"))
           for r in range(MH_PROCS)]
    one = sharded.ShardedBKTIndex.load(
        folder, mesh=sharded.Mesh(["cuda:0"] * MH_SHARDS))
    q = queries[:MH_QUERIES]
    d1, i1 = one.search(q, K)
    ranks_agree = all(np.array_equal(g["i"], got[0]["i"]) for g in got)
    ids_equal = bool(np.array_equal(got[0]["i"], i1))
    out = {"rows": MH_ROWS, "shards": MH_SHARDS, "processes": MH_PROCS,
           "wall_s": wall, "ranks_agree": ranks_agree,
           "ids_equal_one_process": ids_equal,
           "distances_equal": bool(np.array_equal(got[0]["d"], d1))}
    check(ranks_agree and ids_equal,
          f"15d: ranks agree {ranks_agree}, ids equal the one-process "
          f"mesh {ids_equal}")
    return out


def observability_mesh_phase(pt, block_dots, data, queries, truth, rows,
                             card, graph_folder, out13, workdir,
                             here) -> None:
    """Phase 15: 15a-15d, each its own JSON line."""
    t_phase = time.perf_counter()
    emit({"phase": "15a", **roofline_phase(rows, card)})
    emit({"phase": "15b", **sentinel_phase(pt, graph_folder, queries,
                                           workdir)})
    emit({"phase": "15c", **mesh_phase(pt, block_dots, data, queries, truth,
                                       out13, workdir)})
    emit({"phase": "15d", **multiprocess_phase(queries, workdir, here),
          "phase_15_wall_s": time.perf_counter() - t_phase})


# ---- phase 16: the mesh across the cards ----------------------------------

# 1,000,000 x 128 rows (make_dataset seed 7) in 4 shards of 250,000 at
# GRAPH_PARAMS: four times the headline's rows a card
MESH_CARDS = 4
MESH_ROWS = 1_000_000
MESH_QUERIES = 4096
MESH_BATCH = 1024
MESH_SERVE_REQUESTS16 = 1024
# timed beam batches a mesh, in turns (4 cards, 1 card, 1 card, 4 cards)
MESH_TIMED_ROUNDS = 2
# 16c: the NCCL ranks' batch against the 4 shards on one card
MESH_NCCL_MAX_RATIO = 0.5
# every collective of the 16c ranks, and the ranks themselves
MESH_COLLECTIVE_TIMEOUT_S = 300
MESH_PROCESS_TIMEOUT_S = 900


def sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_batches(m, queries, mode):
    """Every query through the mesh in batches of MESH_BATCH: beam exact,
    beam binned (the shard engines' BinnedTopK) or dense."""
    from sptag_tpu_torch.ops import topk_bins

    binned = topk_bins.normalize_mode("on" if mode == "beam_binned"
                                      else "off")
    for eng in m.engines:
        eng.binned_mode = binned
    d, ids = [], []
    for lo in range(0, len(queries), MESH_BATCH):
        q = queries[lo:lo + MESH_BATCH]
        dd, ii = (m.search_dense(q, K) if mode == "dense"
                  else m.search(q, K))
        d.append(dd)
        ids.append(ii)
    for eng in m.engines:
        eng.binned_mode = topk_bins.normalize_mode("off")
    return np.concatenate(d), np.concatenate(ids)


def card_trace(m, q) -> dict:
    """One beam batch of the mesh under torch.profiler: each card's kernel
    time and launches, against the batch's untraced wall time."""
    from torch.profiler import ProfilerActivity, profile

    m.search(q, K)
    sync_cards()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.search(q, K)
        sync_cards()
        wall = time.perf_counter() - t0
    busy, launches = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        card = f"cuda:{e.device_index}"
        busy[card] = busy.get(card, 0.0) + e.time_range.elapsed_us() / 1e3
        launches[card] = launches.get(card, 0) + 1
    return {"traced_wall_ms": wall * 1e3,
            "cards": {c: {"device_ms": busy[c], "launches": launches[c],
                          "busy_share": busy[c] / (wall * 1e3)}
                      for c in sorted(busy)}}


def mesh_cards_16a(pt, block_dots, walk_ops, dist_ops, workdir, devs):
    """16a: the 1M-row mesh built on its cards, loaded on them and on
    the first card alone; beam (exact, binned) and dense ids and distance bits of
    the two placements equal, beam recall, launches per card, one batch's
    wall time on the cards against one card, the bytes between cards."""
    from sptag_tpu_torch.parallel import sharded
    from sptag_tpu_torch.utils import devmem

    n_cards = torch.cuda.device_count()
    data, queries = make_dataset(n=MESH_ROWS, nq=MESH_QUERIES, seed=7)
    folder = os.path.join(workdir, "mesh16")
    peer = {f"cuda:{a}->cuda:{b}": sharded.peer_access(a, b)
            for a in range(n_cards) for b in range(n_cards) if a != b}
    t0 = time.perf_counter()
    built = sharded.ShardedBKTIndex.build(
        data, 0, mesh=sharded.Mesh(devs), params=dict(GRAPH_PARAMS),
        save_to=folder)
    sync_cards()
    build_s = time.perf_counter() - t0
    del built
    t0 = time.perf_counter()
    m4 = sharded.ShardedBKTIndex.load(folder, mesh=sharded.Mesh(devs),
                                      dense=True)
    sync_cards()
    load4_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m1 = sharded.ShardedBKTIndex.load(
        folder, mesh=sharded.Mesh([devs[0]] * MESH_CARDS), dense=True)
    sync_cards()
    load1_s = time.perf_counter() - t0
    # the exact truth: FLAT over the cards, held to one card's exact scan
    flat = sharded.ShardedFlatIndex(data, 0, 1, mesh=sharded.Mesh(devs))
    parts = [flat.search(queries[lo:lo + 512], K)
             for lo in range(0, len(queries), 512)]
    truth = np.concatenate([p[1] for p in parts])
    del flat
    ref_ids, ref_d = exact_truth(dist_ops, torch.from_numpy(data).to(
        devs[0]), torch.from_numpy(queries).to(devs[0]), with_dists=True)
    flat_diff = separated_ids_equal(truth, ref_ids, ref_d,
                                    2e-5 * float(np.abs(ref_d).max()))
    # the cards' own path: counts zeroed just before, read just after
    walk_ops.reset_launch_counts()
    block_dots.reset_launch_counts()
    got4 = {mode: mesh_batches(m4, queries, mode)
            for mode in ("beam_exact", "beam_binned", "dense")}
    walk_cards = walk_ops.launch_counts_by_card()
    block_cards = block_dots.launch_counts_by_card()
    got1 = {mode: mesh_batches(m1, queries, mode) for mode in got4}
    equal = {mode: bool(np.array_equal(got4[mode][1], got1[mode][1])
                        and got4[mode][0].tobytes()
                        == got1[mode][0].tobytes())
             for mode in got4}
    recall = {mode: recall_at_k(got4[mode][1], truth) for mode in got4}
    launches = {card: {
        "probe_block_dots_f32": block_cards.get(card, {}).get(
            "probe_block_dots_f32", 0),
        "walk_seed_f32": walk_cards.get(card, {}).get("walk_seed_f32", 0),
        "walk_score_f32": walk_cards.get(card, {}).get("walk_score_f32", 0)}
        for card in sorted(set(str(torch.device(d)) for d in devs))}
    # one beam batch on the cards against the same mesh on one card, in
    # turns; each shard alone on its card
    q = queries[:MESH_BATCH]
    times = {"cards": [], "one_card": []}
    for _ in range(MESH_TIMED_ROUNDS):
        for label, m in (("cards", m4), ("one_card", m1), ("one_card", m1),
                         ("cards", m4)):
            sync_cards()
            t0 = time.perf_counter()
            m.search(q, K)
            sync_cards()
            times[label].append((time.perf_counter() - t0) * 1e3)
    alone = []
    for eng in m4.engines:
        sync_cards()
        t0 = time.perf_counter()
        eng.search_tensors(q, m4._merge_k_local(K), m4.max_check,
                           m4.beam_width, None, m4.nbp_limit)
        sync_cards()
        alone.append((time.perf_counter() - t0) * 1e3)
    sharded.reset_card_transfer_bytes()
    m4.search(q, K)
    batch_bytes = sharded.card_transfer_bytes()
    trace = card_trace(m4, q)
    ms4 = statistics.median(times["cards"])
    ms1 = statistics.median(times["one_card"])
    out = {"rows": MESH_ROWS, "shards": MESH_CARDS, "devices": devs,
           "queries": len(queries), "peer_access": peer,
           "build_s": build_s,
           "build": "shard after shard, each on its card",
           "load_cards_s": load4_s, "load_one_card_s": load1_s,
           "flat_truth_differing_at_separated_ranks": flat_diff,
           "recall_at_10": recall,
           "cards_equal_one_card_bits": equal,
           "launches_by_card": launches,
           "beam_batch_ms_cards": times["cards"],
           "beam_batch_ms_one_card": times["one_card"],
           "beam_batch_ms_cards_p50": ms4,
           "beam_batch_ms_one_card_p50": ms1,
           "cards_over_one_card": ms4 / ms1,
           "shard_alone_ms": alone,
           "bytes_between_cards_per_batch": batch_bytes,
           "device_bytes_by_card": m4.device_bytes(),
           "ledger_by_card": devmem.snapshot().get("cards"),
           "memory_allocated_by_card": {
               f"cuda:{i}": torch.cuda.memory_allocated(i)
               for i in range(n_cards)},
           "card_trace": trace}
    check(flat_diff == 0, f"16a: the cards' FLAT truth differs from one "
                          f"card's exact scan at {flat_diff} slots")
    check(all(equal.values()), f"16a: the cards' ids or distance bits "
                               f"differ from one card's: {equal}")
    check(recall["beam_exact"] >= BEAM_RECALL_BAND[0],
          f"16a: beam recall@10 {recall['beam_exact']} below "
          f"{BEAM_RECALL_BAND[0]}")
    check(all(min(v.values()) >= 1 for v in launches.values()),
          f"16a: a card launched no kernel of its path: {launches}")
    check(set(batch_bytes) <= {"candidates"},
          f"16a: a beam batch moved {batch_bytes} between cards")
    return out, m4, got4, ms1, queries


class TimedLock:
    """A lock that keeps how long its acquires waited and how long it was
    held (phase 16b's reading of the process-wide capture lock)."""

    def __init__(self, lock):
        self.lock = lock
        self.acquires = 0
        self.wait_ns = self.max_wait_ns = 0
        self.held_ns = self.max_held_ns = 0
        self._t = 0

    def __enter__(self):
        t0 = time.perf_counter_ns()
        self.lock.acquire()
        self._t = time.perf_counter_ns()
        wait = self._t - t0
        self.acquires += 1
        self.wait_ns += wait
        self.max_wait_ns = max(self.max_wait_ns, wait)
        return self

    def __exit__(self, *exc):
        held = time.perf_counter_ns() - self._t
        self.held_ns += held
        self.max_held_ns = max(self.max_held_ns, held)
        self.lock.release()

    def reading(self) -> dict:
        return {"acquires": self.acquires, "wait_ms": self.wait_ns / 1e6,
                "max_wait_ms": self.max_wait_ns / 1e6,
                "held_ms": self.held_ns / 1e6,
                "max_held_ms": self.max_held_ns / 1e6}


def mesh_cards_16b(pt, m4, queries, dim) -> dict:
    """16b: a MeshServe=1 server over the mesh on the cards: 1,024
    requests answered as search_batch answers them, the bytes between
    cards per segment by kind, and the segment graphs captured and
    replayed on each card."""
    from sptag_tpu_torch.algo import engine as teng
    from sptag_tpu_torch.parallel import sharded
    from sptag_tpu_torch.serve import server as sserver
    from sptag_tpu_torch.serve import service as sservice

    q = queries[:MESH_SERVE_REQUESTS16]
    ctx = sservice.ServiceContext(sservice.ServiceSettings(
        listen_addr="127.0.0.1", default_max_result=K, mesh_serve=True))
    ctx.add_index("mesh", sharded.ServingAdapter(m4, dim))
    teng.reset_graph_stats()
    sharded.reset_card_transfer_bytes()
    # the capture lock's waits and holds: the captures (engine) and the
    # replays of the segment graphs (scheduler), over the whole run
    from sptag_tpu_torch.algo import scheduler as tsched

    timed_lock = TimedLock(teng.capture_lock)
    saved_locks = (teng.capture_lock, tsched.capture_lock)
    teng.capture_lock = tsched.capture_lock = timed_lock
    run = ServerRunner(sserver.SearchServer(ctx))
    try:
        texts = [f"$resultnum:{K} " + b64_query(v) for v in q]
        res, wall = pool_search(run.addr, texts)
        armed = m4._scheduler is not None
        stats = m4._scheduler.stats() if armed else {}
        # where each slot-state value's shard slices live
        placement = sorted({
            tuple(str(d) for d in v.devices())
            for pool in m4._scheduler._pools.values()
            for v in pool.state.values() if v is not None}) if armed else []
    finally:
        run.stop()
        m4.retire_scheduler()
        teng.capture_lock, tsched.capture_lock = saved_locks
    xfer = sharded.card_transfer_bytes()
    graphs = teng.graph_stats()
    sd, si, bad = served_arrays(res, K)
    want_d, want_i = sharded.ServingAdapter(m4, dim).search_batch(q, K)
    ids_equal = bool(np.array_equal(si, want_i))
    d_equal = bool(np.array_equal(sd.astype(np.float32), want_d))
    segments = stats.get("segments_eager", 0) \
        + stats.get("segments_replayed", 0)
    per_segment = {kind: b / max(segments, 1) for kind, b in xfer.items()
                   if kind in ("t_limit", "alive")}
    out = {"requests": len(texts), "wall_s": wall, "qps": len(texts) / wall,
           "unanswered": bad, "armed": armed,
           "ids_equal_search_batch": ids_equal,
           "distances_equal_search_batch": d_equal,
           "scheduler": {k: stats.get(k) for k in (
               "retired", "segments_eager", "segments_replayed",
               "graphs_captured")},
           "bytes_between_cards": xfer,
           "bytes_between_cards_per_segment": per_segment,
           "state_placement": placement,
           "graphs_by_card": graphs,
           "capture_lock": timed_lock.reading()}
    check(armed and bad == 0 and ids_equal and d_equal,
          f"16b: MeshServe armed {armed}, unanswered {bad}, ids equal "
          f"{ids_equal}, distances equal {d_equal}")
    check(set(xfer) <= {"queries", "t_limit", "alive", "candidates"},
          f"16b: state crossed between cards: {xfer}")
    check(placement == [tuple(map(str, m4.mesh.devices))],
          f"16b: the slot state's shard slices sit on {placement}, not on "
          f"their shards' cards")
    return out


MC_WORKER = r"""
import json
import sys
import time
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
import chip_smoke as cs
from sptag_tpu_torch.parallel import multihost
rank, port, folder = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", num_processes=cs.MESH_CARDS,
                     process_id=rank,
                     timeout_s=cs.MESH_COLLECTIVE_TIMEOUT_S)
import torch.distributed as dist
_, queries = cs.make_dataset(n=cs.MESH_ROWS, nq=cs.MESH_QUERIES, seed=7)
t0 = time.perf_counter()
idx = multihost.load_process_sharded(folder, dense=True)
load_s = time.perf_counter() - t0
out = {}
for mode in ("beam_exact", "dense"):
    d, i = cs.mesh_batches(idx, queries, mode)
    out[mode + "_d"], out[mode + "_i"] = d, i
q = queries[:cs.MESH_BATCH]
times, gathers = [], []
for _ in range(2 * cs.MESH_TIMED_ROUNDS):
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.search(q, cs.K)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    gathers.append(idx.last_all_gather_ms())
np.savez(f"{folder}/nccl_rank{rank}.npz", **out)
with open(f"{folder}/nccl_rank{rank}.json", "w") as f:
    json.dump({"rank": rank, "card": str(idx.mesh.devices[0]),
               "current": torch.cuda.current_device(),
               "backend": str(dist.get_backend()),
               "device_merge": bool(idx.device_merge),
               "load_s": load_s, "beam_batch_ms": times,
               "all_gather_ms": gathers}, f)
dist.barrier()
dist.destroy_process_group()
"""


def mesh_cards_16c(got4, ms1, folder, here) -> dict:
    """16c: one process a card over NCCL, each loading its shard of 16a's
    folder: ids and bits of 16a's mesh, the batch's wall time against the
    same four shards on one card, and the all-gather's time."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MC_WORKER, str(r), str(port), folder, here],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(MESH_CARDS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_PROCESS_TIMEOUT_S)[0]
                        .decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r, o in enumerate(outs):
            print(f"16c rank {r} (rc {rcs[r]}):\n{o[-3000:]}",
                  file=sys.stderr, flush=True)
        fail(f"16c: the NCCL ranks exited {rcs}")
    ranks = []
    for r in range(MESH_CARDS):
        with open(os.path.join(folder, f"nccl_rank{r}.json")) as f:
            ranks.append(json.load(f))
    got = [np.load(os.path.join(folder, f"nccl_rank{r}.npz"))
           for r in range(MESH_CARDS)]
    equal = {mode: all(np.array_equal(g[mode + "_i"], got4[mode][1])
                       and g[mode + "_d"].tobytes()
                       == got4[mode][0].tobytes() for g in got)
             for mode in ("beam_exact", "dense")}
    # the slowest rank's batch is the mesh's
    batch_ms = statistics.median(
        max(r["beam_batch_ms"][i] for r in ranks)
        for i in range(len(ranks[0]["beam_batch_ms"])))
    out = {"processes": MESH_CARDS, "wall_s": wall,
           "ranks": [{k: r[k] for k in ("rank", "card", "current", "backend",
                                        "device_merge", "load_s")}
                     for r in ranks],
           "ids_and_bits_equal_16a": equal,
           "beam_batch_ms_by_rank": [r["beam_batch_ms"] for r in ranks],
           "beam_batch_ms_p50": batch_ms,
           "one_card_batch_ms_p50": ms1,
           "over_one_card": batch_ms / ms1,
           "all_gather_ms_by_rank": [r["all_gather_ms"] for r in ranks]}
    check(all(equal.values()), f"16c: the NCCL ranks differ from 16a: "
                               f"{equal}")
    check(all(r["device_merge"] and "nccl" in r["backend"]
              and r["card"] == f"cuda:{r['rank']}" for r in ranks),
          f"16c: not one rank a card over NCCL: {out['ranks']}")
    check(batch_ms <= MESH_NCCL_MAX_RATIO * ms1,
          f"16c: a beam batch took {batch_ms} ms on the ranks, above "
          f"{MESH_NCCL_MAX_RATIO} x the one-card {ms1} ms")
    return out


def mesh_cards_phase(pt, block_dots, walk_ops, dist_ops, workdir,
                     here) -> None:
    """Phase 16: 16a-16c on a machine with at least two cards (shards
    round-robin over fewer than four); one line saying why it did not run
    otherwise."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        emit({"phase": 16, "ran": False, "cards": n_cards,
              "reason": f"the mesh across cards needs at least 2 cards; "
                        f"this machine has {n_cards}"})
        return
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    devs = [f"cuda:{s % n_cards}" for s in range(MESH_CARDS)]
    out16a, m4, got4, ms1, queries = mesh_cards_16a(
        pt, block_dots, walk_ops, dist_ops, workdir, devs)
    emit({"phase": "16a", "nvidia_smi_by_card":
          smi.stdout.strip().splitlines(), **out16a})
    emit({"phase": "16b", **mesh_cards_16b(pt, m4, queries, 128)})
    del m4
    if MESH_CARDS % n_cards == 0 and n_cards == MESH_CARDS:
        out16c = mesh_cards_16c(got4, ms1, os.path.join(workdir, "mesh16"),
                                here)
    else:
        out16c = {"ran": False, "reason": f"one rank a card needs "
                                          f"{MESH_CARDS} cards"}
    emit({"phase": "16c", **out16c,
          "phase_16_wall_s": time.perf_counter() - t_phase})


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--require-cards", type=int, default=0,
                        help="fail when the machine has fewer CUDA cards")
    parser.add_argument("--only-mesh-cards", action="store_true",
                        help="run phases 0, 1 and 16 only (the mesh across "
                             "the cards); prints no contract line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    if torch.cuda.device_count() < args.require_cards:
        fail(f"--require-cards {args.require_cards}: this machine has "
             f"{torch.cuda.device_count()} CUDA card(s)")
    # every torch.profiler session of the run (and of the processes it
    # starts) tears CUPTI down at its end: kept alive, the later sessions
    # of a busy process lose the card's kernels (sptag_tpu_torch/utils/
    # trace.py); a value already in the environment wins
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sptag_tpu_torch")):
        fail("run from a checkout of the repository (sptag_tpu_torch/ "
             "is missing)")
    # saved folders of the run; removed at exit
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    import sptag_tpu_torch as pt
    from sptag_tpu_torch import _build
    from sptag_tpu_torch.algo import dense
    from sptag_tpu_torch.ops import block_dots
    from sptag_tpu_torch.ops import distance as dist_ops
    from sptag_tpu_torch.ops import walk_body
    from sptag_tpu_torch.ops import walk_dots as walk_ops

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
    # the bounds of phase 2 against the card's table peaks
    global HBM_BYTES_S, PEAK_OPS_S
    from sptag_tpu_torch.utils import roofline

    peaks = roofline.capability()
    if peaks.source != "table":
        fail(f"the roofline table has no entry for {peaks.device_kind!r}")
    HBM_BYTES_S = peaks.hbm_gbps * 1e9
    PEAK_OPS_S = {"f32": peaks.peak_flops_f32,
                  "i8": peaks.peak_flops_int8}

    # ---- phase 1: build -----------------------------------------------------
    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as ex:
        probe_so = ex.submit(build_l2_probe, work.name)
        built = dict(zip(KERNEL_SOURCES, ex.map(_build.build,
                                                KERNEL_SOURCES)))
        probe_so = probe_so.result()
    from sptag_tpu_torch.ops import int8_dots, sketch_dots

    block_dots.library()
    walk_ops.library()
    walk_body.library()
    sketch_dots.library()
    int8_dots.library()
    emit({"phase": 1, "build_s": time.perf_counter() - t0,
          **{name: {"library": os.path.relpath(so, here), "nvcc_s": secs,
                    "ptxas": [ln.strip() for ln in
                              _build.build_log.get(name, "").splitlines()
                              if "registers" in ln or "spill" in ln]}
             for name, (so, secs) in built.items()}})

    if args.only_mesh_cards:
        mesh_cards_phase(pt, block_dots, walk_ops, dist_ops, work.name, here)
        if FAILED_CHECKS:
            fail(f"{len(FAILED_CHECKS)} check(s) failed: {FAILED_CHECKS}")
        emit({"phase": "end", "wall_s": time.perf_counter() - T_START,
              "only": [0, 1, 16]})
        return

    # ---- main path ----------------------------------------------------------
    block_dots.reset_launch_counts()

    # phase 3: f32 headline
    data, queries = make_dataset(n=200_000, nq=4096, seed=7)
    idx = pt.create_instance("BKT", "Float")
    for name, value in DENSE_PARAMS:
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
    # the float32 x int8 variant is the cascade's (phase 14)
    launches = {k: v for k, v in block_dots.launch_counts().items()
                if not k.endswith("f32i8")}
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
    # the walk's fixed-order kernels and the exact body's: zeroed just
    # before the beam searches
    walk_ops.reset_launch_counts()
    walk_body.reset_launch_counts()
    first_walk = FirstWalkDots(walk_ops, 1024)
    for binned in ("off", "on"):
        gidx.set_parameter("BinnedTopK", binned)
        with first_walk:
            gidx.search_batch(queries[:1024], K)        # builds the engine
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
    # the int8 scoring is the cascade's (phase 14)
    walk_launches = {k: v for k, v in walk_ops.launch_counts().items()
                     if k != "walk_score_i8"}
    # a captured walk's resident kernel runs in no batch of 1,024
    walk_launches.update({k: v for k, v in walk_body.launch_counts().items()
                          if k != "walk_resident"})
    emit({"phase": 7, "n": len(data), "d": data.shape[1],
          "build_s": gbuild_s, "build_stages_s": gidx.build_stages,
          "build_launches": build_launches, "walk_launches": walk_launches,
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
    check(all(v >= 1 for v in walk_launches.values()),
          f"the beam searches did not launch every walk kernel: "
          f"{walk_launches}")
    r_off, r_on = beam["off"]["recall_at_10"], beam["on"]["recall_at_10"]
    # on one folder the two packages' walks agree id for id
    # (tests/test_torch_bkt.py); the band covers the port's own forest
    lo, hi = BEAM_RECALL_BAND
    check(lo <= r_off <= hi,
          f"beam recall@10 {r_off} outside [{lo}, {hi}]")
    check(abs(r_on - r_off) <= 0.01,
          f"binned beam recall@10 {r_on} more than 0.01 from the exact "
          f"walk's {r_off}")
    # the exact body's kernels against its plain version, for phase 2
    gidx.set_parameter("BinnedTopK", "off")
    body_row = walk_body_row(walk_body, gidx._get_engine(), queries,
                             walk_launches)
    resident_row = walk_resident_row(walk_body, gidx, queries)
    gidx.set_parameter("BinnedTopK", "on")
    # the saved folder stays for phase 9, which mutates a loaded copy
    graph_folder = os.path.join(work.name, "bkt_graph")
    if gidx.save_index(graph_folder) != pt.ErrorCode.Success:
        fail("save_index (graph)")
    _, ids_gl = pt.load_index(graph_folder).search_batch(queries[:1024], K)
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

    # ---- phase 9: mutation on the f32 headline graph index ------------------
    refine_first, refine_launches = mutation_phase(
        pt, block_dots, data, graph_folder, queries, work.name)
    dense_add_phase(pt, data, queries)

    # ---- phase 10: KDT -----------------------------------------------------
    kdt_first, kdt_launches = kdt_phase(pt, block_dots, dist_ops, work.name)

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
                                 build8_launches),
                                ("refine_compaction", refine_first,
                                 refine_launches),
                                ("kdt_dense", kdt_first, kdt_launches)):
        if not first.args:
            fail(f"{path}: no block-dot call recorded during the build")
        for (kind, t), args in sorted(first.args.items()):
            cases.append((kind, t, path, counts, *args))
    for kind, t, path, counts, blocks, q, ids in cases:
        rows.append(block_dot_row(block_dots, kind, t, path, counts, blocks,
                                  q, ids))

    rows.extend(walk_dots_rows(walk_ops, first_walk,
                               walk_launches))
    rows.append(body_row)
    rows.append(resident_row)

    # ---- phase 6: where a search batch's time goes ---------------------------
    # device time from the profiler's CUDA rows (kernels and copies); the
    # idle share is against the untraced batch time of phases 3/4
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, run, untraced_ms, iterations=None, former=None):
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
                            row["device_launches"] / its,
                        # the fixed-order distance kernels' share
                        "walk_kernels_device_ms": {
                            e.key[:40]: e.self_device_time_total / 1e3
                            for e in dev_rows if "walk_" in e.key}})
        if former is not None:
            row["former_kernel"] = former
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
                  iterations=lambda: gidx._get_engine().last_iterations,
                  former=FORMER_BEAM_BATCH[binned])
    # the FLAT cascade's tiers (phase 14a's configuration)
    for tier in ("device", "host_all"):
        cflat = pt.create_instance("FLAT", "Float")
        for name, value in (("DistCalcMethod", "L2"), ("CascadeSearch", "1"),
                            ("TierBudgetSketch", str(CASCADE_B1)),
                            ("TierBudgetInt8", str(CASCADE_B2)),
                            ("CorpusTier", tier)):
            cflat.set_parameter(name, value)
        cflat.build(data)
        cflat.search_batch(queries[:1024], K)      # builds the tiers
        _, _, ctimes = timed_search(cflat, queries)
        breakdown(f"FLAT cascade {tier}, 1024 queries",
                  lambda: cflat.search_batch(queries[:1024], K),
                  batch_stats(ctimes, 1024)["batch_ms_p50"])
        del cflat
    # the beam cascade's tiers (phase 14c's configuration)
    for tier in ("device", "host"):
        cg = pt.load_index(graph_folder)
        for name, value in (("SearchMode", "beam"), ("CascadeSearch", "1"),
                            ("CorpusTier", tier)):
            cg.set_parameter(name, value)
        cg.search_batch(queries[:1024], K)         # builds the engine
        _, _, ctimes = timed_search(cg, queries)
        breakdown(f"beam cascade {tier}, 1024 queries",
                  lambda: cg.search_batch(queries[:1024], K),
                  batch_stats(ctimes, 1024)["batch_ms_p50"],
                  iterations=lambda: cg._get_engine().last_iterations)
        cg.close()
    # the dense cascade (phase 14b's configuration) on phase 3's index, on
    # the device tier: per query at 1,024 queries, and grouped G = 32 at
    # 8,192 (the phase-3 queries twice over, 14b's grouped call: a group
    # of 32 needs about 9 queries a block of 894, so a batch of 1,024
    # demotes to per-query)
    group_was = idx.get_parameter("DenseQueryGroup")
    cascade_knobs = (("CascadeSearch", "1"),
                     ("TierBudgetInt8", str(CASCADE_DENSE_B2)),
                     ("CorpusTier", "device"), ("DenseQueryGroup", "0"))
    for name, value in cascade_knobs:
        idx.set_parameter(name, value)
    idx.search_batch(queries[:1024], K)            # builds the layout
    _, _, ctimes = timed_search(idx, queries)
    breakdown("dense cascade device, per query, 1024 queries",
              lambda: idx.search_batch(queries[:1024], K),
              batch_stats(ctimes, 1024)["batch_ms_p50"])
    q2 = np.concatenate([queries, queries])
    idx.set_parameter("DenseQueryGroup", "32")
    idx.set_parameter("DenseUnionFactor", "4")
    idx.search_batch(q2, K)
    ctimes = [t for _ in range(3)
              for t in timed_search(idx, q2, batch=len(q2))[2]]
    check(idx.last_effective_group == 32,
          f"6: the grouped dense cascade ran G = "
          f"{idx.last_effective_group}, not 32")
    breakdown("dense cascade device, grouped G=32, 8192 queries",
              lambda: idx.search_batch(q2, K),
              batch_stats(ctimes, len(q2))["batch_ms_p50"])
    for name, value in (("CascadeSearch", "0"), ("TierBudgetInt8", "0"),
                        ("DenseUnionFactor", "2"),
                        ("DenseQueryGroup", group_was)):
        idx.set_parameter(name, value)

    # ---- phase 11: the walk's options and the slot scheduler -------------
    scheduler_phase(pt, gidx, queries, truth_f32, beam,
                    os.path.join(work.name, "kdt"), make_dataset(
                        n=50_000, d=100, nq=200)[1])

    # ---- phase 12: the socket search server on phase 7's folder ----------
    server_phase(pt, block_dots, graph_folder, queries, work.name, here)

    # ---- phase 13: the CLIs, a resumable build, the aggregator, the ------
    # control plane and AnnIndex on two shards of the headline
    first13b, first13c, launches13, out13 = cluster_phase(
        pt, block_dots, walk_ops, data, queries, truth_f32, work.name, here)
    for path, first in (("phase13_resumed_build", first13b),
                        ("phase13_aggregator_dense", first13c)):
        if not first.args:
            fail(f"{path}: no block-dot call recorded")
        for (kind, t), args in sorted(first.args.items()):
            rows.append(block_dot_row(block_dots, kind, t, path,
                                      launches13, *args))

    # ---- phase 14: the tiered corpus cascade ------------------------------
    first14, launches14 = cascade_phase(
        pt, dist_ops, data, queries, truth_f32, idx, recall, graph_folder,
        beam["off"]["recall_at_10"],
        os.path.join(work.name, "kdt"), work.name)
    # phase 2 for its kernels, with the card's L2 read rate
    l2_gbs = l2_read_gbs(probe_so)
    emit({"phase": "2_l2_read", "gb_per_s": l2_gbs,
          "buffer_bytes": L2_PROBE_BYTES, "passes": L2_PROBE_REPS})
    rows.extend(cascade_kernel_rows(first14, launches14, l2_gbs))
    for kind in ("probe_block_dots", "group_block_dots"):
        args = first14.args.get(f"{kind}_f32i8")
        if args is not None:
            rows.append(block_dot_row(block_dots, kind, "f32i8",
                                      "cascade_dense", launches14, *args))

    # ---- phase 15: observability (device half) and the mesh -------------
    observability_mesh_phase(pt, block_dots, data, queries, truth_f32, rows,
                             card, graph_folder, out13, work.name, here)

    # ---- phase 16: the mesh across the cards, one shard a card -----------
    mesh_cards_phase(pt, block_dots, walk_ops, dist_ops, work.name, here)

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
