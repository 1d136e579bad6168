// The exact walk body's glue (sptag_tpu_torch/algo/engine.py, _Walk): the
// pop, the neighbour expand with its visited test, the spare injection, the
// top-L merge and the counters, in two launches a body around the scoring
// launch of walk_dots.cu, or, for a walk captured whole, every body in one
// resident launch.
//
// Replaces no Pallas kernel: the JAX package's body is XLA glue around
// `lax.top_k` (sptag_tpu/algo/engine.py:540, `_walk_machine`), which the
// port first wrote as PyTorch ops (ops/walk_body.py keeps them as the plain
// version).  On the card those ran ~97 kernels a body (three sorts, gathers,
// scatters, elementwise ops) of ~2 us each, so a walk was bound by the
// launch latency of its kernels, not by its bytes: a body of B = 64 pops
// over L = 320 entries and m = 32 neighbours reads under 70 KB.  Here a
// body is these two kernels and the scoring: one CTA a query row, the
// row's state in shared memory, no sort of the whole (L + B m) row.
//
// Kernel 1, walk_pop_expand_kernel.  The beam is sorted by (distance,
// position): seeding and every merge emit it so.  The stable top-B of
// where(expanded, MAX, cand_d) is then the first B positions that are not
// expanded and hold a distance below MAX, in position order: a block-wide
// prefix count picks them, no sort (`pop_select`).  sel_d[0] (the pop's
// best distance) is the minimum of that score row under (value, position),
// a reduction.  The B x m neighbour ids are gathered and tested against
// the row's visited bytes, each thread issuing its next 8 slots' graph
// loads, then their visited loads, together (one serial chain of loads a
// slot measured half the kernel).  Unvisited ids go into a shared-memory
// hash table id -> lowest slot (atomicMin), so an id reached twice in one
// body stays fresh at its first slot in `flat` order only
// (`expand_slots`); after a barrier every valid id is marked visited
// (column N when a slot is -1) and the fresh ids are written for the
// scoring launch (-1 elsewhere).
//
// Kernel 2, walk_merge_kernel.  The stable sort of cat(cand_d, nd, inj_d)
// truncated at L, with its ids and expanded flags: each element's sort key
// is (order(distance), column), order() being torch.sort's (NaN last, -0
// equal to +0), so all keys differ.  Only candidates whose key is below
// the beam's last can land in the top L (their distances loaded 8 a
// thread at once; `merge_select`); those are compacted (a few hundred at
// most after the first bodies, none once the walk has converged) and
// sorted (`sort_candidates`: runs of 32 sorted by one warp each in
// registers, no barrier, then pairs of sorted blocks merged, each key
// placed by a binary search of the other block: a barrier a doubling, not
// one a bitonic stage), and merged with the sorted beam by rank
// (`merge_ranks`): a beam entry lands at its index plus the candidates
// below it, a candidate at its index plus the beam entries below it.
// Equal distances keep the lower column, so the beam wins ties, as the
// stable sort does.  The spare trigger, the injected spares, no_better,
// ptr and it follow _merge.
//
// Kernel 3, walk_resident_kernel: all `iters` bodies of a walk that runs
// with no host sync between bodies (_Walk.run_all: a whole-walk graph, a
// captured scheduler segment).  Kernels 1 and 2 pay, every body, a launch,
// a cold CTA, the beam read from device memory twice and written once,
// and a dependent visited load after each graph load: ~11-14 us a body at
// one query, a latency and not a byte count.  Here one cluster of CTAs
// serves one query row for the whole walk.  Its leader CTA keeps the row's
// state in shared memory: the beam (keys, distances, ids, expanded flags;
// two buffers, the merge writes the other), the hash table, the slots, the
// fresh list and the visited set as a bitset, filled once from the row's
// visited bytes; its thread 0 keeps the counters in registers.  A body is
// the pop and the expand (kernel 1's functions, the visited test against
// the bitset; each new mark also stored to the row's byte, fire and
// forget, so `visited` leaves as kernel 1 leaves it), the fresh ids
// compacted in slot order by a ballot a warp, the scoring of the fresh
// list (walk_dots.cuh's `warp_dots`: walk_score_kernel's bits), and the
// merge (kernel 2's functions).  While the bodies have many fresh ids the
// cluster's other CTAs score with the leader's warps, their distances
// stored into the leader's shared memory through distributed shared
// memory between two cluster barriers; from the first body with few the
// leader scores alone and its helpers wait at the last barrier, so a
// converged body costs no cluster barrier.  A body that pops nothing and
// merges nothing leaves the beam as it was, so the next pop is known
// without a scan; the spares a merge may inject are loaded a body ahead.
// A row that is not active (nbp tripped with no spare left, or past its
// t_limit) stays so: its later bodies only count `it` and mark column N,
// so the kernel stops there and writes that state (unless its beam ends
// past max_dist, where the empty slots still enter).  At the end the
// leader writes the state kernels 1 and 2 would leave after the same
// bodies, bit for bit.
//
// Each CTA's work area of kernels 1 and 2 (the hash table and slots; the
// beam's and the candidates' keys) lives in shared memory, or, for a plan
// too wide for a CTA's 227 KB, in a device scratch of one area a row that
// the wrapper allocates: the same code through generic pointers, slower.
// Kernel 3 runs only where its area fits (ops/walk_body.py).
//
// State: cand_ids (Q, L) int64, cand_d (Q, L) float32, expanded (Q, L + 1)
// and visited (Q, N + 1) bool (bytes 0/1), no_better / ptr / it / t_limit /
// n_spare (Q,) int64, graph (N, m) int32, all contiguous.  Kernel 1 updates
// expanded and visited in place; kernels 2 and 3 write a new state (3
// updates visited in place).  None allocates or synchronises; each launches
// on the caller's stream, so CUDA graphs capture them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "walk_dots.cuh"

namespace cg = cooperative_groups;
using namespace sptag_walk_dots;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kPadKey = ~0ull;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kUnroll = 8;             // independent loads a thread issues
constexpr int kRun = 32;               // candidates a warp sorts at once
// fresh ids the leader's warps score alone (16 a warp)
constexpr int kAloneRows = kWarps * 16;

// torch.sort's order of float32 as an unsigned key: NaN after everything,
// -0 equal to +0
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return 0xffffffffu;
  const uint32_t u = (f == 0.0f) ? 0u : __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long sort_key(float f,
                                                       uint32_t col) {
  return (static_cast<unsigned long long>(order_key(f)) << 32) | col;
}

__device__ __forceinline__ unsigned hash_slot(int id, int log2_t) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> (32 - log2_t);
}

// entries of the sorted `keys[0, n)` below `key`
__device__ __forceinline__ int rank_below(const unsigned long long* keys,
                                          int n, unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- the body's phases, shared by the kernels ------------------------------

// The pop's rank-select over a beam sorted by (distance, position): the
// first B positions not expanded and below max_dist, in order, go to
// spos[0, min(eligible, B)); *top gets the least (score, position) key of
// where(expanded, max_dist, d).  Returns the eligible count.  One barrier
// inside; spos is complete after the caller's next one.
__device__ __forceinline__ int pop_select(const float* d_row,
                                          const uint8_t* exp_row, int L,
                                          int B, float max_dist, int* spos,
                                          int* warp_count,
                                          unsigned long long* warp_best,
                                          unsigned long long* top) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (L + kThreads - 1) / kThreads;
  const int lo = min(t * per, L), hi = min(lo + per, L);
  int count = 0;
  unsigned long long best = kPadKey;
  for (int i = lo; i < hi; ++i) {
    const float d = d_row[i];
    const bool done = exp_row[i] != 0;
    count += (!done && d < max_dist);
    const unsigned long long key = sort_key(done ? max_dist : d, i);
    best = key < best ? key : best;
  }
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long v = __shfl_xor_sync(kFull, best, off);
    best = v < best ? v : best;
  }
  if (lane == 31) warp_count[warp] = incl;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();

  // ranks: the first B eligible positions in order are the pops
  int rank = incl - count, total = 0;
  unsigned long long least = kPadKey;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) rank += warp_count[w];
    total += warp_count[w];
    least = warp_best[w] < least ? warp_best[w] : least;
  }
  for (int i = lo; i < hi && rank < B; ++i) {
    if (exp_row[i] == 0 && d_row[i] < max_dist) spos[rank++] = i;
  }
  *top = least;
  return total;
}

// The B * m neighbour slots of the pops' graph rows `srow` (-1: no pop),
// in `flat` order: each slot's id is tested by `seen(id)`, and an unseen
// id goes into the hash table id -> lowest slot (hkey / howner, cleared by
// the caller).  slot[c] gets the id's hash index, -1 for an invalid id (-1
// in the graph, or no pop), -2 for a seen one.  kUnroll slots a thread at
// once: their graph loads, then their tests, in flight together.  Returns
// whether this thread met an invalid slot.
template <typename Seen>
__device__ __forceinline__ bool expand_slots(
    const int32_t* __restrict__ graph, const int* srow, int m, int C,
    int log2_t, int* hkey, int* howner, int* slot, Seen seen) {
  const int T = 1 << log2_t;
  bool invalid = false;
  for (int base = threadIdx.x; base < C; base += kThreads * kUnroll) {
    int nid[kUnroll];
    uint8_t was[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      nid[u] = -1;
      if (c < C) {
        const int b = c / m;
        if (srow[b] >= 0) {
          nid[u] = graph[static_cast<int64_t>(srow[b]) * m + (c - b * m)];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      was[u] = nid[u] >= 0 ? seen(nid[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      if (c >= C) break;
      if (nid[u] < 0) {
        slot[c] = -1;
        invalid = true;
      } else if (was[u]) {
        slot[c] = -2;
      } else {
        unsigned h = hash_slot(nid[u], log2_t);
        while (true) {
          const int prev = atomicCAS(&hkey[h], -1, nid[u]);
          if (prev == -1 || prev == nid[u]) {
            atomicMin(&howner[h], c);
            break;
          }
          h = (h + 1) & (T - 1);
        }
        slot[c] = static_cast<int>(h);
      }
    }
  }
  return invalid;
}

// The merge's candidates j in [0, n), column L + col(j), whose key
// (order(dist(j)), L + col(j)) is below `last`, the beam's last key: they
// alone can enter the top L.  Compacted into ckey in no order and counted
// in *count (zeroed by the caller, read after a barrier); kUnroll
// distances a thread in flight at once.
template <typename Dist, typename Col>
__device__ __forceinline__ void merge_select(int n, int L,
                                             unsigned long long last,
                                             Dist dist, Col col,
                                             unsigned long long* ckey,
                                             int* count) {
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      d[u] = j < n ? dist(j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      if (j >= n) break;
      const unsigned long long key = sort_key(d[u], L + col(j));
      if (key < last) ckey[atomicAdd(count, 1)] = key;
    }
  }
}

// ckey[0, F), padded with kPadKey to whole runs of kRun, each run sorted
// ascending by one warp in registers: a bitonic network of shuffles, no
// barrier.  The caller syncs before and after.
__device__ __forceinline__ void sort_runs(unsigned long long* ckey, int F) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int runs = (F + kRun - 1) / kRun;
  for (int r = warp; r < runs; r += kWarps) {
    const int i = r * kRun + lane;
    unsigned long long v = i < F ? ckey[i] : kPadKey;
#pragma unroll
    for (int k = 2; k <= kRun; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, v, j);
        // an ascending block keeps the smaller at the lower lane of a pair
        const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
        v = keep_min ? (o < v ? o : v) : (o < v ? v : o);
      }
    }
    ckey[i] = v;
  }
}

// ckey[0, F) sorted ascending (all keys distinct): runs of kRun sorted
// in registers (`sort_runs`), then pairs of sorted blocks of 32, 64, ...
// merged from one buffer into the other (tmp, as large), each key placed
// at its index in its block plus the partner block's keys below it (a
// binary search; the partner is the block after or before it, empty past
// the end).  Returns the buffer that holds the F keys in order (pads after
// them).  Barriers inside; the caller syncs before.
__device__ __forceinline__ unsigned long long* sort_candidates(
    unsigned long long* ckey, unsigned long long* tmp, int F) {
  sort_runs(ckey, F);
  __syncthreads();
  const int P = (F + kRun - 1) / kRun * kRun;
  unsigned long long* src = ckey;
  unsigned long long* dst = tmp;
  for (int s = kRun; s < P; s <<= 1) {
    for (int e = threadIdx.x; e < P; e += kThreads) {
      const int base = e & ~(2 * s - 1);
      const int off = e - base;
      const unsigned long long key = src[e];
      const bool first = off < s;
      const unsigned long long* blk = src + (first ? base + s : base);
      const int n = first ? max(0, min(base + 2 * s, P) - base - s) : s;
      dst[base + (first ? off : off - s) + rank_below(blk, n, key)] = key;
    }
    __syncthreads();
    unsigned long long* w = src;
    src = dst;
    dst = w;
  }
  return src;
}

// The merged order of the beam's sorted keys bkey[0, L) and the
// candidates' sorted keys cand[0, F) (all distinct): a beam entry lands at
// its index plus the candidates below it, a candidate at its index plus
// the beam entries below it, each count a binary search.  Calls
// beam_to(i, pos) and cand_to(key, pos) for the landings below L.  The
// caller syncs after.
template <typename BeamTo, typename CandTo>
__device__ __forceinline__ void merge_ranks(const unsigned long long* bkey,
                                            int L,
                                            const unsigned long long* cand,
                                            int F, BeamTo beam_to,
                                            CandTo cand_to) {
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const int pos = i + rank_below(cand, F, bkey[i]);
    if (pos < L) beam_to(i, pos);
  }
  for (int j = threadIdx.x; j < F && j < L; j += kThreads) {
    const unsigned long long key = cand[j];
    const int pos = j + rank_below(bkey, L, key);
    if (pos < L) cand_to(key, pos);
  }
}

// spare i of the row's injection (-1 / max_dist where none)
__device__ __forceinline__ void injected(int i, bool trigger, int64_t p,
                                         int Ps, const int64_t* sid,
                                         const float* sd, float max_dist,
                                         int64_t* id, float* d) {
  const int64_t idx = p + i;
  const bool ok = trigger && idx < Ps;
  const int64_t safe = idx < Ps - 1 ? idx : Ps - 1;
  const int64_t v = ok ? sid[safe] : -1;
  *id = v;
  *d = (ok && v >= 0) ? sd[safe] : max_dist;
}

// the frontier fell behind the next spare, or the nbp counter would trip
// with spares left
__device__ __forceinline__ bool spare_trigger(bool active, int64_t nb,
                                              int64_t p, int64_t ns,
                                              float best_d, int Ps,
                                              const float* sd,
                                              long long nbp_limit) {
  const float next_d = sd[p < Ps - 1 ? p : Ps - 1];
  return active && p < ns && (best_d > next_d || nb + 1 >= nbp_limit);
}

// ---- kernel 1 --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
walk_pop_expand_kernel(const int64_t* __restrict__ cand_ids,
                       const float* __restrict__ cand_d,
                       uint8_t* __restrict__ expanded,
                       uint8_t* __restrict__ visited,
                       const int64_t* __restrict__ no_better,
                       const int64_t* __restrict__ ptr,
                       const int64_t* __restrict__ it,
                       const int64_t* __restrict__ t_limit,
                       const int64_t* __restrict__ n_spare,
                       const int32_t* __restrict__ graph,
                       int64_t* __restrict__ sel_ids,
                       int64_t* __restrict__ fresh_ids,
                       int32_t* __restrict__ ctl,
                       int L, int B, int m, long long N, int k_eff,
                       long long nbp_limit, float max_dist, int log2_t,
                       unsigned char* __restrict__ scratch,
                       long long row_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* area = scratch != nullptr
                        ? scratch + blockIdx.x * row_bytes : smem;
  const int T = 1 << log2_t;
  int* hkey = reinterpret_cast<int*>(area);      // id, -1 empty
  int* howner = hkey + T;                        // lowest slot of the id
  int* slot = howner + T;                        // hash index; -1, -2
  int* spos = slot + B * m;                      // popped positions
  int* srow = spos + B;                          // their rows; -1 none
  __shared__ int warp_count[kWarps];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ int s_npick, s_invalid;

  const int q = blockIdx.x, t = threadIdx.x;
  const int C = B * m;
  const int64_t* ids_row = cand_ids + static_cast<int64_t>(q) * L;
  const float* d_row = cand_d + static_cast<int64_t>(q) * L;
  uint8_t* exp_row = expanded + static_cast<int64_t>(q) * (L + 1);
  uint8_t* vis_row = visited + static_cast<int64_t>(q) * (N + 1);

  // the row's counters, in flight while the beam is read (used after
  // the first barrier)
  int64_t nb = 0, p = 0, ns = 0, itv = 0, tl = 0;
  float kth_d = 0.0f;
  if (t == 0) {
    nb = no_better[q];
    p = ptr[q];
    ns = n_spare != nullptr ? n_spare[q] : 0;
    itv = it[q];
    tl = t_limit[q];
    kth_d = d_row[k_eff - 1];
    s_invalid = 0;
  }
  for (int i = t; i < T; i += kThreads) {
    hkey[i] = -1;
    howner[i] = INT_MAX;
  }

  unsigned long long top;
  const int total = pop_select(d_row, exp_row, L, B, max_dist, spos,
                               warp_count, warp_best, &top);
  if (t == 0) {
    const bool active = (nb < nbp_limit || (n_spare != nullptr && p < ns))
                        && itv < tl;
    s_npick = active ? min(total, B) : 0;
    // sel_d[0], read before any pop is marked
    const int bpos = static_cast<int>(top & 0xffffffffu);
    const float best_d = exp_row[bpos] ? max_dist : d_row[bpos];
    int32_t* c = ctl + 3 * static_cast<int64_t>(q);
    c[0] = active;
    c[1] = __float_as_int(best_d);
    c[2] = best_d > kth_d;
  }
  __syncthreads();

  // ---- mark the pops, gather their neighbours, test them
  const int npick = s_npick;
  for (int b = t; b < B; b += kThreads) {
    int64_t id = -1;
    int row = -1;
    if (b < npick) {
      exp_row[spos[b]] = 1;
      id = ids_row[spos[b]];
      row = id < 0 ? 0 : static_cast<int>(id);
    }
    sel_ids[static_cast<int64_t>(q) * B + b] = id;
    srow[b] = row;
  }
  if (t == 0 && npick < B) exp_row[L] = 1;         // the dump column
  __syncthreads();
  const bool invalid = expand_slots(
      graph, srow, m, C, log2_t, hkey, howner, slot,
      [&](int id) -> uint8_t { return vis_row[id]; });
  if (invalid) s_invalid = 1;
  __syncthreads();

  // ---- fresh: unvisited and the id's first slot; mark every valid id
  int64_t* fresh_row = fresh_ids + static_cast<int64_t>(q) * C;
  for (int c = t; c < C; c += kThreads) {
    const int h = slot[c];
    int64_t id = -1;
    if (h >= 0) {
      const int nid = hkey[h];
      if (howner[h] == c) id = nid;
      vis_row[nid] = 1;
    }
    fresh_row[c] = id;
  }
  if (t == 0 && s_invalid) vis_row[N] = 1;
}

// ---- kernel 2 --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
walk_merge_kernel(const int64_t* __restrict__ cand_ids,
                  const float* __restrict__ cand_d,
                  const uint8_t* __restrict__ expanded,
                  const float* __restrict__ nd,
                  const int64_t* __restrict__ fresh_ids,
                  const int32_t* __restrict__ ctl,
                  const int64_t* __restrict__ no_better,
                  const int64_t* __restrict__ ptr,
                  const int64_t* __restrict__ it,
                  const int64_t* __restrict__ n_spare,
                  const int64_t* __restrict__ spare_ids,
                  const float* __restrict__ spare_d,
                  int64_t* __restrict__ out_ids, float* __restrict__ out_d,
                  uint8_t* __restrict__ out_exp,
                  int64_t* __restrict__ out_nb,
                  int64_t* __restrict__ out_ptr,
                  int64_t* __restrict__ out_it, int L, int C, int Ps,
                  int inject, int cap, long long nbp_limit,
                  float max_dist, unsigned char* __restrict__ scratch,
                  long long row_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* area = scratch != nullptr
                        ? scratch + blockIdx.x * row_bytes : smem;
  unsigned long long* bkey = reinterpret_cast<unsigned long long*>(area);
  int64_t* bids = reinterpret_cast<int64_t*>(bkey + L);
  unsigned long long* ckey = bkey + 2 * L;
  unsigned long long* tmp = ckey + cap;
  uint8_t* bexp = reinterpret_cast<uint8_t*>(tmp + cap);
  __shared__ int s_count, s_trigger;

  const int q = blockIdx.x, t = threadIdx.x;
  const int I = n_spare != nullptr ? inject : 0;
  const int64_t* ids_row = cand_ids + static_cast<int64_t>(q) * L;
  const float* d_row = cand_d + static_cast<int64_t>(q) * L;
  const uint8_t* exp_row = expanded + static_cast<int64_t>(q) * (L + 1);
  const float* nd_row = nd + static_cast<int64_t>(q) * C;
  const int64_t* fresh_row = fresh_ids + static_cast<int64_t>(q) * C;
  const int64_t* sid_row = spare_ids + static_cast<int64_t>(q) * Ps;
  const float* sd_row = spare_d + static_cast<int64_t>(q) * Ps;
  const int32_t* c = ctl + 3 * static_cast<int64_t>(q);
  const bool active = c[0] != 0;
  const int64_t p = ptr[q];

  if (t == 0) {
    s_count = 0;
    s_trigger = n_spare != nullptr
                && spare_trigger(active, no_better[q], p, n_spare[q],
                                 __int_as_float(c[1]), Ps, sd_row,
                                 nbp_limit);
  }
  for (int i = t; i < L; i += kThreads) {
    bkey[i] = sort_key(d_row[i], i);
    bids[i] = ids_row[i];
    bexp[i] = exp_row[i];
  }
  __syncthreads();

  // ---- the candidates that can enter the top L, compacted and sorted
  const bool trigger = s_trigger != 0;
  merge_select(C + I, L, sort_key(d_row[L - 1], L - 1),
               [&](int j) -> float {
                 if (j < C) return nd_row[j];
                 int64_t unused;
                 float d;
                 injected(j - C, trigger, p, Ps, sid_row, sd_row, max_dist,
                          &unused, &d);
                 return d;
               },
               [](int j) { return j; }, ckey, &s_count);
  __syncthreads();
  const int F = s_count;
  const unsigned long long* sorted = sort_candidates(ckey, tmp, F);

  // ---- merge by rank into the new top L
  const int64_t row = static_cast<int64_t>(q) * L;
  uint8_t* oexp = out_exp + static_cast<int64_t>(q) * (L + 1);
  merge_ranks(
      bkey, L, sorted, F,
      [&](int i, int pos) {
        const float d = d_row[i];
        out_d[row + pos] = d;
        out_ids[row + pos] = d < max_dist ? bids[i] : -1;
        oexp[pos] = bexp[i];
      },
      [&](unsigned long long key, int pos) {
        const int col = static_cast<int>(key & 0xffffffffu) - L;
        float d;
        int64_t id;
        if (col < C) {
          d = nd_row[col];
          id = fresh_row[col];
        } else {
          injected(col - C, trigger, p, Ps, sid_row, sd_row, max_dist, &id,
                   &d);
        }
        out_d[row + pos] = d;
        out_ids[row + pos] = d < max_dist ? id : -1;
        oexp[pos] = 0;
      });
  if (t == 0) {
    oexp[L] = 0;                                   // the dump column
    const int64_t nb = no_better[q];
    int64_t next = active ? (c[2] ? nb + 1 : 0) : nb;
    if (trigger) next = 0;                         // a re-seed resets it
    out_nb[q] = next;
    out_ptr[q] = trigger ? p + inject : p;
    out_it[q] = it[q] + 1;
  }
}

// ---- kernel 3 --------------------------------------------------------------

// The row's shared values and the barriers' scratch, in the leader's shared
// memory (thread 0 keeps the counters in registers).
struct ResidentMisc {
  unsigned long long warp_best[kWarps];
  long long p, p_next;
  int warp_count[kWarps];
  int npick, invalid, nfresh, done, count, trigger, tail_past_max, park;
};
constexpr int kMiscBytes = 256;
static_assert(sizeof(ResidentMisc) <= kMiscBytes, "misc");

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// Kernel 3's shared memory, byte offsets from the base: the query, the
// row's shared values, the two beam buffers (keys 8 L, distances 4 L, ids
// 4 L, flags L), the hash table (the merge's candidate keys and its sort's
// second buffer reuse it), the slots, the pops' positions and rows, the
// fresh list (ids, distances, slots), the compaction's counts (a warp a
// round of kThreads slots), the next injection's spares (ids, distances),
// the visited bitset.  ops/walk_body.py's resident_smem computes the same
// total.
struct ResidentLayout {
  long long q, misc, beam0, beam1, hash, slot, pops, fresh, rounds, inj,
      bits, total;
};

__host__ __device__ inline ResidentLayout resident_layout(
    int L, int B, int m, int inject, long long N, int D, int log2_t) {
  const long long C = static_cast<long long>(B) * m;
  const long long T = 1LL << log2_t;
  const long long cand = (C + inject + kRun - 1) / kRun * kRun;
  ResidentLayout s;
  s.q = 0;
  s.misc = s.q + align16(4LL * ((D + kChunk - 1) / kChunk * kChunk));
  s.beam0 = s.misc + kMiscBytes;
  s.beam1 = s.beam0 + align16(17LL * L);
  s.hash = s.beam1 + align16(17LL * L);
  s.slot = s.hash + align16(8 * (T > 2 * cand ? T : 2 * cand));
  s.pops = s.slot + align16(4 * C);
  s.fresh = s.pops + align16(8LL * B);
  s.rounds = s.fresh + align16(12 * C);
  s.inj = s.rounds + align16(4LL * kWarps * ((C + kThreads - 1) / kThreads));
  s.bits = s.inj + align16(12LL * inject);
  s.total = s.bits + align16(4 * ((N + 1 + 31) / 32));
  return s;
}

// a beam buffer's arrays
struct Beam {
  unsigned long long* key;
  float* d;
  int* id;
  uint8_t* exp;
  __device__ Beam(unsigned char* base, int L)
      : key(reinterpret_cast<unsigned long long*>(base)),
        d(reinterpret_cast<float*>(base + 8LL * L)),
        id(reinterpret_cast<int*>(base + 12LL * L)),
        exp(base + 16LL * L) {}
};

// 4 bits: which bytes of x are not 0
__device__ __forceinline__ unsigned byte_mask(unsigned x) {
  const unsigned y = __vcmpne4(x, 0u);
  return ((y >> 7) & 1u) | ((y >> 14) & 2u) | ((y >> 21) & 4u) |
         ((y >> 28) & 8u);
}

// bits[0, (N + 32) / 32) = the row's N + 1 visited bytes, one bit each:
// 16-byte loads from the aligned address at or below the row's start,
// the bytes outside the row dropped.
__device__ __forceinline__ void fill_bits(const uint8_t* vis_row,
                                          long long N, unsigned* bits) {
  const long long W = (N + 1 + 31) / 32;
  for (long long w = threadIdx.x; w < W; w += kThreads) bits[w] = 0u;
  __syncthreads();
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(vis_row) & 15);
  const uint4* chunk = reinterpret_cast<const uint4*>(vis_row - off);
  const long long chunks = (N + 1 + off + 15) / 16;
#pragma unroll 4
  for (long long g = threadIdx.x; g < chunks; g += kThreads) {
    const uint4 v = chunk[g];
    unsigned m16 = byte_mask(v.x) | (byte_mask(v.y) << 4) |
                   (byte_mask(v.z) << 8) | (byte_mask(v.w) << 12);
    const long long i0 = 16 * g - off;      // the row index of byte 0
    if (i0 < 0) m16 &= ~((1u << -i0) - 1u);
    if (N - i0 + 1 < 16) m16 &= (1u << (N - i0 + 1)) - 1u;
    if (m16 == 0u) continue;
    const long long w = (i0 + 32) / 32 - 1;  // floor(i0 / 32), i0 > -32
    const unsigned long long v64 = static_cast<unsigned long long>(m16)
                                   << (i0 - 32 * w);
    if (static_cast<unsigned>(v64) != 0u) {
      atomicOr(&bits[w], static_cast<unsigned>(v64));
    }
    if ((v64 >> 32) != 0u) {
      atomicOr(&bits[w + 1], static_cast<unsigned>(v64 >> 32));
    }
  }
}

// one CTA an SM: ptxas may take the registers the scoring's 32 partials
// and 8 rows in flight need (164 on sm_90a; at the 128 of
// __launch_bounds__(kThreads) alone they spilled, and a captured walk of
// 4 or 16 rows took 12-13% longer on an H100)
template <int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
walk_resident_kernel(const int64_t* __restrict__ cand_ids,
                     const float* __restrict__ cand_d,
                     const uint8_t* __restrict__ expanded,
                     uint8_t* __restrict__ visited,
                     const int64_t* __restrict__ no_better,
                     const int64_t* __restrict__ ptr,
                     const int64_t* __restrict__ it,
                     const int64_t* __restrict__ t_limit,
                     const int64_t* __restrict__ n_spare,
                     const int64_t* __restrict__ spare_ids,
                     const float* __restrict__ spare_d,
                     const int32_t* __restrict__ graph,
                     const float* __restrict__ queries,
                     const float* __restrict__ x,
                     const float* __restrict__ xn,
                     int64_t* __restrict__ out_ids,
                     float* __restrict__ out_d,
                     uint8_t* __restrict__ out_exp,
                     int64_t* __restrict__ out_nb,
                     int64_t* __restrict__ out_ptr,
                     int64_t* __restrict__ out_it, int L, int B, int m,
                     long long N, int D, int k_eff, long long nbp_limit,
                     int Ps, int inject, int iters, float max_dist,
                     int log2_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncta = static_cast<int>(cluster.num_blocks());
  const bool leader = rank == 0;
  const int q = blockIdx.x / ncta;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int C = B * m;
  const int I = n_spare != nullptr ? inject : 0;
  const int rounds = (C + kThreads - 1) / kThreads;
  const int cand = (C + I + kRun - 1) / kRun * kRun;   // candidate room
  const ResidentLayout lay = resident_layout(L, B, m, I, N, D, log2_t);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  ResidentMisc* ms = reinterpret_cast<ResidentMisc*>(smem + lay.misc);
  int* hkey = reinterpret_cast<int*>(smem + lay.hash);
  int* howner = hkey + (1 << log2_t);
  unsigned long long* ckey =
      reinterpret_cast<unsigned long long*>(smem + lay.hash);
  int* slot = reinterpret_cast<int*>(smem + lay.slot);  // then fresh index
  int* spos = reinterpret_cast<int*>(smem + lay.pops);
  int* srow = spos + B;
  int* fid = reinterpret_cast<int*>(smem + lay.fresh);
  float* fnd = reinterpret_cast<float*>(fid + C);
  int* fslot = fid + 2 * C;
  int* round_count = reinterpret_cast<int*>(smem + lay.rounds);
  int64_t* inj_id = reinterpret_cast<int64_t*>(smem + lay.inj);
  float* inj_d = reinterpret_cast<float*>(inj_id + I);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + lay.bits);
  unsigned char* buf[2] = {smem + lay.beam0, smem + lay.beam1};
  const int64_t row = static_cast<int64_t>(q) * L;
  const int64_t* sid_row = spare_ids + static_cast<int64_t>(q) * Ps;
  const float* sd_row = spare_d + static_cast<int64_t>(q) * Ps;
  uint8_t* vis_row = visited + static_cast<int64_t>(q) * (N + 1);

  // every CTA: the query, zero padded, and its norm
  const int dpad = (D + kChunk - 1) / kChunk * kChunk;
  const float* qr = queries + static_cast<int64_t>(q) * D;
  for (int d = t; d < dpad; d += kThreads) qs[d] = d < D ? qr[d] : 0.0f;
  // the leader's thread 0 holds the row's counters
  long long nb = 0, p = 0, ns = 0, itv = 0, tl = 0;
  if (leader) {
    // the beam (ids of entries at max_dist are -1, as a merge leaves them),
    // the counters, the visited bitset
    Beam b(buf[0], L);
    for (int i = t; i < L; i += kThreads) {
      const float d = cand_d[row + i];
      b.key[i] = sort_key(d, i);
      b.d[i] = d;
      b.id[i] = d < max_dist ? static_cast<int>(cand_ids[row + i]) : -1;
      b.exp[i] = expanded[static_cast<int64_t>(q) * (L + 1) + i];
    }
    if (t == 0) {
      nb = no_better[q];
      p = ptr[q];
      ns = n_spare != nullptr ? n_spare[q] : 0;
      itv = it[q];
      tl = t_limit[q];
      ms->p = p;
      ms->done = 0;
    }
    fill_bits(vis_row, N, bits);
  }
  __syncthreads();
  const float qn = EPI == kEpiL2 ? warp_sqnorm<VEC, false>(qs, D, lane)
                                 : 0.0f;
  cluster.sync();                 // every CTA runs; the leader's state set
  const ResidentMisc* lms = cluster.map_shared_rank(ms, 0);
  const int* lfid = cluster.map_shared_rank(fid, 0);
  float* lfnd = cluster.map_shared_rank(fnd, 0);

  // the next injection's spares (thread 0's distance is the next
  // spare's), loaded a body ahead of the merge that uses them
  int64_t spare_v = 0;
  float spare_dv = 0.0f;
  auto load_spares = [&](long long pn) {
    if (n_spare != nullptr && t < (I > 1 ? I : 1)) {
      const long long idx = pn + t;
      const long long safe = idx < Ps - 1 ? idx : Ps - 1;
      if (t < I) spare_v = sid_row[safe];
      spare_dv = sd_row[safe];
    }
  };
  if (leader) load_spares(ptr[q]);
  int cur = 0, body = 0;
  // thread 0, from the pop to the merge: the row is active, the pop's
  // best distance, the frontier is worse than the k-th, the pop's least
  // key
  bool act = false, fw = false;
  float best = 0.0f;
  unsigned long long top = kPadKey;
  // the last body neither popped nor merged: the beam is as the last pop
  // found it, so the pop is too
  bool stale = false;
  // the other CTAs of the cluster score with the leader's (every CTA
  // knows); from the first body with few fresh ids on they wait at the
  // last barrier
  bool helped = ncta > 1;
  for (; body < iters; ++body) {
    int npick = 0;
    if (leader) {
      Beam b(buf[cur], L);
      __syncthreads();            // the last merge is done with ckey, ms
      // ---- pop (kernel 1's), on the beam in shared memory
      const int total = stale ? 0
                              : pop_select(b.d, b.exp, L, B, max_dist, spos,
                                           ms->warp_count, ms->warp_best,
                                           &top);
      if (t == 0) {
        act = (nb < nbp_limit || (n_spare != nullptr && p < ns)) && itv < tl;
        const int bpos = static_cast<int>(top & 0xffffffffu);
        best = b.exp[bpos] ? max_dist : b.d[bpos];
        fw = best > b.d[k_eff - 1];
        const bool past = order_key(b.d[L - 1]) > order_key(max_dist);
        ms->npick = act ? min(total, B) : 0;
        ms->tail_past_max = past;
        ms->invalid = 0;
        // not active stays so: the rest are no-ops but for it and column
        // N, unless a tail past max_dist (inf, NaN) lets the empty slots
        // in
        ms->done = !act && !past;
      }
      __syncthreads();
      npick = ms->npick;
      if (npick > 0) {
        // ---- mark the pops, expand against the bitset
        for (int i = t; i < (1 << log2_t); i += kThreads) {
          hkey[i] = -1;
          howner[i] = INT_MAX;
        }
        for (int i = t; i < B; i += kThreads) {
          int r = -1;
          if (i < npick) {
            b.exp[spos[i]] = 1;
            const int id = b.id[spos[i]];
            r = id < 0 ? 0 : id;
          }
          srow[i] = r;
        }
        __syncthreads();
        const bool invalid = expand_slots(
            graph, srow, m, C, log2_t, hkey, howner, slot,
            [&](int id) -> uint8_t {
              return (bits[id >> 5] >> (id & 31)) & 1u;
            });
        if (invalid) ms->invalid = 1;
        __syncthreads();
        // ---- the fresh slots (unvisited, the id's first slot) compacted
        // in slot order, rounds of kThreads slots, a ballot a warp: slot[c]
        // becomes the fresh id (-1: not fresh), the rounds' counts their
        // offsets, then each fresh id goes to the list and is marked
        // visited (the bitset, the row's byte), and slot[c] becomes its
        // index in the list (-1: not fresh)
#pragma unroll 4
        for (int u = 0; u < rounds; ++u) {
          const int c = u * kThreads + t;
          const int h = c < C ? slot[c] : -1;
          const bool fresh = h >= 0 && howner[h] == c;
          const unsigned got = __ballot_sync(kFull, fresh);
          if (lane == 0) round_count[u * kWarps + warp] = __popc(got);
          if (c < C) slot[c] = fresh ? hkey[h] : -1;
        }
        __syncthreads();
        if (warp == 0) {
          int carry = 0;
          for (int base = 0; base < rounds * kWarps; base += 32) {
            const int i = base + lane;
            const int v = i < rounds * kWarps ? round_count[i] : 0;
            int incl = v;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const int o = __shfl_up_sync(kFull, incl, off);
              if (lane >= off) incl += o;
            }
            if (i < rounds * kWarps) round_count[i] = carry + incl - v;
            carry += __shfl_sync(kFull, incl, 31);
          }
          if (lane == 0) ms->nfresh = carry;
        }
        __syncthreads();
#pragma unroll 4
        for (int u = 0; u < rounds; ++u) {
          const int c = u * kThreads + t;
          const int id = c < C ? slot[c] : -1;
          const unsigned got = __ballot_sync(kFull, id >= 0);
          int at = -1;
          if (id >= 0) {
            at = round_count[u * kWarps + warp]
                 + __popc(got & ((1u << lane) - 1u));
            fid[at] = id;
            fslot[at] = c;
            atomicOr(&bits[id >> 5], 1u << (id & 31));
            vis_row[id] = 1;
          }
          if (c < C) slot[c] = at;
        }
      } else if (t == 0) {
        ms->nfresh = 0;
        ms->invalid = 1;                           // every slot is empty
      }
      if (t == 0) {
        if (ms->invalid) vis_row[N] = 1;
        // few fresh ids: the leader scores them, and the rest, alone
        ms->park = helped && ms->nfresh <= kAloneRows;
      }
    }
    // the cluster's barriers while it helps; alone, the CTA's, and only
    // for fresh ids to score
    if (helped) {
      cluster.sync();                              // the fresh list is ready
      if (lms->park) {
        helped = false;
        if (!leader) break;                        // to the last barrier
      }
    } else if (npick > 0) {
      __syncthreads();
    }
    if (lms->done) break;

    // ---- score the fresh list over the helping warps: at least 8 rows a
    // warp (one round of loads), at most 32
    if (helped || npick > 0) {
      const int nf = lms->nfresh;
      const int warps = (helped ? ncta : 1) * kWarps;
      int per = (nf + warps - 1) / warps;
      per = min(32, max(8, (per + 7) & ~7));
      const int groups = (nf + per - 1) / per;
      for (int g = rank * kWarps + warp; g < groups; g += warps) {
        const int k = g * per + lane;
        const int n = min(per, nf - g * per);
        const int r = lane < n ? lfid[k] : -1;
        const float xv = (EPI == kEpiL2 && r >= 0) ? __ldg(xn + r) : 0.0f;
        const float dot = warp_dots<VEC>(qs, x, D, lane, r, n);
        if (lane < n) lfnd[k] = epilogue<EPI>(dot, qn, xv);
      }
    }
    if (helped) {
      cluster.sync();                              // the distances are in
    } else if (npick > 0) {
      __syncthreads();
    }

    if (leader) {
      // ---- merge (kernel 2's) into the other buffer
      Beam b(buf[cur], L);
      const long long pm = ms->p;
      if (t < I) {
        inj_id[t] = spare_v;
        inj_d[t] = spare_dv;
      }
      if (t == 0) {
        // the frontier fell behind the next spare, or the nbp counter
        // would trip with spares left; then the counters after this body
        const bool trigger = n_spare != nullptr && act && p < ns
                             && (best > spare_dv || nb + 1 >= nbp_limit);
        long long next = act ? (fw ? nb + 1 : 0) : nb;
        if (trigger) next = 0;                     // a re-seed resets it
        nb = next;
        if (trigger) p += inject;
        itv += 1;
        ms->trigger = trigger;
        ms->p_next = p;
        ms->count = 0;
      }
      __syncthreads();
      const bool trigger = ms->trigger != 0;
      const int nf = ms->nfresh;
      load_spares(ms->p_next);
      // spare i of the injection, from the prefetched entries
      auto spare = [&](int i, int* id, float* d) {
        const bool ok = trigger && pm + i < Ps;
        const int64_t v = ok ? inj_id[i] : -1;
        *id = static_cast<int>(v);
        *d = (ok && v >= 0) ? inj_d[i] : max_dist;
      };
      // no fresh id, no spare and a tail below max_dist: nothing to merge
      int F = 0;
      if (nf > 0 || trigger || ms->tail_past_max) {
        if (!ms->tail_past_max) {
          // the fresh slots and the spares: an empty slot's key (max_dist)
          // is past the beam's last
          merge_select(nf + I, L, b.key[L - 1],
                       [&](int j) -> float {
                         if (j < nf) return fnd[j];
                         int id;
                         float d;
                         spare(j - nf, &id, &d);
                         return d;
                       },
                       [&](int j) { return j < nf ? fslot[j] : C + j - nf; },
                       ckey, &ms->count);
        } else {
          merge_select(C + I, L, b.key[L - 1],
                       [&](int j) -> float {
                         if (j < C) {
                           const int at = nf > 0 ? slot[j] : -1;
                           return at >= 0 ? fnd[at] : max_dist;
                         }
                         int id;
                         float d;
                         spare(j - C, &id, &d);
                         return d;
                       },
                       [](int j) { return j; }, ckey, &ms->count);
        }
        __syncthreads();
        F = ms->count;
      }
      if (F > 0) {
        // a body with no candidate leaves the beam (and its flags) as it is
        const unsigned long long* sorted =
            sort_candidates(ckey, ckey + cand, F);
        Beam o(buf[cur ^ 1], L);
        merge_ranks(
            b.key, L, sorted, F,
            [&](int i, int pos) {
              o.key[pos] = sort_key(b.d[i], pos);
              o.d[pos] = b.d[i];
              o.id[pos] = b.id[i];
              o.exp[pos] = b.exp[i];
            },
            [&](unsigned long long key, int pos) {
              const int col = static_cast<int>(key & 0xffffffffu) - L;
              float d;
              int id;
              if (col < C) {
                const int at = nf > 0 ? slot[col] : -1;
                d = at >= 0 ? fnd[at] : max_dist;
                id = at >= 0 ? fid[at] : -1;
              } else {
                spare(col - C, &id, &d);
              }
              o.key[pos] = sort_key(d, pos);
              o.d[pos] = d;
              o.id[pos] = d < max_dist ? id : -1;
              o.exp[pos] = 0;
            });
        cur ^= 1;
      }
      stale = npick == 0 && F == 0;
      if (t == 0) ms->p = p;
    }
  }
  cluster.sync();                 // no CTA reads the leader's memory now

  if (leader) {
    // ---- the state after all `iters` bodies
    Beam b(buf[cur], L);
    __syncthreads();
    uint8_t* oexp = out_exp + static_cast<int64_t>(q) * (L + 1);
    for (int i = t; i < L; i += kThreads) {
      out_d[row + i] = b.d[i];
      out_ids[row + i] = b.id[i];
      oexp[i] = b.exp[i];
    }
    if (t == 0) {
      oexp[L] = 0;                                 // the dump column
      out_nb[q] = nb;
      out_ptr[q] = p;
      // the bodies a row that is not active skips count, and mark column N
      out_it[q] = itv + (iters - body);
      if (body < iters) vis_row[N] = 1;
    }
  }
}

int set_smem(const void* kernel, int bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int sptag_walk_pop_expand(
    const void* cand_ids, const void* cand_d, void* expanded, void* visited,
    const void* no_better, const void* ptr, const void* it,
    const void* t_limit, const void* n_spare, const void* graph,
    void* sel_ids, void* fresh_ids, void* ctl, int Q, int L, int B, int m,
    long long N, int k_eff, long long nbp_limit, float max_dist, int log2_t,
    void* scratch, long long row_bytes, int smem_bytes, void* stream) {
  const int rc = set_smem(reinterpret_cast<const void*>(
                              walk_pop_expand_kernel), smem_bytes);
  if (rc != 0) return rc;
  walk_pop_expand_kernel<<<Q, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cand_ids), static_cast<const float*>(cand_d),
      static_cast<uint8_t*>(expanded), static_cast<uint8_t*>(visited),
      static_cast<const int64_t*>(no_better),
      static_cast<const int64_t*>(ptr), static_cast<const int64_t*>(it),
      static_cast<const int64_t*>(t_limit),
      static_cast<const int64_t*>(n_spare),
      static_cast<const int32_t*>(graph), static_cast<int64_t*>(sel_ids),
      static_cast<int64_t*>(fresh_ids), static_cast<int32_t*>(ctl), L, B, m,
      N, k_eff, nbp_limit, max_dist, log2_t,
      static_cast<unsigned char*>(scratch), row_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sptag_walk_merge(
    const void* cand_ids, const void* cand_d, const void* expanded,
    const void* nd, const void* fresh_ids, const void* ctl,
    const void* no_better, const void* ptr, const void* it,
    const void* n_spare, const void* spare_ids, const void* spare_d,
    void* out_ids, void* out_d, void* out_exp, void* out_nb, void* out_ptr,
    void* out_it, int Q, int L, int C, int Ps, int inject,
    long long nbp_limit, float max_dist, void* scratch, long long row_bytes,
    int smem_bytes, void* stream) {
  const int rc = set_smem(reinterpret_cast<const void*>(walk_merge_kernel),
                          smem_bytes);
  if (rc != 0) return rc;
  int cap = kRun;                    // the compacted candidates' room
  while (cap < C + inject) cap <<= 1;
  walk_merge_kernel<<<Q, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cand_ids), static_cast<const float*>(cand_d),
      static_cast<const uint8_t*>(expanded), static_cast<const float*>(nd),
      static_cast<const int64_t*>(fresh_ids),
      static_cast<const int32_t*>(ctl),
      static_cast<const int64_t*>(no_better),
      static_cast<const int64_t*>(ptr), static_cast<const int64_t*>(it),
      static_cast<const int64_t*>(n_spare),
      static_cast<const int64_t*>(spare_ids),
      static_cast<const float*>(spare_d), static_cast<int64_t*>(out_ids),
      static_cast<float*>(out_d), static_cast<uint8_t*>(out_exp),
      static_cast<int64_t*>(out_nb), static_cast<int64_t*>(out_ptr),
      static_cast<int64_t*>(out_it), L, C, Ps, inject, cap, nbp_limit,
      max_dist, static_cast<unsigned char*>(scratch), row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// kernel 3's shared memory in bytes (the wrapper's resident_smem must
// agree)
extern "C" long long sptag_walk_resident_smem(int L, int B, int m,
                                              int inject, long long N, int D,
                                              int log2_t) {
  return resident_layout(L, B, m, inject, N, D, log2_t).total;
}

// All `iters` bodies of Q rows, one cluster of `cluster` CTAs a row;
// epi 0 (L2, x_sqnorm read) or 1 (cosine).  -2: an epilogue it does not
// take.
extern "C" int sptag_walk_resident(
    const void* cand_ids, const void* cand_d, const void* expanded,
    void* visited, const void* no_better, const void* ptr, const void* it,
    const void* t_limit, const void* n_spare, const void* spare_ids,
    const void* spare_d, const void* graph, const void* queries,
    const void* x, const void* xn, void* out_ids, void* out_d,
    void* out_exp, void* out_nb, void* out_ptr, void* out_it, int Q, int L,
    int B, int m, long long N, int D, int k_eff, long long nbp_limit, int Ps,
    int inject, int iters, int epi, float max_dist, int log2_t, int cluster,
    int smem_bytes, void* stream) {
  using Kernel = void (*)(
      const int64_t*, const float*, const uint8_t*, uint8_t*, const int64_t*,
      const int64_t*, const int64_t*, const int64_t*, const int64_t*,
      const int64_t*, const float*, const int32_t*, const float*,
      const float*, const float*, int64_t*, float*, uint8_t*, int64_t*,
      int64_t*, int64_t*, int, int, int, long long, int, int, long long, int,
      int, int, float, int);
  const bool vec = D % 4 == 0 && aligned16(x);
  Kernel kernel;
  if (epi == kEpiL2) {
    kernel = vec ? walk_resident_kernel<kEpiL2, true>
                 : walk_resident_kernel<kEpiL2, false>;
  } else if (epi == kEpiCosine) {
    kernel = vec ? walk_resident_kernel<kEpiCosine, true>
                 : walk_resident_kernel<kEpiCosine, false>;
  } else {
    return -2;
  }
  const int rc = set_smem(reinterpret_cast<const void*>(kernel), smem_bytes);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(Q) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int64_t*>(cand_ids),
      static_cast<const float*>(cand_d),
      static_cast<const uint8_t*>(expanded), static_cast<uint8_t*>(visited),
      static_cast<const int64_t*>(no_better),
      static_cast<const int64_t*>(ptr), static_cast<const int64_t*>(it),
      static_cast<const int64_t*>(t_limit),
      static_cast<const int64_t*>(n_spare),
      static_cast<const int64_t*>(spare_ids),
      static_cast<const float*>(spare_d), static_cast<const int32_t*>(graph),
      static_cast<const float*>(queries), static_cast<const float*>(x),
      static_cast<const float*>(xn), static_cast<int64_t*>(out_ids),
      static_cast<float*>(out_d), static_cast<uint8_t*>(out_exp),
      static_cast<int64_t*>(out_nb), static_cast<int64_t*>(out_ptr),
      static_cast<int64_t*>(out_it), L, B, m, N, D, k_eff, nbp_limit, Ps,
      inject, iters, max_dist, log2_t);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
