// The exact walk body's glue (sptag_tpu_torch/algo/engine.py, _Walk): the
// pop, the neighbour expand with its visited test, the spare injection, the
// top-L merge and the counters, in two launches a body around the scoring
// launch of walk_dots.cu.
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
// prefix count picks them, no sort.  sel_d[0] (the pop's best distance) is
// the minimum of that score row under (value, position), a reduction.  The
// B x m neighbour ids are gathered and tested against the row's visited
// bytes, each thread issuing its next 8 slots' graph loads, then their
// visited loads, together (one serial chain of loads a slot measured half
// the kernel).  Unvisited ids go into a shared-memory hash table id ->
// lowest slot (atomicMin), so an id reached twice in one body stays fresh
// at its first slot in `flat` order only; after a barrier every valid id
// is marked visited (column N when a slot is -1) and the fresh ids are
// written for the scoring launch (-1 elsewhere).
//
// Kernel 2, walk_merge_kernel.  The stable sort of cat(cand_d, nd, inj_d)
// truncated at L, with its ids and expanded flags: each element's sort key
// is (order(distance), column), order() being torch.sort's (NaN last, -0
// equal to +0), so all keys differ.  Only candidates whose key is below
// the beam's last can land in the top L (their distances loaded 8 a
// thread at once); those are compacted (a few hundred at most after the
// first bodies, none once the walk has converged), bitonic-sorted in shared
// memory, and merged with the sorted beam by rank: a beam entry lands at
// its index plus the candidates below it, a candidate at its rank plus
// the beam entries below it (binary searches).  Equal distances keep the
// lower column, so the beam wins ties, as the stable sort does.  The spare
// trigger, the injected spares, no_better, ptr and it follow _merge.
//
// Each CTA's work area (the hash table and slots; the beam's and the
// candidates' keys) lives in shared memory, or, for a plan too wide for a
// CTA's 227 KB, in a device scratch of one area a row that the wrapper
// allocates: the same code through generic pointers, slower.
//
// State: cand_ids (Q, L) int64, cand_d (Q, L) float32, expanded (Q, L + 1)
// and visited (Q, N + 1) bool (bytes 0/1), no_better / ptr / it / t_limit /
// n_spare (Q,) int64, graph (N, m) int32, all contiguous.  Kernel 1 updates
// expanded and visited in place; kernel 2 writes a new state.  Neither
// allocates nor synchronises; both launch on the caller's stream, so CUDA
// graphs capture them.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kUnroll = 8;             // independent loads a thread issues

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
  const int lane = t & 31, warp = t >> 5;
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

  // ---- pop: count the eligible positions of this thread's stretch, and
  // the least (score, position) key of where(expanded, MAX, cand_d)
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
  int rank = incl - count;
  for (int w = 0; w < warp; ++w) rank += warp_count[w];
  for (int i = lo; i < hi && rank < B; ++i) {
    if (exp_row[i] == 0 && d_row[i] < max_dist) spos[rank++] = i;
  }
  if (t == 0) {
    int total = 0;
    unsigned long long top = kPadKey;
    for (int w = 0; w < kWarps; ++w) {
      total += warp_count[w];
      top = warp_best[w] < top ? warp_best[w] : top;
    }
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
  // kUnroll slots a thread at once: their graph loads, then their
  // visited loads, in flight together
  bool invalid = false;
  for (int base = t; base < C; base += kThreads * kUnroll) {
    int nid[kUnroll];
    uint8_t seen[kUnroll];
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
      seen[u] = nid[u] >= 0 ? vis_row[nid[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kThreads;
      if (c >= C) break;
      if (nid[u] < 0) {
        slot[c] = -1;
        invalid = true;
      } else if (seen[u]) {
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
  uint8_t* bexp = reinterpret_cast<uint8_t*>(ckey + cap);
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
    bool trigger = false;
    if (n_spare != nullptr) {
      // the frontier fell behind the next spare, or the nbp counter would
      // trip with spares left
      const float next_d = sd_row[p < Ps - 1 ? p : Ps - 1];
      const bool stalled = no_better[q] + 1 >= nbp_limit;
      trigger = active && p < n_spare[q]
                && (__int_as_float(c[1]) > next_d || stalled);
    }
    s_trigger = trigger;
  }
  for (int i = t; i < L; i += kThreads) {
    bkey[i] = sort_key(d_row[i], i);
    bids[i] = ids_row[i];
    bexp[i] = exp_row[i];
  }
  __syncthreads();

  // ---- the candidates that can enter the top L, compacted
  const bool trigger = s_trigger != 0;
  const unsigned long long last = sort_key(d_row[L - 1], L - 1);
  for (int base = t; base < C + I; base += kThreads * kUnroll) {
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      d[u] = j < C ? nd_row[j] : max_dist;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      if (j >= C + I) break;
      if (j >= C) {
        int64_t unused;
        injected(j - C, trigger, p, Ps, sid_row, sd_row, max_dist, &unused,
                 &d[u]);
      }
      const unsigned long long key = sort_key(d[u], L + j);
      if (key < last) ckey[atomicAdd(&s_count, 1)] = key;
    }
  }
  __syncthreads();
  const int F = s_count;
  int P = 1;
  while (P < F) P <<= 1;
  for (int i = F + t; i < P; i += kThreads) ckey[i] = kPadKey;
  __syncthreads();

  // ---- bitonic sort of the compacted keys (all distinct)
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int pair = t; pair < P / 2; pair += kThreads) {
        const int i = 2 * j * (pair / j) + (pair & (j - 1));
        const unsigned long long a = ckey[i], b = ckey[i + j];
        if ((a > b) == ((i & k) == 0)) {
          ckey[i] = b;
          ckey[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  // ---- merge by rank into the new top L
  const int64_t row = static_cast<int64_t>(q) * L;
  uint8_t* oexp = out_exp + static_cast<int64_t>(q) * (L + 1);
  for (int i = t; i < L; i += kThreads) {
    const int pos = i + rank_below(ckey, F, bkey[i]);
    if (pos < L) {
      const float d = d_row[i];
      out_d[row + pos] = d;
      out_ids[row + pos] = d < max_dist ? bids[i] : -1;
      oexp[pos] = bexp[i];
    }
  }
  for (int j = t; j < F; j += kThreads) {
    const unsigned long long key = ckey[j];
    const int pos = j + rank_below(bkey, L, key);
    if (pos < L) {
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
    }
  }
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

int set_smem(const void* kernel, int bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
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
  int cap = 1;                       // the compacted candidates' room
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
