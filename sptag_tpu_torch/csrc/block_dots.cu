// Block-dot kernels of the dense tree-partition search, hand-written for
// Hopper (sm_90a).  The contract, the plain PyTorch versions, the bounds on
// the H100 and the design notes live beside the wrappers in
// sptag_tpu_torch/ops/block_dots.py.
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Layouts (all row-major, contiguous):
//   blocks  (C, P, D)   float32 or int8
//   queries (Q, D)      same type as blocks, or float32 against int8
//   topc    (Q, nprobe) int32 block ids        -> out (Q, nprobe, P)
//   uni     (NG, U)     int32 block ids        -> out (NG * U, G, P), Q = NG*G
//   out     float32 for float32 queries, exact int32 for int8 queries.
// A block id outside [0, C) scores as an all-zero block (no memory access).
//
// Both functions, both types, run block-major: entry e is output row e; it
// scores query row (e / G / U) * G + e % G against block ids[e / G] (the
// probe function is G = 1, U = nprobe).  One single-CTA prep kernel sorts
// the entries by block id (counting sort) and cuts each block's list into
// tiles of at most kNT entries; one CTA per tile streams its block through
// shared memory once and multiplies it with the tile's query rows: float32
// in FFMA, int8 on the tensor cores (mma.sync s8 x s8 -> s32, exact), and
// float32 queries against int8 blocks in FFMA on the raw int8 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The entry-list prep, shared by both types.
//
// Scratch (int32, 16-byte aligned, from the wrapper): [0] tile count,
// [4, 4 + 4*bound) the tile table as int4 (block, first entry, entry count,
// 0), then the E sorted entries, then C + 1 bucket counters (used when they
// do not fit in shared memory).  bound = min(E, ceil(E / kNT) + C) tiles: bucket C
// collects the entries whose block id lies outside [0, C), and C + 1
// buckets cut into tiles of at most kNT entries give at most
// ceil(E / kNT) + C tiles.
// ---------------------------------------------------------------------------

constexpr int kNT = 32;                  // entries per tile
constexpr int kPrepThreads = 1024;
constexpr int kPrepCache = 16;           // slot buckets kept per thread
constexpr int kPrepSmemMax = 46 * 1024;  // counters in shared memory

__device__ __forceinline__ int slot_bucket(const int* __restrict__ ids,
                                           int s, int C) {
  const int b = ids[s];
  return (b >= 0 && b < C) ? b : C;
}

// One CTA: histogram by block id, exclusive scans of the counts and of the
// tile counts, the tile table, then the scatter into sorted positions.  The
// work goes by id slot: slot s holds the G consecutive entries s * G ..
// s * G + G - 1 (G = 1 for the probe function), so one shared atomic counts
// or places all of them.  The order of slots inside a block's list is free
// (shared atomics).  Each thread keeps the buckets of its first kPrepCache
// slots in registers between the histogram and the scatter.
template <bool kSmem>
__global__ void __launch_bounds__(kPrepThreads)
block_major_prep_kernel(const int* __restrict__ ids, int E, int G, int C,
                        int* __restrict__ hdr, int4* __restrict__ tiles,
                        int* __restrict__ sorted,
                        int* __restrict__ counts_global) {
  extern __shared__ int counts_smem[];
  __shared__ int wsum[2][kPrepThreads / 32];
  // a scoring grid launched as this grid's programmatic dependent may start
  // now; it waits for this grid's results (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  int* cnt = kSmem ? counts_smem : counts_global;
  const int nb = C + 1;
  const int S = E / G;
  const int tid = threadIdx.x;
  for (int b = tid; b < nb; b += kPrepThreads) cnt[b] = 0;
  int bk[kPrepCache];
#pragma unroll
  for (int u = 0; u < kPrepCache; ++u) {
    const int s = u * kPrepThreads + tid;
    bk[u] = s < S ? slot_bucket(ids, s, C) : -1;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPrepCache; ++u)
    if (bk[u] >= 0) atomicAdd(cnt + bk[u], G);
  for (int s = kPrepCache * kPrepThreads + tid; s < S; s += kPrepThreads)
    atomicAdd(cnt + slot_bucket(ids, s, C), G);
  __syncthreads();

  // each thread owns a contiguous run of buckets
  const int chunk = (nb + kPrepThreads - 1) / kPrepThreads;
  const int lo = min(tid * chunk, nb);
  const int hi = min(lo + chunk, nb);
  int se = 0, st = 0;
  for (int b = lo; b < hi; ++b) {
    const int c = cnt[b];
    se += c;
    st += (c + kNT - 1) / kNT;
  }
  const int lane = tid & 31, warp = tid >> 5;
  int ie = se, it = st;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ye = __shfl_up_sync(0xffffffffu, ie, off);
    const int yt = __shfl_up_sync(0xffffffffu, it, off);
    if (lane >= off) {
      ie += ye;
      it += yt;
    }
  }
  if (lane == 31) {
    wsum[0][warp] = ie;
    wsum[1][warp] = it;
  }
  __syncthreads();
  if (warp == 0) {
    int ve = wsum[0][lane], vt = wsum[1][lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ye = __shfl_up_sync(0xffffffffu, ve, off);
      const int yt = __shfl_up_sync(0xffffffffu, vt, off);
      if (lane >= off) {
        ve += ye;
        vt += yt;
      }
    }
    wsum[0][lane] = ve;
    wsum[1][lane] = vt;
  }
  __syncthreads();
  int pe = (warp ? wsum[0][warp - 1] : 0) + ie - se;
  int pt = (warp ? wsum[1][warp - 1] : 0) + it - st;
  for (int b = lo; b < hi; ++b) {
    const int c = cnt[b];
    cnt[b] = pe;                             // becomes the scatter cursor
    for (int f = 0; f < c; f += kNT)
      tiles[pt++] = make_int4(b, pe + f, min(kNT, c - f), 0);
    pe += c;
  }
  if (tid == kPrepThreads - 1) hdr[0] = pt;  // the last run ends the table
  __syncthreads();

  // every bucket count, so every position, is a multiple of G: with G % 4
  // == 0 a slot's entries go out as aligned 16-byte stores
  auto place = [&](int s, int b) {
    int* dst = sorted + atomicAdd(cnt + b, G);
    const int e0 = s * G;
    if ((G & 3) == 0) {
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (int i = 0; i < G; i += 4)
        d4[i >> 2] = make_int4(e0 + i, e0 + i + 1, e0 + i + 2, e0 + i + 3);
    } else {
      for (int i = 0; i < G; ++i) dst[i] = e0 + i;
    }
  };
#pragma unroll
  for (int u = 0; u < kPrepCache; ++u)
    if (bk[u] >= 0) place(u * kPrepThreads + tid, bk[u]);
  for (int s = kPrepCache * kPrepThreads + tid; s < S; s += kPrepThreads)
    place(s, slot_bucket(ids, s, C));
}

// ---------------------------------------------------------------------------
// float32 scoring: one CTA per tile.  Thread t owns block row r0 + t of each
// kSR-row pass and every entry of the tile (n <= kNT dots in registers).
// Block rows and the tile's query rows stream through a kStages-deep
// cp.async ring in shared memory, kBK floats of K per stage (zero-padded
// past D).  Block rows keep their layout, kLD = kBK + 4 floats apart so the
// 16-byte loads of any 8 consecutive rows hit distinct banks; the queries
// are staged transposed (kLDQ floats per k), so one warp-wide broadcast
// 16-byte load gives four entries at one k.  The tile's entry count picks an
// unrolled, branch-free routine for ceil(n / 4) groups of 4 entries, so
// loads issue ahead of the FFMAs that use them.
//
// Summation order of each dot (float32 FFMA): `sliced` (probe) runs one
// chain per kBK-wide slice of K and adds the slices in ascending order;
// otherwise (group) one chain runs over all of D.  Those are the orders of
// the probe-major and group-major kernels this one replaces, and of the
// plain versions' CPU contractions (a batched matrix-vector product sums in
// SIMD partial sums, a matrix product in one chain), which an L2 distance
// |q|^2 + |x|^2 - 2 q.x — cancelling most of a dot's magnitude — shows.  At
// the end of a pass each entry's dots go out as coalesced 128-byte row
// pieces.
constexpr int kSR = 256;
constexpr int kBK = 16;
constexpr int kLD = kBK + 4;
constexpr int kLDQ = kNT + 4;
constexpr int kStages = 3;
// block rows per thread: the sliced order keeps two accumulators per dot
constexpr int kProbeRows = 1;
constexpr int kGroupRows = 2;
// steps of 4 along k unrolled in stage_dots: all of a stage for the probe
// kernel; two for the group kernel, whose fully unrolled stage (8 entry
// groups x 2 rows, ~1,200 instructions) ran slower from the instruction
// cache
constexpr int kProbeUnrollK = kBK / 4;
constexpr int kGroupUnrollK = 2;
constexpr int kStageFloats = kSR * kLD + kBK * kLDQ;
constexpr int kScoreSmem = kStages * kStageFloats * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage's dots: the thread's kRows block rows ra[j] (kBK floats each)
// against the transposed queries `qt` of entries 0 .. 4 * NG - 1, in
// ascending k; each broadcast query load feeds kRows x 4 FFMAs.  kUnrollK
// steps of 4 along k are unrolled per loop trip.
template <int NG, int kRows, int kUnrollK>
__device__ __forceinline__ void stage_dots(const float* const (&ra)[kRows],
                                           const float* qt,
                                           float (&part)[kRows][kNT]) {
  static_assert(kBK % (4 * kUnrollK) == 0, "whole loop trips per stage");
#pragma unroll 1
  for (int k0 = 0; k0 < kBK; k0 += 4 * kUnrollK)
#pragma unroll
  for (int k = k0; k < k0 + 4 * kUnrollK; k += 4) {
    float av[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(ra[j] + k);
      av[j][0] = a.x;
      av[j][1] = a.y;
      av[j][2] = a.z;
      av[j][3] = a.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 q =
            *reinterpret_cast<const float4*>(qt + (k + kk) * kLDQ + 4 * g);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          part[j][4 * g] = fmaf(av[j][kk], q.x, part[j][4 * g]);
          part[j][4 * g + 1] = fmaf(av[j][kk], q.y, part[j][4 * g + 1]);
          part[j][4 * g + 2] = fmaf(av[j][kk], q.z, part[j][4 * g + 2]);
          part[j][4 * g + 3] = fmaf(av[j][kk], q.w, part[j][4 * g + 3]);
        }
      }
    }
  }
}

// Stage kBK elements of K, from column k0, of block rows 0 .. rows - 1 into
// `dst` (kLD floats apart) through the cp.async ring, zeros past D.
template <int kT>
__device__ __forceinline__ void stage_block(float* dst, const float* src,
                                            int rows, int k0, int D, int vec,
                                            int tid) {
  if (vec) {
    constexpr int kV = kBK / 4;
    for (int c = tid; c < rows * kV; c += kT) {
      const int row = c / kV, col = (c % kV) * 4, d = k0 + col;
      const bool ok = d < D;
      cp_async16(dst + row * kLD + col,
                 ok ? src + (long long)row * D + d : src, ok);
    }
  } else {
    for (int c = tid; c < rows * kBK; c += kT) {
      const int row = c / kBK, col = c % kBK, d = k0 + col;
      const bool ok = d < D;
      cp_async4(dst + row * kLD + col,
                ok ? src + (long long)row * D + d : src, ok);
    }
  }
}

template <bool kSliced, int kRows>
__global__ void __launch_bounds__(kSR / kRows, 2)
block_major_f32_kernel(const float* __restrict__ blocks,
                       const float* __restrict__ queries,
                       const int* __restrict__ hdr,
                       const int4* __restrict__ tiles,
                       const int* __restrict__ sorted,
                       float* __restrict__ out, int C, int P, int D, int U,
                       int G, int vec) {
  static_assert(kNT == 32, "stage_dots dispatch covers 8 groups of 4");
  constexpr int kT = kSR / kRows;            // threads; row j: tid + j * kT
  constexpr int kUK = kSliced ? kProbeUnrollK : kGroupUnrollK;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  __shared__ long long s_qoff[kNT];          // query row, in floats
  __shared__ long long s_ooff[kNT];          // output row, in floats

  const int ntiles = hdr[0];
  const int4 tile = tiles[blockIdx.x];       // read beside the count
  if ((int)blockIdx.x >= ntiles) return;     // past the real tile count
  const int b = tile.x, first = tile.y, n = tile.z;
  const int tid = threadIdx.x;
  const bool live_block = b < C;             // else out-of-range ids: zeros
  const float* bbase = blocks + (long long)(live_block ? b : 0) * P * D;
  const int nk = max(1, (D + kBK - 1) / kBK);  // D = 0 stores zeros
  const int total = nk * ((P + kSR - 1) / kSR);
  const int ng = (n + 3) / 4;                // groups of 4 entries

  auto load_block = [&](int stage, int step) {
    const int r0 = (step / nk) * kSR, k0 = (step % nk) * kBK;
    // rows past P are left as they are: their dots are never stored
    const int rows = min(kSR, P - r0);
    stage_block<kT>(sm + stage * kStageFloats, bbase + (long long)r0 * D,
                    rows, k0, D, vec, tid);
  };
  auto load_queries = [&](int stage, int step) {
    // transposed: entry e, column k -> qt[k * kLDQ + e]; entries n .. 4*ng
    // are zero-filled, K past D too
    const int k0 = (step % nk) * kBK;
    float* qt = sm + stage * kStageFloats + kSR * kLD;
    for (int c = tid; c < 4 * ng * kBK; c += kT) {
      const int e = c / kBK, k = c % kBK, d = k0 + k;
      const bool ok = e < n && d < D;
      cp_async4(qt + k * kLDQ + e, ok ? queries + s_qoff[e] + d : queries,
                ok);
    }
  };

  // the block's first stages go out before the entry list is read
  if (live_block)
    for (int s = 0; s < kStages - 1 && s < total; ++s) load_block(s, s);
  if (tid < n) {
    const int e = sorted[first + tid];
    const int slot = e / G;
    s_qoff[tid] = ((long long)(slot / U) * G + (e - slot * G)) * D;
    s_ooff[tid] = (long long)e * P;
  }
  __syncthreads();
  if (!live_block) {
    for (int i = tid; i < n * P; i += kT)
      out[s_ooff[i / P] + i % P] = 0.f;
    return;
  }
  // group s holds stage s's queries (group 0 also the prologue's rows)
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_queries(s, s);
    cp_async_commit();
  }

  float acc[kRows][kNT], part[kRows][kNT];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int i = 0; i < kNT; ++i) acc[j][i] = 0.f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = step + kStages - 1;
    if (nxt < total) {
      load_block(nxt % kStages, nxt);
      load_queries(nxt % kStages, nxt);
    }
    cp_async_commit();

    const int r0 = (step / nk) * kSR;
    if (r0 + (tid & ~31) < P) {              // warp-uniform
      const float* st = sm + (step % kStages) * kStageFloats;
      const float* ra[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) ra[j] = st + (tid + j * kT) * kLD;
      const float* qt = st + kSR * kLD;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int i = 0; i < kNT; ++i) part[j][i] = kSliced ? 0.f : acc[j][i];
      switch (ng) {                          // uniform across the CTA
        case 1: stage_dots<1, kRows, kUK>(ra, qt, part); break;
        case 2: stage_dots<2, kRows, kUK>(ra, qt, part); break;
        case 3: stage_dots<3, kRows, kUK>(ra, qt, part); break;
        case 4: stage_dots<4, kRows, kUK>(ra, qt, part); break;
        case 5: stage_dots<5, kRows, kUK>(ra, qt, part); break;
        case 6: stage_dots<6, kRows, kUK>(ra, qt, part); break;
        case 7: stage_dots<7, kRows, kUK>(ra, qt, part); break;
        default: stage_dots<8, kRows, kUK>(ra, qt, part); break;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int i = 0; i < kNT; ++i)
          acc[j][i] = kSliced ? acc[j][i] + part[j][i] : part[j][i];
    }
    if (step % nk == nk - 1) {               // end of a pass
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + tid + j * kT;
        if (r < P) {
#pragma unroll
          for (int i = 0; i < kNT; ++i)
            if (i < n) out[s_ooff[i] + r] = acc[j][i];
        }
#pragma unroll
        for (int i = 0; i < kNT; ++i) acc[j][i] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 queries x int8 blocks: one CTA per tile.  The cascade's dense
// scan (sptag_tpu/algo/dense.py:321 probe, :433 group: the JAX package's
// XLA branch, which widens the gathered int8 blocks and contracts in
// float32).  Its result equals the float32 kernel's on blocks.float() bit
// for bit: every int8 value is an exact float32, and each dot runs the
// float32 kernel's FFMA order — `sliced` (probe) one chain per 16-wide slice
// of K from zero, the slices added in ascending order; otherwise (group) one
// chain over all of D.
//
// Staging.  The block's int8 rows go into a kF8Stages-deep cp.async ring as
// they are, kF8K bytes of K a stage (a quarter of the bytes of widened
// rows); at D = 128 the first kF8Stages - 1 stages hold all of K, so a pass
// waits once.  A row's 16-byte piece c sits at f8_pos(row, c), so the
// 16-byte loads of any 8 consecutive rows hit distinct banks with no
// padding.  The tile's query rows stage transposed (kF8LDQ floats per k) by
// 4-byte copies: one warp-wide broadcast 16-byte load gives 4 entries at one
// k.  Without 16-byte alignment or D % 16 == 0 (`vec` = 0) the rows are
// packed from byte loads into plain shared-memory stores, which the ring's
// barriers order like the copies.
//
// Scoring.  Lane l of a warp owns rows l, l + 32, ... (RT of them) of a
// 32 RT-row strip of the pass and the warp's ET entries (a warp whose entries
// all lie past the tile's count idles): 2 x 16, 256 threads, 2 CTAs an SM,
// both forms.  Per 16-wide slice a thread loads its rows' 16 bytes once and
// widens each byte just before its FFMAs (byte permute and one FADD, exact);
// per k it makes ET / 4 broadcast query loads for 4 RT FFMAs each.  The
// tile's entry count picks an unrolled, branch-free routine for its groups
// of 4 entries; a probe slice starts with products instead of FFMAs on
// zeros.  At the end of a pass each entry's dots go out as 128-byte lines
// (32 lanes, 32 consecutive rows).
//
// Bound on the H100 (phase 14's shapes, P = 256, D = 128, C = 894): the
// group call (NG 32, U 32, G 32) does 2.15 GFLOP, 32 us at the 67 TFLOP/s
// float32 FFMA rate, against at most 29 MB of int8 blocks and 33.5 MB of
// output (19 us at 3.35 TB/s): operations.  Each widened byte costs two
// instructions beside its ET FFMAs, so a thread issues about 80% FFMAs.
// The probe call (Q 1,024, nprobe 8) does 0.54 GFLOP (8 us) against 29 MB
// of blocks and 8.4 MB of output (11 us): bytes, with ~9 entries a tile.
// On the card the FFMAs run at about half the float32 rate and the block
// and output traffic does not hide behind them (PERF.md, section 6).
//
// The scoring grid is launched as a programmatic dependent of the prep
// (`SPTAG_F32I8_PDL`): its CTAs start while the prep runs and wait at
// griddepcontrol.wait for the tile table.
//
// Tuning constants are macros that tools/cuda_kernel_sweep.py sets (-D) to
// time other values on the card; these defaults are what the package builds.
// ---------------------------------------------------------------------------
#ifndef SPTAG_F32I8_K
#define SPTAG_F32I8_K 64              // bytes of K a stage (a power of two)
#endif
#ifndef SPTAG_F32I8_STAGES
#define SPTAG_F32I8_STAGES 2
#endif
#ifndef SPTAG_F32I8_ROWS
#define SPTAG_F32I8_ROWS 2            // block rows a thread
#endif
#ifndef SPTAG_F32I8_ENTRIES
#define SPTAG_F32I8_ENTRIES 16        // entries a warp
#endif
#ifndef SPTAG_F32I8_MIN_BLOCKS
#define SPTAG_F32I8_MIN_BLOCKS 2      // CTAs an SM (at most 128 registers)
#endif
#ifndef SPTAG_F32I8_UNROLL_W
#define SPTAG_F32I8_UNROLL_W 4        // 4-byte words of a slice unrolled
#endif
#ifndef SPTAG_F32I8_PDL
#define SPTAG_F32I8_PDL 1
#endif
// times each stage's FFMAs run: 1 in the package; the sweep's measuring
// variants set 0 (staging, waits and stores alone) or 2 (twice the FFMAs),
// whose dots are wrong by design
#ifndef SPTAG_F32I8_COMPUTE_REPS
#define SPTAG_F32I8_COMPUTE_REPS 1
#endif

constexpr int kF8K = SPTAG_F32I8_K;
constexpr int kF8Pieces = kF8K / 16;              // 16-byte pieces a row
constexpr int kF8Stages = SPTAG_F32I8_STAGES;
constexpr int kF8LDQ = kNT + 4;                   // staged query k-row
constexpr int kF8RowBytes = kSR * kF8K;
constexpr int kF8StageBytes = kF8RowBytes + kF8K * kF8LDQ * (int)sizeof(float);
constexpr int kF8Smem = kF8Stages * kF8StageBytes;
constexpr int kF8UnrollW = SPTAG_F32I8_UNROLL_W;
static_assert(kF8K >= 16 && (kF8Pieces & (kF8Pieces - 1)) == 0,
              "whole, power-of-two 16-byte pieces a staged row");
static_assert(kF8Stages >= 2, "a ring of at least two stages");

template <int RT, int ET>
struct F8Shape {
  static_assert(kSR % (32 * RT) == 0 && kNT % ET == 0 && ET % 4 == 0,
                "row strips tile the pass, entry groups tile the tile");
  static constexpr int kRW = kSR / (32 * RT);     // row strips
  static constexpr int kT = 32 * kRW * (kNT / ET);
};

// Position of row r's 16-byte piece c in its staged row: 8 consecutive rows
// reading one piece hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int f8_pos(int r, int c) {
  return c ^ (kF8Pieces >= 8 ? (r & 7) : ((r * kF8Pieces / 8) % kF8Pieces));
}

// Byte k of `flipped` (an int8 word with every sign bit flipped) as the
// float of the int8 value, exactly: the permute builds 2^23 + (x + 128)
// (walk_dots.cu's conversion, with the constant as the permute's register
// operand so that its selector is an immediate).
__device__ __forceinline__ float f8_widen(unsigned flipped, int k) {
  return __int_as_float(static_cast<int>(
             __byte_perm(0x4B000000u, flipped, 0x3104u + k))) -
         8388736.0f;                                  // 2^23 + 128
}

// One 16-wide slice of K: the thread's RT rows (`raw`, 16 bytes each)
// against entries 0 .. 4 NG - 1 of the transposed queries `q`, in ascending
// k, into `a`; with kFresh the slice's first k writes the products (a chain
// from zero: only the sign of a zero product can differ from an FFMA on
// +0, and the slice sums that follow make it +0).  Each byte is widened
// just before its FFMAs, so only the raw words stay live; `raw` is used up
// (its words rotate through .x).
template <int NG, int RT, int ET, bool kFresh>
__device__ __forceinline__ void f8_slice(int4 (&raw)[RT], const float* q,
                                         float (&a)[RT][ET]) {
  constexpr int kFlip = static_cast<int>(0x80808080u);
#pragma unroll
  for (int j = 0; j < RT; ++j)
    raw[j] = make_int4(raw[j].x ^ kFlip, raw[j].y ^ kFlip, raw[j].z ^ kFlip,
                       raw[j].w ^ kFlip);
#pragma unroll kF8UnrollW
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 qv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        qv[g] = *reinterpret_cast<const float4*>(
            q + (4 * w + kk) * kF8LDQ + 4 * g);
      const bool fresh = kFresh && w == 0 && kk == 0;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float x = f8_widen(static_cast<unsigned>(raw[j].x), kk);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float* d = &a[j][4 * g];
          d[0] = fresh ? __fmul_rn(x, qv[g].x) : fmaf(x, qv[g].x, d[0]);
          d[1] = fresh ? __fmul_rn(x, qv[g].y) : fmaf(x, qv[g].y, d[1]);
          d[2] = fresh ? __fmul_rn(x, qv[g].z) : fmaf(x, qv[g].z, d[2]);
          d[3] = fresh ? __fmul_rn(x, qv[g].w) : fmaf(x, qv[g].w, d[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j)
      raw[j] = make_int4(raw[j].y, raw[j].z, raw[j].w, raw[j].x);
  }
}

#define SPTAG_F8_CASE(N)                                       \
  case N:                                                      \
    if constexpr (N <= ET / 4) f8_slice<N, RT, ET, kFresh>(raw, q, a); \
    break;

// The slice for `ng` (1 .. ET / 4) groups of 4 entries, uniform per warp.
template <int RT, int ET, bool kFresh>
__device__ __forceinline__ void f8_slice_dispatch(int ng, int4 (&raw)[RT],
                                                  const float* q,
                                                  float (&a)[RT][ET]) {
  switch (ng) {
    SPTAG_F8_CASE(1)
    SPTAG_F8_CASE(2)
    SPTAG_F8_CASE(3)
    SPTAG_F8_CASE(4)
    SPTAG_F8_CASE(5)
    SPTAG_F8_CASE(6)
    SPTAG_F8_CASE(7)
    default: f8_slice<ET / 4, RT, ET, kFresh>(raw, q, a); break;
  }
}
#undef SPTAG_F8_CASE

template <bool kSliced, int RT, int ET, int kMinBlocks>
__global__ void __launch_bounds__(F8Shape<RT, ET>::kT, kMinBlocks)
block_major_f32i8_kernel(const int8_t* __restrict__ blocks,
                         const float* __restrict__ queries,
                         const int* __restrict__ hdr,
                         const int4* __restrict__ tiles,
                         const int* __restrict__ sorted,
                         float* __restrict__ out, int C, int P, int D, int U,
                         int G, int vec) {
  constexpr int kT = F8Shape<RT, ET>::kT;
  extern __shared__ int4 smem_f8[];
  int8_t* sm = reinterpret_cast<int8_t*>(smem_f8);
  __shared__ long long s_qoff[kNT];          // query row, in floats
  __shared__ long long s_ooff[kNT];          // output row, in floats

  // launched as a dependent of the prep: wait for its tile table
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int ntiles = hdr[0];
  const int4 tile = tiles[blockIdx.x];       // read beside the count
  if ((int)blockIdx.x >= ntiles) return;     // past the real tile count
  const int b = tile.x, first = tile.y, n = tile.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool live_block = b < C;             // else out-of-range ids: zeros
  const int8_t* bbase = blocks + (long long)(live_block ? b : 0) * P * D;
  const int nk = max(1, (D + kF8K - 1) / kF8K);  // D = 0 stores zeros
  const int total = nk * ((P + kSR - 1) / kSR);
  const int nq = 4 * ((n + 3) / 4);          // staged entries, zeros past n
  // the thread's first row of a pass, its warp's strip, its entries
  const int strip = (warp % F8Shape<RT, ET>::kRW) * 32 * RT;
  const int row0 = strip + lane;
  const int e0 = (warp / F8Shape<RT, ET>::kRW) * ET;
  const int nl = min(ET, n - e0);            // live entries (<= 0: idle)
  const int ng = nl > 0 ? (nl + 3) / 4 : 0;

  auto load_rows = [&](int step) {
    const int r0 = (step / nk) * kSR, k0 = (step % nk) * kF8K;
    int8_t* dst = sm + (step % kF8Stages) * kF8StageBytes;
    const int8_t* src = bbase + (long long)r0 * D;
    // rows past P are left as they are: their dots are never stored
    const int rows = min(kSR, P - r0);
    if (vec) {
      for (int c = tid; c < rows * kF8Pieces; c += kT) {
        const int r = c / kF8Pieces, piece = c % kF8Pieces;
        const int d = k0 + 16 * piece;
        const bool ok = d < D;
        cp_async16(dst + r * kF8K + 16 * f8_pos(r, piece),
                   ok ? src + (long long)r * D + d : src, ok);
      }
    } else {
      constexpr int kW = kF8K / 4;           // 4-byte words a staged row
      for (int c = tid; c < rows * kW; c += kT) {
        const int r = c / kW, w = c % kW, d = k0 + 4 * w;
        const int8_t* row = src + (long long)r * D;
        unsigned word = 0;
        for (int i = 0; i < 4 && d + i < D; ++i)
          word |= (unsigned)(uint8_t)row[d + i] << (8 * i);
        *reinterpret_cast<unsigned*>(dst + r * kF8K +
                                     16 * f8_pos(r, w >> 2) +
                                     4 * (w & 3)) = word;
      }
    }
  };
  auto load_queries = [&](int step) {
    // transposed: entry e, column k -> qt[k * kF8LDQ + e]
    const int k0 = (step % nk) * kF8K;
    float* qt = reinterpret_cast<float*>(
        sm + (step % kF8Stages) * kF8StageBytes + kF8RowBytes);
    for (int c = tid; c < nq * kF8K; c += kT) {
      const int e = c / kF8K, k = c % kF8K, d = k0 + k;
      const bool ok = e < n && d < D;
      cp_async4(qt + k * kF8LDQ + e, ok ? queries + s_qoff[e] + d : queries,
                ok);
    }
  };

  // the block's first stages go out before the entry list is read
  if (live_block)
    for (int s = 0; s < kF8Stages - 1 && s < total; ++s) load_rows(s);
  if (tid < n) {
    const int e = sorted[first + tid];
    const int slot = e / G;
    s_qoff[tid] = ((long long)(slot / U) * G + (e - slot * G)) * D;
    s_ooff[tid] = (long long)e * P;
  }
  __syncthreads();
  if (!live_block) {
    for (int i = tid; i < n * P; i += kT) out[s_ooff[i / P] + i % P] = 0.f;
    return;
  }
  // group s holds stage s's queries (group 0 also the prologue's rows)
  for (int s = 0; s < kF8Stages - 1; ++s) {
    if (s < total) load_queries(s);
    cp_async_commit();
  }

  float acc[RT][ET], part[RT][ET];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int i = 0; i < ET; ++i) acc[j][i] = 0.f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<kF8Stages - 2>();
    __syncthreads();
    const int nxt = step + kF8Stages - 1;
    if (nxt < total) {
      load_rows(nxt);
      load_queries(nxt);
    }
    cp_async_commit();

    const int r0 = (step / nk) * kSR, k0 = (step % nk) * kF8K;
    if (ng > 0 && r0 + strip < P) {          // warp-uniform
      const int8_t* st = sm + (step % kF8Stages) * kF8StageBytes;
      const float* qt =
          reinterpret_cast<const float*>(st + kF8RowBytes) + e0;
      // the stage's slices that hold some K < D
      const int ns = min(kF8Pieces, (D - k0 + 15) / 16);
#pragma unroll 1
      for (int c = 0; c < ns * SPTAG_F32I8_COMPUTE_REPS; ++c) {
        const int sl = SPTAG_F32I8_COMPUTE_REPS == 1 ? c : c % ns;
        int4 raw[RT];
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int r = row0 + 32 * j;
          raw[j] = *reinterpret_cast<const int4*>(st + r * kF8K +
                                                  16 * f8_pos(r, sl));
        }
        const float* q = qt + 16 * sl * kF8LDQ;
        if (kSliced) {
          f8_slice_dispatch<RT, ET, true>(ng, raw, q, part);
#pragma unroll
          for (int j = 0; j < RT; ++j)
#pragma unroll
            for (int i = 0; i < ET; ++i) acc[j][i] = acc[j][i] + part[j][i];
        } else {
          f8_slice_dispatch<RT, ET, false>(ng, raw, q, acc);
        }
      }
    }
    if (step % nk == nk - 1) {               // end of a pass
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int r = r0 + row0 + 32 * j;
        if (r < P) {
#pragma unroll
          for (int i = 0; i < ET; ++i)
            if (i < nl) out[s_ooff[e0 + i] + r] = acc[j][i];
        }
#pragma unroll
        for (int i = 0; i < ET; ++i) acc[j][i] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8 scoring: one CTA per tile, on the tensor cores.  Replaces
// sptag_tpu/ops/pallas_kernels.py:151 (probe_block_dots) and :214
// (group_block_dots) for int8, whose product runs on the TPU's s8 x s8 ->
// s32 matrix unit.
//
// A tile is an (M = n <= kNT entries) x (N = P block rows) x (K = D) int8
// product.  Warp w owns block rows 32w .. 32w + 31 of each kSR-row pass:
// two m16 x four n8 accumulator tiles, 32 s32 a thread, fed by
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 — A the entries' query rows, B the
// block rows, whose row-major (P, D) layout is the .col operand.  A tile of
// at most 16 entries computes one m16 tile.  Block rows and the tile's query
// rows stream through a kI8Stages-deep cp.async ring, kI8K bytes of K per
// stage, zero-filled past D; rows sit kI8LD = kI8K + 16 bytes apart, so the 8
// rows behind one 32-bit fragment load hit distinct banks.  Each CTA waits on
// a chain of dependent loads (tile, entry list, query rows, block rows) and
// does little else, so the ring's first kI8Stages - 1 stages, all of K at
// D = 128, go out at once: one wait per pass.  At the end of a pass the
// accumulators are staged through the ring as (entry, row) int32 and each
// entry's dots go out as whole 128-byte lines of 16-byte stores; the ring
// alone sets the shared memory, kI8MinBlocks CTAs a SM.  Without 16-byte
// alignment or D % 16 == 0 (`vec` = 0) the stages are filled with byte
// loads packed into 32-bit words.
//
// Exact: every product and partial sum is an integer of magnitude at most
// 128^2 * D < 2^31 for D < 2^17 (the wrapper checks D), so the s32 sums
// (plain, not .satfinite) equal the plain version's in any order.
//
// Bound on the H100: bytes.  At the main path's shapes (P = 256, D = 128,
// C = 252) the probe call moves at most 8.3 MB of distinct blocks and 8.4 MB
// of int32 output (16.8 MB, 5.0 us at 3.35 TB/s), the group call 8.3 MB and
// 33.5 MB (42 MB, 12.5 us).  Their 0.54 / 2.15 GOP take 0.3 / 1.1 us at the
// 1,979 TOP/s int8 tensor-core peak.  mma.sync and not wgmma: the product is
// far from the limit even at mma.sync's lower rate, and wgmma's 64-row
// tiles would compute mostly padding at M <= 32.
// ---------------------------------------------------------------------------
// 64 bytes of K a stage and 3 stages, 3 CTAs a SM (80 registers): of
// 32 / 64 / 128 bytes and 2 / 3 stages this ran the main path's grouped
// call fastest on the H100; 4 CTAs a SM spill at 64 registers and ran slower
constexpr int kI8K = 64;                            // bytes of K per stage
constexpr int kI8LD = kI8K + 16;                    // shared row stride
constexpr int kI8Stages = 3;
constexpr int kI8MinBlocks = 3;                     // CTAs a SM
constexpr int kI8StageBytes = (kSR + kNT) * kI8LD;  // block rows, query rows
constexpr int kI8Smem = kI8Stages * kI8StageBytes;
constexpr int kI8LDO = kSR + 8;                     // staged output row, int32
static_assert(kI8K % 32 == 0, "whole k32 steps per stage");
static_assert(kNT * kI8LDO * 4 <= kI8Smem, "the staged output fits the ring");

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// Stage kI8K bytes of K, from column k0, of `rows` rows into `dst` (kI8LD
// bytes apart).  Row r comes from row(r), or is zero where row(r) is null;
// K past D is zero.  `any` is a valid address for the zero-fill copies.
template <typename Row>
__device__ __forceinline__ void stage_i8(int8_t* dst, int rows, Row row,
                                         int k0, int D, int vec,
                                         const int8_t* any) {
  if (vec) {
    constexpr int kV = kI8K / 16;                   // 16-byte copies a row
    for (int c = threadIdx.x; c < kV * rows; c += kSR) {
      const int r = c / kV, col = (c % kV) * 16, d = k0 + col;
      const int8_t* src = row(r);
      const bool ok = src != nullptr && d < D;
      cp_async16(dst + r * kI8LD + col, ok ? src + d : any, ok);
    }
  } else {
    constexpr int kW = kI8K / 4;                    // 32-bit words a row
    for (int c = threadIdx.x; c < kW * rows; c += kSR) {
      const int r = c / kW, w = c % kW, d = k0 + 4 * w;
      const int8_t* src = row(r);
      unsigned word = 0;
      if (src != nullptr)
        for (int i = 0; i < 4 && d + i < D; ++i)
          word |= (unsigned)(uint8_t)src[d + i] << (8 * i);
      *reinterpret_cast<unsigned*>(dst + r * kI8LD + 4 * w) = word;
    }
  }
}

__global__ void __launch_bounds__(kSR, kI8MinBlocks)
block_major_i8_kernel(const int8_t* __restrict__ blocks,
                      const int8_t* __restrict__ queries,
                      const int* __restrict__ hdr,
                      const int4* __restrict__ tiles,
                      const int* __restrict__ sorted, int* __restrict__ out,
                      int C, int P, int D, int U, int G, int vec) {
  static_assert(kSR == 8 * 32 && kNT == 2 * 16,
                "8 warps of 32 block rows, two m16 tiles of entries");
  extern __shared__ int4 smem_i4[];
  int8_t* sm = reinterpret_cast<int8_t*>(smem_i4);
  __shared__ long long s_qoff[kNT];          // query row, in bytes
  __shared__ long long s_ooff[kNT];          // output row, in int32

  const int ntiles = hdr[0];
  const int4 tile = tiles[blockIdx.x];       // read beside the count
  if ((int)blockIdx.x >= ntiles) return;     // past the real tile count
  const int b = tile.x, first = tile.y, n = tile.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;     // fragment row, column group
  const bool live_block = b < C;             // else out-of-range ids: zeros
  const bool two = n > 16;                   // the second m16 tile
  const int8_t* bbase = blocks + (long long)(live_block ? b : 0) * P * D;
  const int nk = max(1, (D + kI8K - 1) / kI8K);  // D = 0 stores zeros

  auto load_block = [&](int r0, int k) {
    const int8_t* src = bbase + (long long)r0 * D;
    // rows past P are left as they are: their dots are never stored
    stage_i8(sm + (k % kI8Stages) * kI8StageBytes, min(kSR, P - r0),
             [&](int r) { return src + (long long)r * D; }, k * kI8K, D,
             vec, blocks);
  };
  auto load_queries = [&](int k) {
    // entries n .. 16 (or 32) are zero rows
    stage_i8(sm + (k % kI8Stages) * kI8StageBytes + kSR * kI8LD,
             two ? kNT : 16,
             [&](int e) -> const int8_t* {
               return e < n ? queries + s_qoff[e] : nullptr;
             },
             k * kI8K, D, vec, queries);
  };

  // the block's first stages go out before the entry list is read
  if (live_block)
    for (int k = 0; k < kI8Stages - 1 && k < nk; ++k) load_block(0, k);
  if (tid < n) {
    const int e = sorted[first + tid];
    const int slot = e / G;
    s_qoff[tid] = ((long long)(slot / U) * G + (e - slot * G)) * D;
    s_ooff[tid] = (long long)e * P;
  }
  __syncthreads();
  if (!live_block) {
    for (int i = tid; i < n * P; i += kSR) out[s_ooff[i / P] + i % P] = 0;
    return;
  }

  for (int r0 = 0; r0 < P; r0 += kSR) {
    // the pass's first stages: group k holds stage k (on the first pass
    // the block rows issued above all land in group 0)
    for (int k = 0; k < kI8Stages - 1; ++k) {
      if (r0 > 0 && k < nk) load_block(r0, k);
      if (k < nk) load_queries(k);
      cp_async_commit();
    }
    int acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;

    for (int k = 0; k < nk; ++k) {
      cp_async_wait<kI8Stages - 2>();
      __syncthreads();
      if (k + kI8Stages - 1 < nk) {
        load_block(r0, k + kI8Stages - 1);
        load_queries(k + kI8Stages - 1);
      }
      cp_async_commit();
      if (r0 + 32 * warp >= P) continue;     // warp-uniform
      const int8_t* st = sm + (k % kI8Stages) * kI8StageBytes;
      const int8_t* qa = st + (kSR + g) * kI8LD + 4 * t;
      const int8_t* ba = st + (32 * warp + g) * kI8LD + 4 * t;
#pragma unroll
      for (int kk = 0; kk < kI8K; kk += 32) {
        int a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m == 1 && !two) break;
          const int8_t* q = qa + 16 * m * kI8LD + kk;
          a[m][0] = lds32(q);
          a[m][1] = lds32(q + 8 * kI8LD);
          a[m][2] = lds32(q + 16);
          a[m][3] = lds32(q + 8 * kI8LD + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* bp = ba + 8 * j * kI8LD + kk;
          const int b0 = lds32(bp), b1 = lds32(bp + 16);
          mma_s8(acc[0][j], a[0], b0, b1);
          if (two) mma_s8(acc[1][j], a[1], b0, b1);
        }
      }
    }

    // The pass's dots, staged in the ring as (entry, row) int32: fragment
    // (m, j) holds entries 16m + g (c0, c1) and 16m + g + 8 (c2, c3) at
    // block rows 32w + 8j + 2t, + 1.  Then each entry's row goes out as
    // whole 128-byte lines.
    cp_async_wait<0>();
    __syncthreads();                         // the ring is read
    int* so = reinterpret_cast<int*>(sm);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int* o = so + (16 * m + g) * kI8LDO + 32 * warp + 8 * j + 2 * t;
        *reinterpret_cast<int2*>(o) = make_int2(acc[m][j][0], acc[m][j][1]);
        *reinterpret_cast<int2*>(o + 8 * kI8LDO) =
            make_int2(acc[m][j][2], acc[m][j][3]);
      }
    }
    __syncthreads();
    const int rows = min(kSR, P - r0);
    for (int e = warp; e < n; e += kSR / 32) {
      int* dst = out + s_ooff[e] + r0;
      const int* src = so + e * kI8LDO;
      if ((P & 3) == 0)                      // 16-byte aligned rows
        for (int c = 4 * lane; c < rows; c += 128)
          *reinterpret_cast<int4*>(dst + c) =
              *reinterpret_cast<const int4*>(src + c);
      else
        for (int c = lane; c < rows; c += 32) dst[c] = src[c];
    }
    __syncthreads();                         // before the next pass's loads
  }
}

long long tile_bound(int E, int C) {
  const long long b = (long long)(E + kNT - 1) / kNT + C;
  return b < E ? b : E;
}

struct Scratch {
  int* hdr;
  int4* tiles;
  int* sorted;
  int* counts;
};

Scratch carve(void* scratch, int E, int C) {
  int* s = static_cast<int*>(scratch);
  const long long bound = tile_bound(E, C);
  return {s, reinterpret_cast<int4*>(s + 4), s + 4 + 4 * bound,
          s + 4 + 4 * bound + E};
}

int launch_prep(const void* ids, const Scratch& sc, int E, int G, int C,
                cudaStream_t s) {
  const size_t need = (size_t)(C + 1) * sizeof(int);
  const int* id = static_cast<const int*>(ids);
  if (need <= (size_t)kPrepSmemMax)
    block_major_prep_kernel<true><<<1, kPrepThreads, need, s>>>(
        id, E, G, C, sc.hdr, sc.tiles, sc.sorted, sc.counts);
  else
    block_major_prep_kernel<false><<<1, kPrepThreads, 0, s>>>(
        id, E, G, C, sc.hdr, sc.tiles, sc.sorted, sc.counts);
  return (int)cudaGetLastError();
}

// Opt a scoring kernel into `smem` bytes of shared memory (above the 48 KB
// default) once per device; `done` holds that kernel's flags.
int configure_smem(const void* kernel, int smem, bool (&done)[64]) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0 || (dev < 64 && done[dev])) return rc;
  rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (rc == 0 && dev < 64) done[dev] = true;
  return rc;
}

template <bool kSliced, int kRows>
int launch_score(const void* blocks, const void* queries, const Scratch& sc,
                 void* out, int C, int P, int D, int E, int U, int G,
                 int vec, cudaStream_t s) {
  static bool done[64] = {};
  const int rc = configure_smem(
      (const void*)block_major_f32_kernel<kSliced, kRows>, kScoreSmem, done);
  if (rc != 0) return rc;
  block_major_f32_kernel<kSliced, kRows><<<(unsigned)tile_bound(E, C),
                                           kSR / kRows, kScoreSmem, s>>>(
      static_cast<const float*>(blocks), static_cast<const float*>(queries),
      sc.hdr, sc.tiles, sc.sorted, static_cast<float*>(out), C, P, D, U, G,
      vec);
  return (int)cudaGetLastError();
}

// The float32 x int8 scoring grid, a programmatic dependent of the prep
// launched just before it on `s` (unless SPTAG_F32I8_PDL is 0).
template <bool kSliced>
int launch_score_f32i8(const void* blocks, const void* queries,
                       const Scratch& sc, void* out, int C, int P, int D,
                       int E, int U, int G, int vec, cudaStream_t s) {
  constexpr int RT = SPTAG_F32I8_ROWS, ET = SPTAG_F32I8_ENTRIES;
  auto* kernel =
      block_major_f32i8_kernel<kSliced, RT, ET, SPTAG_F32I8_MIN_BLOCKS>;
  static bool done[64] = {};
  int rc = configure_smem((const void*)kernel, kF8Smem, done);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tile_bound(E, C));
  cfg.blockDim = dim3(F8Shape<RT, ET>::kT);
  cfg.dynamicSmemBytes = kF8Smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = SPTAG_F32I8_PDL ? 1 : 0;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel,
                               static_cast<const int8_t*>(blocks),
                               static_cast<const float*>(queries),
                               (const int*)sc.hdr, (const int4*)sc.tiles,
                               (const int*)sc.sorted, static_cast<float*>(out),
                               C, P, D, U, G, vec);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sptag_block_major_tile_entries(void) { return kNT; }

// The entry-list prep alone (the scoring entry points run it themselves):
// entries e < E with block ids[e / G], into `scratch` laid out as above.
int sptag_block_major_prep(const void* ids, void* scratch, int E, int G,
                           int C, void* stream) {
  return launch_prep(ids, carve(scratch, E, C), E, G, C,
                     static_cast<cudaStream_t>(stream));
}

// float32 probe_block_dots (G = 1, U = nprobe, E = Q * nprobe, sliced = 1)
// and group_block_dots (E = NG * U * G, sliced = 0): prep, then one CTA per
// tile.
int sptag_block_dots_f32(const void* blocks, const void* queries,
                         const void* ids, void* out, void* scratch, int C,
                         int P, int D, int E, int U, int G, int vec,
                         int sliced, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, E, C);
  const int rc = launch_prep(ids, sc, E, G, C, s);
  if (rc != 0) return rc;
  return sliced ? launch_score<true, kProbeRows>(blocks, queries, sc, out, C,
                                                 P, D, E, U, G, vec, s)
                : launch_score<false, kGroupRows>(blocks, queries, sc, out,
                                                  C, P, D, E, U, G, vec, s);
}

// The same with int8 blocks and float32 queries (the cascade's dense scan:
// queries q / scale against the quantized blocks), float32 out, equal to
// sptag_block_dots_f32 on the blocks widened; `vec` means 16-byte aligned
// int8 rows and queries with D % 16 == 0.
int sptag_block_dots_f32i8(const void* blocks, const void* queries,
                           const void* ids, void* out, void* scratch, int C,
                           int P, int D, int E, int U, int G, int vec,
                           int sliced, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, E, C);
  const int rc = launch_prep(ids, sc, E, G, C, s);
  if (rc != 0) return rc;
  return sliced ? launch_score_f32i8<true>(blocks, queries, sc, out, C, P, D,
                                           E, U, G, vec, s)
                : launch_score_f32i8<false>(blocks, queries, sc, out, C, P,
                                            D, E, U, G, vec, s);
}

// int8 probe_block_dots (G = 1, U = nprobe, E = Q * nprobe) and
// group_block_dots (E = NG * U * G), exact int32 out: prep, then one CTA per
// tile on the tensor cores.
int sptag_block_dots_i8(const void* blocks, const void* queries,
                        const void* ids, void* out, void* scratch, int C,
                        int P, int D, int E, int U, int G, int vec,
                        void* stream) {
  static bool done[64] = {};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc = carve(scratch, E, C);
  int rc = launch_prep(ids, sc, E, G, C, s);
  if (rc == 0)
    rc = configure_smem((const void*)block_major_i8_kernel, kI8Smem, done);
  if (rc != 0) return rc;
  block_major_i8_kernel<<<(unsigned)tile_bound(E, C), kSR, kI8Smem, s>>>(
      static_cast<const int8_t*>(blocks), static_cast<const int8_t*>(queries),
      sc.hdr, sc.tiles, sc.sorted, static_cast<int*>(out), C, P, D, U, G,
      vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
