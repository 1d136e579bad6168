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
//   queries (Q, D)      same type as blocks
//   topc    (Q, nprobe) int32 block ids        -> out (Q, nprobe, P)
//   uni     (NG, U)     int32 block ids        -> out (NG * U, G, P), Q = NG*G
//   out     float32 for float32 blocks, exact int32 for int8 blocks.
// A block id outside [0, C) scores as an all-zero block (no memory access).
//
// float32 runs block-major (both functions): entry e is output row e; it
// scores query row (e / G / U) * G + e % G against block ids[e / G] (the
// probe function is G = 1, U = nprobe).  One single-CTA prep kernel sorts
// the entries by block id (counting sort) and cuts each block's list into
// tiles of at most kNT entries; one CTA per tile streams its block through
// shared memory once and multiplies it with the tile's query rows in
// float32 FFMA.  int8 keeps the probe-major / group-major dp4a kernels
// below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// int8 probe_block_dots: one CTA per (query, probe) pair.  The query row
// sits in shared memory; each warp streams rows of the probed block with
// 16-byte loads, `lanes_per_row` lanes per row, and reduces with
// __shfl_xor_sync.
// ---------------------------------------------------------------------------

template <typename T> struct Vec16;
template <> struct Vec16<int8_t> {
  using V = int4;
  using Acc = int;
  static constexpr int kElems = 16;
  static __device__ __forceinline__ int dot(int4 a, int4 b, int acc) {
    acc = __dp4a(a.x, b.x, acc);
    acc = __dp4a(a.y, b.y, acc);
    acc = __dp4a(a.z, b.z, acc);
    acc = __dp4a(a.w, b.w, acc);
    return acc;
  }
};

__device__ __forceinline__ int mac1(int8_t a, int8_t b, int acc) {
  return acc + int(a) * int(b);
}

// D * sizeof(T) is a multiple of 16 and every pointer is 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_vec_kernel(const T* __restrict__ blocks, const T* __restrict__ queries,
                 const int* __restrict__ topc,
                 typename Vec16<T>::Acc* __restrict__ out,
                 int C, int P, int D, int nprobe, int lanes_per_row) {
  using V = typename Vec16<T>::V;
  using Acc = typename Vec16<T>::Acc;
  extern __shared__ int4 smem[];
  V* qs = reinterpret_cast<V*>(smem);

  const int nv = D / Vec16<T>::kElems;           // 16-byte vectors per row
  const long long pair = blockIdx.x;
  const long long q = pair / nprobe;
  const V* qrow = reinterpret_cast<const V*>(queries + q * D);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) qs[v] = qrow[v];
  __syncthreads();

  Acc* o = out + pair * P;
  const int b = topc[pair];
  if (b < 0 || b >= C) {
    for (int r = threadIdx.x; r < P; r += blockDim.x) o[r] = Acc(0);
    return;
  }
  const V* blk = reinterpret_cast<const V*>(blocks + (long long)b * P * D);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_warp = 32 / lanes_per_row;
  const int sub = lane / lanes_per_row;
  const int sl = lane % lanes_per_row;
  const int step = (blockDim.x >> 5) * rows_per_warp;
  // r0 is uniform across the warp, so every lane reaches the shuffles
  for (int r0 = warp * rows_per_warp; r0 < P; r0 += step) {
    const int r = r0 + sub;
    Acc acc = Acc(0);
    if (r < P) {
      const V* row = blk + (long long)r * nv;
      for (int v = sl; v < nv; v += lanes_per_row)
        acc = Vec16<T>::dot(__ldg(row + v), qs[v], acc);
    }
    for (int off = lanes_per_row >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < P && sl == 0) o[r] = acc;
  }
}

// Any D, any alignment: one warp per row, one element per lane per step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_scalar_kernel(const T* __restrict__ blocks,
                    const T* __restrict__ queries,
                    const int* __restrict__ topc,
                    typename Vec16<T>::Acc* __restrict__ out,
                    int C, int P, int D, int nprobe) {
  using Acc = typename Vec16<T>::Acc;
  extern __shared__ int4 smem[];
  T* qs = reinterpret_cast<T*>(smem);

  const long long pair = blockIdx.x;
  const long long q = pair / nprobe;
  for (int d = threadIdx.x; d < D; d += blockDim.x) qs[d] = queries[q * D + d];
  __syncthreads();

  Acc* o = out + pair * P;
  const int b = topc[pair];
  if (b < 0 || b >= C) {
    for (int r = threadIdx.x; r < P; r += blockDim.x) o[r] = Acc(0);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < P; r += nwarps) {
    const T* row = blocks + ((long long)b * P + r) * D;
    Acc acc = Acc(0);
    for (int d = lane; d < D; d += 32) acc = mac1(row[d], qs[d], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) o[r] = acc;
  }
}

template <typename T>
int launch_probe(const void* blocks, const void* queries, const void* topc,
                 void* out, int C, int P, int D, int Q, int nprobe, int vec,
                 void* stream) {
  using Acc = typename Vec16<T>::Acc;
  const long long pairs = (long long)Q * nprobe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const int nv = D / Vec16<T>::kElems;
    int lanes = 32;
    while (lanes > 1 && lanes > nv) lanes >>= 1;
    const size_t smem = (size_t)nv * 16;
    probe_vec_kernel<T><<<(unsigned)pairs, kThreads, smem, s>>>(
        static_cast<const T*>(blocks), static_cast<const T*>(queries),
        static_cast<const int*>(topc), static_cast<Acc*>(out), C, P, D,
        nprobe, lanes);
  } else {
    const size_t smem = ((size_t)D * sizeof(T) + 15) / 16 * 16;
    probe_scalar_kernel<T><<<(unsigned)pairs, kThreads, smem, s>>>(
        static_cast<const T*>(blocks), static_cast<const T*>(queries),
        static_cast<const int*>(topc), static_cast<Acc*>(out), C, P, D,
        nprobe);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 group_block_dots: one CTA per (group g, union slot j), a small GEMM
// (G, D) x (D, P).  Tiles of GT query rows and PT block rows, kKT 32-bit
// words deep, are staged in shared memory (row stride kKT + 1 words against
// bank conflicts); a (GT/2) x (256/(GT/2)) thread grid keeps a 2 x 4
// accumulator tile per thread in registers, so PT = 4 * 256/(GT/2).  GT is
// the smallest of 8, 16, 32 that holds the group, so small groups do not
// compute on padding rows.  A word is four int8 packed for __dp4a.
// ---------------------------------------------------------------------------

constexpr int kKT = 32;

template <typename T> struct Word;
template <> struct Word<int8_t> {
  using W = int;
  using Acc = int;
  static __host__ __device__ int per_row(int D) { return (D + 3) / 4; }
  // vec: D % 4 == 0 and 4-byte aligned rows; otherwise bytes past D are 0
  static __device__ __forceinline__ int load(const int8_t* row, int w, int D,
                                             int vec) {
    if (vec) return __ldg(reinterpret_cast<const int*>(row) + w);
    int packed = 0;
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * w + i;
      const int byte = d < D ? (int)(uint8_t)row[d] : 0;
      packed |= byte << (8 * i);
    }
    return packed;
  }
  static __device__ __forceinline__ int mac(int a, int b, int acc) {
    return __dp4a(a, b, acc);
  }
};

template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
group_kernel(const T* __restrict__ blocks, const T* __restrict__ queries,
             const int* __restrict__ uni, typename Word<T>::Acc* __restrict__ out,
             int C, int P, int D, int U, int G, int vec) {
  using W = typename Word<T>::W;
  using Acc = typename Word<T>::Acc;
  constexpr int TY = GT / 2;                 // thread rows, 2 queries each
  constexpr int TX = kThreads / TY;          // thread columns, 4 rows each
  constexpr int PT = 4 * TX;
  __shared__ W qs[GT][kKT + 1];
  __shared__ W bs[PT][kKT + 1];

  const long long slot = blockIdx.x;              // g * U + j
  const long long g = slot / U;
  const int b = uni[slot];
  const bool valid = b >= 0 && b < C;
  const int kw = Word<T>::per_row(D);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const T* qbase = queries + g * G * D;
  const T* bbase = blocks + (long long)(valid ? b : 0) * P * D;
  Acc* obase = out + slot * G * P;

  for (int g0 = 0; g0 < G; g0 += GT) {
    for (int r0 = 0; r0 < P; r0 += PT) {
      Acc acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

      for (int k0 = 0; k0 < kw; k0 += kKT) {
        __syncthreads();
        for (int i = threadIdx.x; i < GT * kKT; i += blockDim.x) {
          const int rr = i / kKT, ww = i % kKT;
          const int gq = g0 + rr, w = k0 + ww;
          qs[rr][ww] = (gq < G && w < kw)
                           ? Word<T>::load(qbase + (long long)gq * D, w, D, vec)
                           : W(0);
        }
        for (int i = threadIdx.x; i < PT * kKT; i += blockDim.x) {
          const int rr = i / kKT, ww = i % kKT;
          const int r = r0 + rr, w = k0 + ww;
          bs[rr][ww] = (valid && r < P && w < kw)
                           ? Word<T>::load(bbase + (long long)r * D, w, D, vec)
                           : W(0);
        }
        __syncthreads();
#pragma unroll 8
        for (int w = 0; w < kKT; ++w) {
          const W a0 = qs[ty][w];
          const W a1 = qs[ty + TY][w];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const W bv = bs[tx + TX * j][w];
            acc[0][j] = Word<T>::mac(a0, bv, acc[0][j]);
            acc[1][j] = Word<T>::mac(a1, bv, acc[1][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gq = g0 + ty + TY * i;
        if (gq >= G) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + tx + TX * j;
          if (r < P) obase[(long long)gq * P + r] = acc[i][j];
        }
      }
    }
  }
}

template <typename T>
int launch_group(const void* blocks, const void* queries, const void* uni,
                 void* out, int C, int P, int D, int NG, int U, int G, int vec,
                 void* stream) {
  using Acc = typename Word<T>::Acc;
  const unsigned slots = (unsigned)((long long)NG * U);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* bl = static_cast<const T*>(blocks);
  const T* qu = static_cast<const T*>(queries);
  const int* un = static_cast<const int*>(uni);
  Acc* o = static_cast<Acc*>(out);
  if (G <= 8)
    group_kernel<T, 8><<<slots, kThreads, 0, s>>>(bl, qu, un, o, C, P, D, U,
                                                   G, vec);
  else if (G <= 16)
    group_kernel<T, 16><<<slots, kThreads, 0, s>>>(bl, qu, un, o, C, P, D, U,
                                                    G, vec);
  else
    group_kernel<T, 32><<<slots, kThreads, 0, s>>>(bl, qu, un, o, C, P, D, U,
                                                    G, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32, block-major.
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

// Scoring: one CTA per tile.  Thread t owns block row r0 + t of each
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
    float* dst = sm + stage * kStageFloats;
    const float* src = bbase + (long long)r0 * D;
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

// Opt a scoring kernel into its shared memory (above the 48 KB default)
// once per device.
template <bool kSliced, int kRows>
int configure_score_kernel() {
  static bool done[64] = {};
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0 || (dev < 64 && done[dev])) return rc;
  rc = (int)cudaFuncSetAttribute(block_major_f32_kernel<kSliced, kRows>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kScoreSmem);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(
        block_major_f32_kernel<kSliced, kRows>,
        cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (rc == 0 && dev < 64) done[dev] = true;
  return rc;
}

template <bool kSliced, int kRows>
int launch_score(const void* blocks, const void* queries, const Scratch& sc,
                 void* out, int C, int P, int D, int E, int U, int G,
                 int vec, cudaStream_t s) {
  const int rc = configure_score_kernel<kSliced, kRows>();
  if (rc != 0) return rc;
  block_major_f32_kernel<kSliced, kRows><<<(unsigned)tile_bound(E, C),
                                           kSR / kRows, kScoreSmem, s>>>(
      static_cast<const float*>(blocks), static_cast<const float*>(queries),
      sc.hdr, sc.tiles, sc.sorted, static_cast<float*>(out), C, P, D, U, G,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sptag_block_major_tile_entries(void) { return kNT; }

// The entry-list prep alone (the f32 entry point runs it itself): entries
// e < E with block ids[e / G], into `scratch` laid out as above.
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

int sptag_probe_block_dots_i8(const void* blocks, const void* queries,
                              const void* topc, void* out, int C, int P,
                              int D, int Q, int nprobe, int vec,
                              void* stream) {
  return launch_probe<int8_t>(blocks, queries, topc, out, C, P, D, Q, nprobe,
                              vec, stream);
}

int sptag_group_block_dots_i8(const void* blocks, const void* queries,
                              const void* uni, void* out, int C, int P,
                              int D, int NG, int U, int G, int vec,
                              void* stream) {
  return launch_group<int8_t>(blocks, queries, uni, out, C, P, D, NG, U, G,
                              vec, stream);
}

}  // extern "C"
