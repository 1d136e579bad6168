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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// probe_block_dots: one CTA per (query, probe) pair.  The query row sits in
// shared memory; each warp streams rows of the probed block with 16-byte
// loads, `lanes_per_row` lanes per row, and reduces with __shfl_xor_sync.
// ---------------------------------------------------------------------------

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using V = float4;
  using Acc = float;
  static constexpr int kElems = 4;
  static __device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
    return acc;
  }
};
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

__device__ __forceinline__ float mac1(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
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
// group_block_dots: one CTA per (group g, union slot j), a small GEMM
// (G, D) x (D, P).  Tiles of GT query rows and PT block rows, kKT 32-bit
// words deep, are staged in shared memory (row stride kKT + 1 words against
// bank conflicts); a (GT/2) x (256/(GT/2)) thread grid keeps a 2 x 4
// accumulator tile per thread in registers, so PT = 4 * 256/(GT/2).  GT is
// the smallest of 8, 16, 32 that holds the group, so small groups do not
// compute on padding rows.  A word is one float32, or four int8 packed for
// __dp4a.
// ---------------------------------------------------------------------------

constexpr int kKT = 32;

template <typename T> struct Word;
template <> struct Word<float> {
  using W = float;
  using Acc = float;
  static __host__ __device__ int per_row(int D) { return D; }
  static __device__ __forceinline__ float load(const float* row, int w, int,
                                               int) {
    return __ldg(row + w);
  }
  static __device__ __forceinline__ float mac(float a, float b, float acc) {
    return fmaf(a, b, acc);
  }
};
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

}  // namespace

extern "C" {

int sptag_probe_block_dots_f32(const void* blocks, const void* queries,
                               const void* topc, void* out, int C, int P,
                               int D, int Q, int nprobe, int vec,
                               void* stream) {
  return launch_probe<float>(blocks, queries, topc, out, C, P, D, Q, nprobe,
                             vec, stream);
}

int sptag_probe_block_dots_i8(const void* blocks, const void* queries,
                              const void* topc, void* out, int C, int P,
                              int D, int Q, int nprobe, int vec,
                              void* stream) {
  return launch_probe<int8_t>(blocks, queries, topc, out, C, P, D, Q, nprobe,
                              vec, stream);
}

int sptag_group_block_dots_f32(const void* blocks, const void* queries,
                               const void* uni, void* out, int C, int P,
                               int D, int NG, int U, int G, int vec,
                               void* stream) {
  return launch_group<float>(blocks, queries, uni, out, C, P, D, NG, U, G,
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
