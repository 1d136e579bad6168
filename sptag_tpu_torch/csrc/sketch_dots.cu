// Hamming distances of the cascade's sketch tier and FLAT's SketchPrefilter
// (sptag_tpu_torch/ops/sketch_dots.py), hand-written for Hopper (sm_90a).
//
// out[q, n] = sum_w popc(qbits[q, w] ^ sketches[n, w]), or 1 << 30 where
// row n is invalid (a tombstone or a pad row).  The JAX package computes
// it in XLA (sptag_tpu/ops/cascade.py:151 `_hamming`, and the same loop in
// sptag_tpu/algo/flat.py:144 and :166); PyTorch has no popcount, so the
// plain version beside the wrapper counts bits with tensor ops.  The result
// is an exact integer: the kernel and the plain version agree bit for bit.
//
// Bound on the H100: bytes.  At the FLAT headline (Q = 1,024 queries a
// chunk, N = 200,064 rows, W = 4 words at D = 128) the output alone is
// Q * N * 4 = 819 MB, 0.245 ms at 3.35 TB/s; the sketches (3.2 MB) stay in
// L2 and the 3 * Q * N * W = 2.5 G integer operations take far less.
// Design: a CTA of 256 threads takes 256 consecutive rows and kQT queries;
// each thread keeps its row's W words in registers (W <= 8 unrolled, wider
// sketches read their words from L1 per query) and walks the CTA's queries,
// whose bits sit in shared memory (one broadcast load a word), so the
// output goes out as 1 KB of coalesced int32 per query and CTA.
//
// Plain C interface (ctypes): launches on the caller's stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // rows a CTA
constexpr int kQT = 32;                // queries a CTA
constexpr int kMaxRegW = 8;            // words a thread keeps in registers
constexpr int kInvalid = 1 << 30;

template <int W>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const int* __restrict__ qbits, const int* __restrict__ sk,
               const uint8_t* __restrict__ invalid, int* __restrict__ out,
               int Q, long long N, int Wd) {
  extern __shared__ int qs[];                     // kQT x Wd query words
  const int q0 = blockIdx.y * kQT;
  const int nq = min(kQT, Q - q0);
  for (int i = threadIdx.x; i < nq * Wd; i += kThreads) {
    qs[i] = qbits[(long long)q0 * Wd + i];
  }
  __syncthreads();
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const bool dead = invalid != nullptr && invalid[n] != 0;
  const int* row = sk + n * Wd;
  int* o = out + (long long)q0 * N + n;
  if constexpr (W > 0) {
    int x[W];
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = __ldg(row + w);
    for (int q = 0; q < nq; ++q) {
      int h = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) h += __popc(x[w] ^ qs[q * W + w]);
      o[(long long)q * N] = dead ? kInvalid : h;
    }
  } else {
    for (int q = 0; q < nq; ++q) {
      int h = 0;
      for (int w = 0; w < Wd; ++w) h += __popc(__ldg(row + w) ^ qs[q * Wd + w]);
      o[(long long)q * N] = dead ? kInvalid : h;
    }
  }
}

}  // namespace

// out (Q, N) int32; invalid (N,) uint8 (0 live, else dead) or null.
extern "C" int sptag_sketch_hamming(const void* qbits, const void* sketches,
                                    const void* invalid, void* out, int Q,
                                    long long N, int W, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (W <= 0) return -1;
  const long long bx = (N + kThreads - 1) / kThreads;
  const long long by = (Q + kQT - 1) / kQT;
  if (bx > 2147483647LL || by > 65535LL) return -1;
  const size_t smem = (size_t)kQT * W * sizeof(int);
  if (smem > 48 * 1024) return -1;
  const dim3 grid((unsigned)bx, (unsigned)by);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qb = static_cast<const int*>(qbits);
  const int* sk = static_cast<const int*>(sketches);
  const uint8_t* inv = static_cast<const uint8_t*>(invalid);
  int* o = static_cast<int*>(out);
#define SPTAG_HAM(WC) \
  hamming_kernel<WC><<<grid, kThreads, smem, s>>>(qb, sk, inv, o, Q, N, W)
  switch (W <= kMaxRegW ? W : 0) {
    case 1: SPTAG_HAM(1); break;
    case 2: SPTAG_HAM(2); break;
    case 3: SPTAG_HAM(3); break;
    case 4: SPTAG_HAM(4); break;
    case 5: SPTAG_HAM(5); break;
    case 6: SPTAG_HAM(6); break;
    case 7: SPTAG_HAM(7); break;
    case 8: SPTAG_HAM(8); break;
    default: SPTAG_HAM(0); break;
  }
#undef SPTAG_HAM
  return (int)cudaGetLastError();
}
