// The cascade's int8 tier over a shortlist (sptag_tpu_torch/ops/int8_dots.py),
// hand-written for Hopper (sm_90a).
//
// For each query q and shortlist slot c, with row r = ids[q, c] of the int8
// source (GATHER), or r = q * C + c (ROWS: rows already fetched in output
// order, ids only mask):
//   idot = sum_d qq[q, d] * x[r, d]          exact s8 x s8 -> s32 (__dp4a)
//   isq  = sum_d x[r, d]^2                   exact
//   dot  = (qs[q] * scale) * float(idot)
//   out  = max((qn[q] + float(isq) * scale2) - 2 dot, 0)   L2
//        = base2 - dot                                     cosine
// and max_dist where the id is < 0 or the row is tombstoned.  That is
// sptag_tpu/ops/cascade.py:192 `_int8_gathered_scores` with the mask and
// sentinel of :217 `_shortlist_int8_from` (GATHER) and :331
// `_int8_rerank_kernel` (ROWS), which the JAX package computes in XLA by
// materialising the (Q, C, D) gather as int32.  Integer sums are exact in
// any order and every float step is one IEEE operation written with the _rn
// intrinsics (no FMA contraction), so the kernel equals the plain version
// bit for bit.
//
// Bound on the H100: bytes.  At the FLAT cascade headline (Q = 1,024, C =
// b1 = 8,192, D = 128) the gathered rows are Q * C * D = 1.07 GB of int8
// when every slot is distinct; the output is 34 MB.  Design: the gather is
// fused — no (Q, C, D) tensor exists.  A CTA of 256 threads serves 256
// slots of one query; the query's int8 row sits in shared memory and each
// thread streams its slot's row with 16-byte loads (a 128-byte row is one
// line), 8 __dp4a a load (the dot and the row's squared norm).  Unaligned
// rows or D % 16 != 0 take byte loads.
//
// Plain C interface (ctypes): launches on the caller's stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGather = 0, kRows = 1;
constexpr int kEpiL2 = 0, kEpiCosine = 1;
constexpr int kMaxD = 48 * 1024;       // the query row in shared memory

template <int MODE, int EPI, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_gather_kernel(const int8_t* __restrict__ qq,
                   const float* __restrict__ qs,
                   const float* __restrict__ qn,
                   const int8_t* __restrict__ x,
                   const int* __restrict__ ids,
                   const uint8_t* __restrict__ invalid,
                   float* __restrict__ out, int C, int D, float scale,
                   float scale2, float base2, float max_dist) {
  extern __shared__ int4 q_smem[];
  int8_t* qrow = reinterpret_cast<int8_t*>(q_smem);
  const int q = blockIdx.y;
  const int dpad = (D + 15) / 16 * 16;
  for (int d = threadIdx.x; d < dpad; d += kThreads) {
    qrow[d] = d < D ? qq[(long long)q * D + d] : 0;
  }
  __syncthreads();
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long slot = (long long)q * C + c;
  const int id = ids[slot];
  long long r = MODE == kGather ? id : slot;
  const bool dead = id < 0 || (MODE == kGather && invalid != nullptr &&
                               invalid[id] != 0);
  if (dead) {
    out[slot] = max_dist;
    return;
  }
  const int8_t* row = x + r * D;
  int idot = 0, isq = 0;
  if (VEC) {
    const int4* rv = reinterpret_cast<const int4*>(row);
    const int4* qv = reinterpret_cast<const int4*>(qrow);
    for (int i = 0; i < D / 16; ++i) {
      const int4 a = __ldg(rv + i);
      const int4 b = qv[i];
      idot = __dp4a(a.x, b.x, idot);
      idot = __dp4a(a.y, b.y, idot);
      idot = __dp4a(a.z, b.z, idot);
      idot = __dp4a(a.w, b.w, idot);
      isq = __dp4a(a.x, a.x, isq);
      isq = __dp4a(a.y, a.y, isq);
      isq = __dp4a(a.z, a.z, isq);
      isq = __dp4a(a.w, a.w, isq);
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const int a = row[d];
      idot += a * (int)qrow[d];
      isq += a * a;
    }
  }
  const float dot = __fmul_rn(__fmul_rn(qs[q], scale), __int2float_rn(idot));
  float v;
  if (EPI == kEpiL2) {
    const float x2 = __fmul_rn(__int2float_rn(isq), scale2);
    v = fmaxf(__fsub_rn(__fadd_rn(qn[q], x2), __fmul_rn(2.0f, dot)), 0.0f);
  } else {
    v = __fsub_rn(base2, dot);
  }
  out[slot] = v;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// out (Q, C) float32.  qq (Q, D) int8, qs / qn (Q,) float32, x (rows, D)
// int8, ids (Q, C) int32, invalid (rows,) uint8 or null (GATHER only).
extern "C" int sptag_int8_gather_dots(const void* qq, const void* qs,
                                      const void* qn, const void* x,
                                      const void* ids, const void* invalid,
                                      void* out, int Q, int C, int D,
                                      int mode, int epi, float scale,
                                      float scale2, float base2,
                                      float max_dist, void* stream) {
  if (Q <= 0 || C <= 0) return 0;
  if (D <= 0 || D > kMaxD || Q > 65535) return -1;
  const dim3 grid((C + kThreads - 1) / kThreads, Q);
  const size_t smem = (size_t)(D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qq);
  const float* sc = static_cast<const float*>(qs);
  const float* nq = static_cast<const float*>(qn);
  const int8_t* xr = static_cast<const int8_t*>(x);
  const int* ix = static_cast<const int*>(ids);
  const uint8_t* inv = static_cast<const uint8_t*>(invalid);
  float* o = static_cast<float*>(out);
  const bool vec = D % 16 == 0 && aligned16(x);
#define SPTAG_I8(M, E)                                                      \
  if (vec) {                                                                \
    int8_gather_kernel<M, E, true><<<grid, kThreads, smem, s>>>(            \
        a, sc, nq, xr, ix, inv, o, C, D, scale, scale2, base2, max_dist);   \
  } else {                                                                  \
    int8_gather_kernel<M, E, false><<<grid, kThreads, smem, s>>>(           \
        a, sc, nq, xr, ix, inv, o, C, D, scale, scale2, base2, max_dist);   \
  }
  if (mode == kGather && epi == kEpiL2) {
    SPTAG_I8(kGather, kEpiL2)
  } else if (mode == kGather && epi == kEpiCosine) {
    SPTAG_I8(kGather, kEpiCosine)
  } else if (mode == kRows && epi == kEpiL2) {
    SPTAG_I8(kRows, kEpiL2)
  } else if (mode == kRows && epi == kEpiCosine) {
    SPTAG_I8(kRows, kEpiCosine)
  } else {
    return -2;
  }
#undef SPTAG_I8
  return (int)cudaGetLastError();
}
