// The walk's fixed-order float32 dot (walk_dots.cu's canonical warp order),
// shared by walk_dots.cu (the scoring kernels, the norms) and walk_body.cu
// (the resident walk's scoring), so every kernel gives a (query, row) pair
// the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sptag_walk_dots {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 128;            // d a warp covers a pass: 32 x float4
constexpr int kEpiL2 = 0, kEpiCosine = 1, kEpiDot = 2;

template <int EPI>
__device__ __forceinline__ float epilogue(float dot, float qn, float xn) {
  if (EPI == kEpiL2) {
    return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.0f, dot)), 0.0f);
  }
  if (EPI == kEpiCosine) return __fsub_rn(1.0f, dot);
  return dot;
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(kFull, acc, s);
  return acc;
}

// 4 consecutive d of a row from d0 (zeros past D or for a row not there);
// GLOBAL: the row is in device memory (read-only cache), else generic
template <bool VEC, bool GLOBAL>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int d0,
                                        int D, bool ok) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (VEC) {
    if (ok && d0 < D) {
      const float4* p = reinterpret_cast<const float4*>(row + d0);
      v = GLOBAL ? __ldg(p) : *p;
    }
  } else if (ok) {
    if (d0 + 0 < D) v.x = GLOBAL ? __ldg(row + d0 + 0) : row[d0 + 0];
    if (d0 + 1 < D) v.y = GLOBAL ? __ldg(row + d0 + 1) : row[d0 + 1];
    if (d0 + 2 < D) v.z = GLOBAL ? __ldg(row + d0 + 2) : row[d0 + 2];
    if (d0 + 3 < D) v.w = GLOBAL ? __ldg(row + d0 + 3) : row[d0 + 3];
  }
  return v;
}

// One step of the canonical order: a lane's products at d .. d + 3 (those
// below D) added to its partial with fmaf, in d order.
template <bool VEC>
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc, int d,
                                      int D) {
  if (VEC || d + 0 < D) acc = fmaf(a.x, b.x, acc);
  if (VEC || d + 1 < D) acc = fmaf(a.y, b.y, acc);
  if (VEC || d + 2 < D) acc = fmaf(a.z, b.z, acc);
  if (VEC || d + 3 < D) acc = fmaf(a.w, b.w, acc);
  return acc;
}

// Lane `lane`'s partials of R rows' squared norms in the canonical order,
// the R rows' loads in flight together (rows with ok false give 0).
template <bool VEC, bool GLOBAL, int R>
__device__ __forceinline__ void lane_sqnorms(const float* const (&rows)[R],
                                             const bool (&ok)[R], int D,
                                             int lane, float (&p)[R]) {
#pragma unroll
  for (int u = 0; u < R; ++u) p[u] = 0.0f;
  for (int d = 4 * lane; d < D; d += kChunk) {
    float4 v[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      v[u] = load4<VEC, GLOBAL>(rows[u], d, D, ok[u]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) p[u] = fma4<VEC>(v[u], v[u], p[u], d, D);
  }
}

// A row's squared norm in the canonical order; every lane gets the same
// bits.  With lane_sqnorms, the one norm function of every kernel here.
template <bool VEC, bool GLOBAL>
__device__ __forceinline__ float warp_sqnorm(const float* row, int D,
                                             int lane) {
  const float* const rows[1] = {row};
  const bool ok[1] = {true};
  float p[1];
  lane_sqnorms<VEC, GLOBAL, 1>(rows, ok, D, lane, p);
  return warp_sum(p[0]);
}

// Joins 32 lane partials of 2S slots into S: lane l keeps the slots whose
// bit log2(S) equals its own and adds its partner's (lane l ^ S) partial of
// them, the pair the per-dot butterfly adds at that stage.
template <int S>
__device__ __forceinline__ void fold(float (&p)[32], int lane) {
  const bool hi = (lane & S) != 0;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const float send = hi ? p[t] : p[t + S];
    const float keep = hi ? p[t + S] : p[t];
    p[t] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// The dots of the query `qs` (shared memory, zero padded to whole
// chunks) with up to 32 rows of x: lane k < n returns the dot of the row
// that lane k's `rk` names, in the canonical order (each lane's partials
// over its d by fmaf, then the 32 partials folded: the pairs and the tree
// of warp_sum).  Rows load 8 at a time; lanes k >= n load nothing.
template <bool VEC>
__device__ __forceinline__ float warp_dots(const float* qs,
                                           const float* __restrict__ x,
                                           int D, int lane, int rk, int n) {
  float part[32];
#pragma unroll
  for (int s = 0; s < 32; ++s) part[s] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int d = d0 + 4 * lane;
    const bool in = d < D;
    const float4 qv = *reinterpret_cast<const float4*>(qs + d);
#pragma unroll
    for (int s0 = 0; s0 < 32; s0 += 8) {
      if (s0 >= n) break;                           // whole warps
      float4 v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int rs = __shfl_sync(kFull, rk, s0 + t);
        const bool ok = s0 + t < n;
        v[t] = load4<VEC, true>(
            x + static_cast<int64_t>(ok ? rs : 0) * D, d, D, ok);
      }
      if (in) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          part[s0 + t] = fma4<VEC>(qv, v[t], part[s0 + t], d, D);
        }
      }
    }
  }
  fold<16>(part, lane);
  fold<8>(part, lane);
  fold<4>(part, lane);
  fold<2>(part, lane);
  fold<1>(part, lane);
  return part[0];
}

}  // namespace sptag_walk_dots
