// The cascade's int8 tier over a shortlist (sptag_tpu_torch/ops/int8_dots.py),
// hand-written for Hopper (sm_90a).
//
// For each query q and shortlist slot c, with row r = ids[q, c] of the int8
// source (GATHER), or r = q * C + c (ROWS: rows already fetched in output
// order, ids only mask):
//   idot = sum_d qq[q, d] * x[r, d]          exact s8 x s8 -> s32 (__dp4a)
//   isq  = sum_d x[r, d]^2                   exact
//   x2   = float(isq) * scale2
//   dot  = (qs[q] * scale) * float(idot)
//   out  = max((qn[q] + x2) - 2 dot, 0)      L2
//        = base2 - dot                       cosine
// and max_dist where the id is < 0 or the row is tombstoned.  That is
// sptag_tpu/ops/cascade.py:192 `_int8_gathered_scores` with the mask and
// sentinel of :217 `_shortlist_int8_from` (GATHER) and :331
// `_int8_rerank_kernel` (ROWS), which the JAX package computes in XLA by
// materialising the (Q, C, D) gather as int32.  Integer sums are exact in
// any order and every float step is one IEEE operation written with the _rn
// intrinsics (no FMA contraction), so the kernel equals the plain version
// bit for bit.
//
// Bound on the H100.  At the FLAT cascade headline (Q = 1,024, C = b1 =
// 8,192, D = 128) the slots name Q * C = 8.4 M rows, 1.07 GB of int8, but
// only the 200,000 distinct rows of the 25.6 MB corpus have to come from
// device memory: the rest are L2 hits, and L2 -> SM traffic, not device
// memory, bounds a gather.  Design: the gather is fused (no (Q, C, D)
// tensor).  A CTA of 8 warps serves one query's slots, 32 a warp at a time:
// the warp reads the 32 ids in one coalesced load, and 8 lanes share a row,
// lane p loading the 16 bytes d = 128 c + 16 p with one 16-byte load, so a
// warp load instruction brings 4 whole 128-byte lines and each 8-lane group
// keeps 8 rows' loads in flight.  4 __dp4a a load against the lane's own
// 16 query bytes (in registers); the 8 lanes' partials of 8 rows are
// joined transposing (7 shuffles).  The row's squared norm is 4 more
// __dp4a a load, which are free in a gather bound by L2 traffic: reading it
// from the corpus's norm table instead costs a 32-byte L2 sector for each
// 4-byte norm, and measured slower on the H100 (PERF.md).  Cache hints:
// the ids are read and the output written streaming (evict first), the
// corpus rows of GATHER mode with an L2 evict-last policy, so 67 MB of ids
// and output pass the 50 MB L2 without pushing the 25.6 MB corpus out.
// D % 16 != 0 or an unaligned row takes 4-byte or byte loads
// (int8_rows.cuh, shared with the int8 walk).
//
// Plain C interface (ctypes): launches on the caller's stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "int8_rows.cuh"

namespace {

using sptag_int8_rows::kKeep;
using sptag_int8_rows::kPlain;
using sptag_int8_rows::kStream;
using sptag_int8_rows::load16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// The tuned constants, each a macro that tools/cuda_kernel_sweep.py sets
// (-D) to time other values at the FLAT cascade's shape on the card:
// 32-slot passes a warp, CTAs an SM (at most 64 registers), and the L2
// hint of GATHER's rows (kKeep: evict last, kPlain: none).
#ifndef SPTAG_I8_PASSES
#define SPTAG_I8_PASSES 4
#endif
#ifndef SPTAG_I8_MIN_BLOCKS
#define SPTAG_I8_MIN_BLOCKS 4
#endif
#ifndef SPTAG_I8_ROW_HINT
#define SPTAG_I8_ROW_HINT kKeep
#endif
constexpr int kPasses = SPTAG_I8_PASSES;
constexpr int kMinBlocks = SPTAG_I8_MIN_BLOCKS;
constexpr int kRowHint = SPTAG_I8_ROW_HINT;
constexpr int kSlotsPerCta = kThreads * kPasses;
constexpr int kRows = 8;                // rows an 8-lane group a pass
constexpr int kChunk = 128;             // bytes 8 lanes cover a step
constexpr int kGather = 0, kRowsMode = 1;
constexpr int kEpiL2 = 0, kEpiCosine = 1;

__device__ __forceinline__ int dp4a4(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// Joins the 8 lanes of a group over 2S of its rows into S: lane p keeps
// the rows whose bit log2(S) equals its own and adds its partner's
// (lane p ^ S) sums of them.  After S = 4, 2, 1 lane p holds row p.
template <int S>
__device__ __forceinline__ void fold_rows(int (&a)[kRows], int lane) {
  const bool hi = (lane & S) != 0;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int send = hi ? a[t] : a[t + S];
    const int keep = hi ? a[t + S] : a[t];
    a[t] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

template <int MODE, int EPI, int LOAD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_gather_kernel(const int8_t* __restrict__ qq,
                   const float* __restrict__ qs,
                   const float* __restrict__ qn,
                   const int8_t* __restrict__ x,
                   const int* __restrict__ ids,
                   const uint8_t* __restrict__ invalid,
                   float* __restrict__ out, int C, int D, float scale,
                   float scale2, float base2, float max_dist) {
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 3;            // the lane's group of 8
  const int p = lane & 7;               // its place in the group
  constexpr bool kNorms = EPI == kEpiL2;   // isq: the L2 epilogue's
  uint64_t policy = 0;
  if (MODE == kGather) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  }
  const int8_t* qrow = qq + static_cast<int64_t>(q) * D;
  const float dscale = __fmul_rn(qs[q], scale);
  const float qnv = EPI == kEpiL2 ? qn[q] : 0.0f;
  const int64_t obase = static_cast<int64_t>(q) * C;
  // this lane's query bytes for the first step (D <= 128 needs no other)
  const int4 q0 = load16<kPlain, LOAD>(qrow, 16 * p, D, true, 0);

  for (int pass = 0; pass < kPasses; ++pass) {
    const int s0 = blockIdx.x * kSlotsPerCta + (pass * kWarps + warp) * 32;
    if (s0 >= C) break;                              // whole warps
    const int slot = s0 + lane;
    const int id = slot < C ? __ldcs(ids + obase + slot) : -1;
    const bool dead = id < 0 || (MODE == kGather && invalid != nullptr &&
                                 invalid[id] != 0);
    const int r = MODE == kGather ? id : static_cast<int>(obase + slot);
    const unsigned alive = __ballot_sync(kFull, !dead);
    // this group's rows: slots s0 + 4 t + grp
    int rows[kRows];
    bool ok[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      rows[t] = __shfl_sync(kFull, r, 4 * t + grp);
      ok[t] = (alive >> (4 * t + grp)) & 1u;
    }
    int acc[kRows], sq[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = sq[t] = 0;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      const int d = d0 + 16 * p;
      const int4 a = d0 == 0 ? q0
                             : load16<kPlain, LOAD>(qrow, d, D, true, 0);
      int4 v[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        v[t] = load16<MODE == kGather ? kRowHint : kStream, LOAD>(
            x + static_cast<int64_t>(ok[t] ? rows[t] : 0) * D, d, D, ok[t],
            policy);
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        acc[t] = dp4a4(v[t], a, acc[t]);
        if (kNorms) sq[t] = dp4a4(v[t], v[t], sq[t]);
      }
    }
    fold_rows<4>(acc, lane);
    fold_rows<2>(acc, lane);
    fold_rows<1>(acc, lane);
    if (kNorms) {
      fold_rows<4>(sq, lane);
      fold_rows<2>(sq, lane);
      fold_rows<1>(sq, lane);
    }
    // lane p of group grp holds slot s0 + 4 p + grp
    const int k = 4 * p + grp;
    if (s0 + k >= C) continue;
    float v;
    if (!((alive >> k) & 1u)) {
      v = max_dist;
    } else {
      const float dot = __fmul_rn(dscale, __int2float_rn(acc[0]));
      if (EPI == kEpiL2) {
        const float xn = __fmul_rn(__int2float_rn(sq[0]), scale2);
        v = fmaxf(__fsub_rn(__fadd_rn(qnv, xn), __fmul_rn(2.0f, dot)),
                  0.0f);
      } else {
        v = __fsub_rn(base2, dot);
      }
    }
    __stcs(out + obase + s0 + k, v);
  }
}

}  // namespace

// out (Q, C) float32.  qq (Q, D) int8, qs / qn (Q,) float32, x (rows, D)
// int8, ids (Q, C) int32, invalid (rows,) uint8 or null (GATHER only).
extern "C" int sptag_int8_gather_dots(const void* qq, const void* qs,
                                      const void* qn, const void* x,
                                      const void* ids, const void* invalid,
                                      void* out, int Q,
                                      int C, int D, int mode, int epi,
                                      float scale, float scale2, float base2,
                                      float max_dist, void* stream) {
  if (Q <= 0 || C <= 0) return 0;
  if (D <= 0 || Q > 65535) return -1;
  const dim3 grid((C + kSlotsPerCta - 1) / kSlotsPerCta, Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qq);
  const float* sc = static_cast<const float*>(qs);
  const float* nq = static_cast<const float*>(qn);
  const int8_t* xr = static_cast<const int8_t*>(x);
  const int* ix = static_cast<const int*>(ids);
  const uint8_t* inv = static_cast<const uint8_t*>(invalid);
  float* o = static_cast<float*>(out);
  // the query rows are loaded the same way
  const int load = std::min(sptag_int8_rows::load_width(x, D),
                            sptag_int8_rows::load_width(qq, D));
  if (mode != kGather && mode != kRowsMode) return -2;
  if (epi != kEpiL2 && epi != kEpiCosine) return -2;
#define SPTAG_I8(M, E, L)                                                   \
  int8_gather_kernel<M, E, L><<<grid, kThreads, 0, s>>>(                    \
      a, sc, nq, xr, ix, inv, o, C, D, scale, scale2, base2, max_dist)
#define SPTAG_I8_LOAD(M, E)                                                 \
  if (load == 16) { SPTAG_I8(M, E, 16); }                                   \
  else if (load == 4) { SPTAG_I8(M, E, 4); }                                \
  else { SPTAG_I8(M, E, 1); }
  if (mode == kGather && epi == kEpiL2) {
    SPTAG_I8_LOAD(kGather, kEpiL2)
  } else if (mode == kGather) {
    SPTAG_I8_LOAD(kGather, kEpiCosine)
  } else if (epi == kEpiL2) {
    SPTAG_I8_LOAD(kRowsMode, kEpiL2)
  } else {
    SPTAG_I8_LOAD(kRowsMode, kEpiCosine)
  }
#undef SPTAG_I8_LOAD
#undef SPTAG_I8
  return (int)cudaGetLastError();
}
