// 16-byte pieces of int8 rows, shared by walk_dots.cu (kernel 3) and
// int8_dots.cu: the loads of the kernels that give 8 lanes one row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sptag_int8_rows {

// How a 16-byte load is hinted: plainly, keeping the line in L2 (a corpus
// row that other queries read again), or streaming (read once).
constexpr int kPlain = 0, kKeep = 1, kStream = 2;

template <int HINT>
__device__ __forceinline__ int4 load_int4(const int4* p, uint64_t policy) {
  if (HINT == kStream) return __ldcs(p);
  if (HINT == kPlain) return __ldg(p);
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// The 16 bytes of an int8 row at d .. d + 15 (zeros past D, or for a row
// that is not there).  LOAD 16: one 16-byte load (D % 16 == 0, 16-byte
// aligned rows); 4: 4-byte words (D % 4 == 0, 4-byte aligned); 1: bytes.
// `policy` is read by the kKeep hint only.
template <int HINT, int LOAD>
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ row, int d,
                                       int D, bool ok, uint64_t policy) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!ok || d >= D) return v;
  if (LOAD == 16) {
    v = load_int4<HINT>(reinterpret_cast<const int4*>(row + d), policy);
  } else if (LOAD == 4) {
    const int* w = reinterpret_cast<const int*>(row + d);
    v.x = __ldg(w);
    if (d + 4 < D) v.y = __ldg(w + 1);
    if (d + 8 < D) v.z = __ldg(w + 2);
    if (d + 12 < D) v.w = __ldg(w + 3);
  } else {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (d + e < D) {
        w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                         __ldg(row + d + e))) << (8 * (e & 3));
      }
    }
    v = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                  static_cast<int>(w[2]), static_cast<int>(w[3]));
  }
  return v;
}

// The load width rows at `x` with D bytes each allow (see load16).
inline int load_width(const void* x, int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  return (D % 16 == 0 && (a & 15) == 0) ? 16
         : (D % 4 == 0 && (a & 3) == 0) ? 4 : 1;
}

}  // namespace sptag_int8_rows
