// Fixed-order float32 dots of the graph walk (sptag_tpu_torch/algo/engine.py).
//
// The walk scores a query against pivots (seeding), against the neighbours
// it gathers each iteration, and against its final pool (the re-rank).  A
// library contraction picks its tiling, and with it the order of each
// dot's float32 sum, from the whole call's shape, so one query's distances
// change in the last bits with the batch it rides in, and a walk that pops
// nodes by those distances can take another path.  Here every output is
// one warp's sum in one order: lane l adds d = l, l + 32, ... with FMAs,
// then a fixed xor butterfly joins the lanes.  The bits depend on D and the
// two rows only, never on Q, C, the launch or the stream, so a query
// scores alike in a batch of 1 and of 1,024, eager or in a CUDA graph.
//
// out[r], r in [0, rows), C outputs per query (query r / C), against row
//   mode 0: x[idx[r]]       (the gathered neighbours, the re-rank pool)
//   mode 1: x[r]            (rows already laid out in output order)
//   mode 2: x[r % C]        (every row of x for every query: the pivots)
// q is (rows / C, D), x (.., D), both contiguous float32; idx int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // outputs (warps) per block

template <int MODE>
__global__ void __launch_bounds__(32 * kWarps)
walk_dots_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const int64_t* __restrict__ idx, float* __restrict__ out,
                 int64_t rows, int C, int D) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                    threadIdx.x / 32;
  if (r >= rows) return;                       // whole warps leave together
  const int lane = threadIdx.x & 31;
  int64_t xi;
  if (MODE == 0) {
    xi = idx[r];
  } else if (MODE == 1) {
    xi = r;
  } else {
    xi = r % C;
  }
  const float* qr = q + (r / C) * static_cast<int64_t>(D);
  const float* xr = x + xi * static_cast<int64_t>(D);
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(qr[d], xr[d], acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) out[r] = acc;
}

}  // namespace

extern "C" int sptag_walk_dots(const void* q, const void* x, const void* idx,
                               void* out, long long rows, int C, int D,
                               int mode, void* stream) {
  if (rows <= 0) return 0;
  if (C <= 0 || D <= 0) return -1;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return -1;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(32 * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  float* o = static_cast<float*>(out);
  switch (mode) {
    case 0:
      walk_dots_kernel<0><<<grid, block, 0, s>>>(qf, xf, ix, o, rows, C, D);
      break;
    case 1:
      walk_dots_kernel<1><<<grid, block, 0, s>>>(qf, xf, ix, o, rows, C, D);
      break;
    case 2:
      walk_dots_kernel<2><<<grid, block, 0, s>>>(qf, xf, ix, o, rows, C, D);
      break;
    default:
      return -2;
  }
  return static_cast<int>(cudaGetLastError());
}
