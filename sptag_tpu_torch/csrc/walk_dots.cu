// Fixed-order float32 distances of the graph walk (sptag_tpu_torch/algo/engine.py).
//
// The walk scores a query against the pivots when it seeds, against the
// neighbours it gathers every iteration, and against its final pool (the
// re-rank).  A library contraction picks its tiling, and with it the order
// of each dot's float32 sum, from the whole call's shape, so one query's
// distances would change in the last bits with the batch it rides in, and a
// walk that pops nodes by those distances can take another path.  Here the
// order of every sum is fixed by D alone: an output's bits depend on D and
// its two rows, never on Q, C, P, the tile or CTA an output lands in, the
// launch or the stream, so a query scores alike in a batch of 1 and of
// 1,024, eager or replayed in a CUDA graph.  No split-K, no atomics, no
// tensor cores (TF32 is not float32).
//
// Both kernels fuse the walk's distance epilogue (ops/distance.py):
//   L2:     max((qn + xn) - 2 dot, 0), written with __fadd_rn / __fsub_rn /
//           __fmul_rn so that nvcc cannot contract it into an FMA: the fused
//           result equals the unfused formula over the same dot, bit for bit;
//   cosine: 1 - dot;
//   dot:    the bare dot (the tests hold the fused epilogues against it).
// A row's squared norm comes from one device function, `lane_sqnorms` (the
// canonical order below) and `warp_sum`, in both kernels (a query's qn) and
// in `walk_sqnorms_kernel` (the pivots' cached norms), so every kernel gives
// a row the same bits.  These, the fold and kernel 2's dot loop
// (`warp_dots`) live in walk_dots.cuh, which walk_body.cu's resident walk
// scores with too.
//
// The canonical warp order (scoring, norms): lane l of a warp owns
// d = 128 c + 4 l + j (chunk c = 0, 1, ..., j = 0..3) and sums its products
// with fmaf in that order; the fixed xor butterfly (16, 8, 4, 2, 1) joins
// the 32 lane partials.
//
// Kernel 1, walk_seed_kernel: SHARED mode, every pivot for every query, out
// (Q, P).  Stands in for the XLA contraction of pairwise_distance
// (sptag_tpu/ops/distance.py:232).  A dense (Q, P, D) product: 1,024 x 8,333
// x 128 is 2.2 GFLOP against 38 MB of rows and output, so it is bound by
// float32 FFMA issue (67 TFLOP/s), not by bytes; one warp a dot reused
// nothing and was bound by its load instructions.  Design: a CTA takes a
// 128 x 128 tile of queries x pivots with 256 threads, 8 x 8 outputs in
// registers a thread (16 FFMAs a shared-memory load); k-tiles of 8 d are
// staged through registers into double-buffered, transposed shared memory
// (one barrier a k-tile, the next tile's loads in flight during the FFMAs),
// and each output accumulates with fmaf in d = 0, 1, ..., D - 1 order and
// nothing else.  Zero-filled rows past Q and P feed only outputs that are
// not stored; a ragged last k-tile adds exact zeros.  The epilogue reads qn
// from shared memory (each warp computes 16 of the tile's query norms by
// the canonical order, 8 rows' loads in flight, while the first k-tile
// loads) and xn from the pivots' cached norms.
//
// Kernel 2, walk_score_kernel: GATHER and ROWS modes, out (Q, C): the
// walk's in-loop scoring (the hot kernel), KDT's seeds and the re-rank.
// Stands in for the XLA contraction of batched_gathered_distance
// (sptag_tpu/ops/distance.py:249).  Each output reads one 512-byte row
// (D 128), mostly an L2 hit, so it is bound by bytes: the rows moved from
// L2, and the query's row if it were re-read for every dot.  Most slots of
// a walk are not fresh (already visited, or duplicates) and read nothing.
// Design: one CTA of 8 warps serves one query row (or a slice of its C
// slots when Q is small); the query is read once into shared memory and
// each lane keeps its float4 of it.  A warp takes 32 slots at a time (slot
// groups g = w, w + 8, ...): it reads their 32 ids in one coalesced load
// (the next group's ids and this group's xn already in flight), compacts
// the live slots to the front with a ballot, issues their rows' float4
// loads eight at a time (one 16-byte load a lane a row), does 4 FMAs a lane
// a row in the canonical order, and joins the 32 x 32 lane partials with a
// transposing butterfly: 31 shuffles for 32 dots instead of 160, the same
// pairs added in the same tree as the per-dot butterfly, so the same bits.
// Lane k then holds the k-th live slot's dot and stores it; a slot whose
// id is < 0 loads nothing and writes max_dist.  xn is read by row id from
// the norm table inside the kernel (GATHER: the corpus's sqnorm; ROWS:
// norms in output order), qn from the query row by the canonical order.
// D % 4 != 0 or a row pointer that is not 16-byte aligned takes the
// template's scalar-load branch: the same order, 4-byte loads.
//
// Kernel 3, walk_score_i8_kernel: kernel 2's function over int8 rows (the
// cascade's in-loop scoring, algo/engine.py), each element dequantized as
// float(x) * scale in one float32 rounding, as the JAX package's
// `cvecs.astype(f32) * scale` (sptag_tpu/algo/engine.py:636).  Its output
// equals walk_score_f32 over the dequantized rows bit for bit (so a served
// cascade walk stays equal to search_batch's) at a quarter of their bytes.
// Kernel 2's lane layout would give each lane a 4-byte piece of every row,
// so a warp load instruction moved 128 bytes and the group's fixed work
// (ids, ballot, 32 partials, 31-shuffle fold) was paid for 128-byte rows;
// it was bound by instructions, at about 1 TB/s.  The canonical order says
// which LOGICAL lane owns a d, not which thread holds it, so here 8
// physical lanes share a row: lane p of an 8-lane group loads the 16 bytes
// d = 128 c + 16 p .. + 15 with one 16-byte load and holds logical lanes
// 4p .. 4p + 3 (4 partials), so one warp load brings 4 whole rows.  An
// 8-lane group scores 8 of the warp's 32 live slots (position 4 t + group),
// each element converted exactly by a byte permute into 2^23 + (x + 128)
// and one subtraction (full FP32 rate, where I2F runs at a quarter), then
// __fmul_rn(., scale) and fmaf in d order.  The logical butterfly stages
// 16, 8, 4 are physical lanes xor 4, 2, 1 inside the group, folded
// transposing over its 8 rows (28 shuffles for 32 dots); stages 2 and 1
// are two adds inside the thread over its 4 partials: the same pairs in
// the same tree, so the same bits.  xn comes from the norm table, qn from
// warp_sqnorm, the epilogue is kernel 2's.  D % 16 != 0 or a row pointer
// that is not 16-byte aligned takes 4-byte or byte loads in the same order.
//
// mode 0 (GATHER): row r of output (q, c) is x[idx[q * C + c]]
// mode 1 (ROWS):   row r is x[q * C + c] (rows already in output order);
//                  idx, when given, only masks (idx < 0: max_dist)
// q (Q, D), x (rows, D) and xn (rows,) are contiguous float32; idx int64.
// The kernels allocate nothing and never synchronise; they launch on the
// caller's stream, so CUDA graphs capture them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_rows.cuh"
#include "walk_dots.cuh"

using namespace sptag_walk_dots;

namespace {

constexpr int kGather = 0, kRows = 1;

// ---- kernel 1: seeding, every pivot for every query ----------------------

constexpr int kTileM = 128;            // queries a CTA
constexpr int kTileN = 128;            // pivots a CTA
constexpr int kTileK = 8;              // d a k-tile
constexpr int kSeedThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kTileStride = kTileM + 4;  // padded row of a transposed tile

template <int EPI, bool VEC>
__global__ void __launch_bounds__(kSeedThreads, 2)
walk_seed_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ xn, float* __restrict__ out,
                 int Q, int P, int D) {
  __shared__ __align__(16) float As[2][kTileK][kTileStride];
  __shared__ __align__(16) float Bs[2][kTileK][kTileStride];
  __shared__ float qn_s[kTileM];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kTileM;
  const int p0 = blockIdx.x * kTileN;

  // loader: thread -> row lr of both tiles, d lc .. lc + 3 of the k-tile
  const int lr = tid >> 1;
  const int lc = (tid & 1) * 4;
  const bool qok = q0 + lr < Q;
  const bool pok = p0 + lr < P;
  const float* qrow = q + static_cast<int64_t>(qok ? q0 + lr : 0) * D;
  const float* xrow = x + static_cast<int64_t>(pok ? p0 + lr : 0) * D;
  float4 ra = load4<VEC, true>(qrow, lc, D, qok);
  float4 rb = load4<VEC, true>(xrow, lc, D, pok);

  if (EPI == kEpiL2) {
    // the tile's query norms while the first k-tile loads: 16 rows a
    // warp, 8 rows' loads in flight together
    const int lane = tid & 31;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m0 = (tid >> 5) * 16 + h * 8;
      const float* rows[8];
      bool ok[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        ok[u] = q0 + m0 + u < Q;
        rows[u] = q + static_cast<int64_t>(ok[u] ? q0 + m0 + u : 0) * D;
      }
      float p[8];
      lane_sqnorms<VEC, true, 8>(rows, ok, D, lane, p);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float v = warp_sum(p[u]);
        if (lane == 0) qn_s[m0 + u] = v;
      }
    }
  }

  As[0][lc + 0][lr] = ra.x; As[0][lc + 1][lr] = ra.y;
  As[0][lc + 2][lr] = ra.z; As[0][lc + 3][lr] = ra.w;
  Bs[0][lc + 0][lr] = rb.x; Bs[0][lc + 1][lr] = rb.y;
  Bs[0][lc + 2][lr] = rb.z; Bs[0][lc + 3][lr] = rb.w;
  __syncthreads();

  // thread -> rows ty*4 + i and 64 + ty*4 + i, columns tx + 16 j
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int tiles = (D + kTileK - 1) / kTileK;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < tiles;
    if (more) {
      ra = load4<VEC, true>(qrow, (t + 1) * kTileK + lc, D, qok);
      rb = load4<VEC, true>(xrow, (t + 1) * kTileK + lc, D, pok);
    }
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[buf][k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) {
      const int nb = buf ^ 1;
      As[nb][lc + 0][lr] = ra.x; As[nb][lc + 1][lr] = ra.y;
      As[nb][lc + 2][lr] = ra.z; As[nb][lc + 3][lr] = ra.w;
      Bs[nb][lc + 0][lr] = rb.x; Bs[nb][lc + 1][lr] = rb.y;
      Bs[nb][lc + 2][lr] = rb.z; Bs[nb][lc + 3][lr] = rb.w;
    }
    __syncthreads();
  }

  float xnv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = p0 + tx + 16 * j;
    xnv[j] = (EPI == kEpiL2 && p < P) ? __ldg(xn + p) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (q0 + m >= Q) continue;
    const float qn = EPI == kEpiL2 ? qn_s[m] : 0.0f;
    float* orow = out + static_cast<int64_t>(q0 + m) * P + p0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (p0 + n < P) orow[n] = epilogue<EPI>(acc[i][j], qn, xnv[j]);
    }
  }
}

// ---- kernel 2: in-loop scoring, one CTA a query --------------------------

constexpr int kScoreWarps = 8;
// CTAs a scoring call aims for (8 an SM): a small batch splits each query's
// slots over several CTAs (slots are independent: no bit moves)
constexpr int kScoreCtas = 8 * 132;
constexpr int kScoreMinBlocks = 2;    // CTAs an SM: at most 128 registers

template <int MODE, int EPI, bool VEC>
__global__ void __launch_bounds__(32 * kScoreWarps, kScoreMinBlocks)
walk_score_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const int64_t* __restrict__ idx,
                  const float* __restrict__ xn, float* __restrict__ out,
                  int C, int D, int groups_per_cta, float max_dist) {
  extern __shared__ float4 q_smem[];    // the query, zero padded per chunk
  // a warp's live slots of its current group, in lane order
  __shared__ int live_slot[kScoreWarps][32];
  float* qs = reinterpret_cast<float*>(q_smem);
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dpad = (D + kChunk - 1) / kChunk * kChunk;
  const float* qr = q + static_cast<int64_t>(row) * D;
  for (int d = threadIdx.x; d < dpad; d += blockDim.x) {
    qs[d] = d < D ? qr[d] : 0.0f;
  }
  __syncthreads();
  const float qn = EPI == kEpiL2 ? warp_sqnorm<VEC, false>(qs, D, lane)
                                 : 0.0f;
  const int64_t base = static_cast<int64_t>(row) * C;

  // lane's slot c of group g -> its row of x (-1: masked or past C)
  auto row_of = [&](int g) -> int {
    const int c = g * 32 + lane;
    if (c >= C) return -1;
    if (MODE == kGather) {
      const int64_t id = idx[base + c];
      return id < 0 ? -1 : static_cast<int>(id);
    }
    return (idx == nullptr || idx[base + c] >= 0)
               ? static_cast<int>(base + c) : -1;
  };

  const int groups = (C + 31) / 32;
  const int g_begin = static_cast<int>(blockIdx.y) * groups_per_cta;
  const int g_end = min(groups, g_begin + groups_per_cta);
  int r_next = g_begin + warp < g_end ? row_of(g_begin + warp) : -1;
  for (int g = g_begin + warp; g < g_end; g += kScoreWarps) {
    const int c = g * 32 + lane;
    const int r = r_next;
    if (g + kScoreWarps < g_end) r_next = row_of(g + kScoreWarps);
    const float xv = (EPI == kEpiL2 && r >= 0) ? __ldg(xn + r) : 0.0f;
    // compact the live slots: the k-th live slot is scored at position k,
    // so a masked slot costs no load and no FMA
    const unsigned live = __ballot_sync(kFull, r >= 0);
    const int n = __popc(live);
    if (r >= 0) live_slot[warp][__popc(live & ((1u << lane) - 1u))] = lane;
    __syncwarp();
    const int src = lane < n ? live_slot[warp][lane] : lane;
    const int rk = __shfl_sync(kFull, r, src);        // position lane's row
    const float dot = warp_dots<VEC>(qs, x, D, lane, rk, n);
    // lane k < n holds the dot of live slot src; masked slots write
    // max_dist themselves
    const float xk = __shfl_sync(kFull, xv, src);
    if (lane < n) {
      out[base + g * 32 + src] = epilogue<EPI>(dot, qn, xk);
    }
    if (c < C && r < 0) out[base + c] = max_dist;
    __syncwarp();                     // live_slot is rewritten next group
  }
}

// ---- kernel 3: in-loop scoring over int8 rows ----------------------------

constexpr int kI8Rows = 8;        // rows an 8-lane group scores a pass
// CTAs an SM (at most 80 registers); a macro that
// tools/cuda_kernel_sweep.py sets (-D) to time other values on the card
#ifndef SPTAG_WALK_I8_MIN_BLOCKS
#define SPTAG_WALK_I8_MIN_BLOCKS 3
#endif
constexpr int kI8MinBlocks = SPTAG_WALK_I8_MIN_BLOCKS;

// Byte k of `flipped` (an int8 word with every sign bit flipped) as the
// float of the int8 value, exactly: the permute builds 2^23 + (x + 128).
__device__ __forceinline__ float i8_to_f32(unsigned flipped, int k) {
  return __int_as_float(static_cast<int>(
             __byte_perm(flipped, 0x4B000000u, 0x7440u | k))) -
         8388736.0f;                                  // 2^23 + 128
}

// Joins the 8 lanes of a group over 2S of its rows (4 partials each) into
// S: lane p keeps the rows whose bit log2(S) equals its own and adds its
// partner's (lane p ^ S) partials of them, the logical lanes' pairs.
template <int S>
__device__ __forceinline__ void fold_rows(float (&p)[kI8Rows][4], int lane) {
  const bool hi = (lane & S) != 0;
#pragma unroll
  for (int t = 0; t < S; ++t) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float send = hi ? p[t][m] : p[t + S][m];
      const float keep = hi ? p[t + S][m] : p[t][m];
      p[t][m] = keep + __shfl_xor_sync(kFull, send, S);
    }
  }
}

template <int MODE, int EPI, int LOAD>
__global__ void __launch_bounds__(32 * kScoreWarps, kI8MinBlocks)
walk_score_i8_kernel(const float* __restrict__ q,
                     const int8_t* __restrict__ x,
                     const int64_t* __restrict__ idx,
                     const float* __restrict__ xn, float* __restrict__ out,
                     int C, int D, int groups_per_cta, float max_dist,
                     float scale) {
  extern __shared__ float4 q_smem[];    // the query, zero padded per chunk
  __shared__ int live_slot[kScoreWarps][32];
  float* qs = reinterpret_cast<float*>(q_smem);
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 3;            // the lane's group of 8
  const int p = lane & 7;               // its place in the group
  const int dpad = (D + kChunk - 1) / kChunk * kChunk;
  const float* qr = q + static_cast<int64_t>(row) * D;
  for (int d = threadIdx.x; d < dpad; d += blockDim.x) {
    qs[d] = d < D ? qr[d] : 0.0f;
  }
  __syncthreads();
  // the canonical order with guarded loads: kernel 2's bits for any D
  const float qn = EPI == kEpiL2 ? warp_sqnorm<false, false>(qs, D, lane)
                                 : 0.0f;
  const int64_t base = static_cast<int64_t>(row) * C;

  auto row_of = [&](int g) -> int {
    const int c = g * 32 + lane;
    if (c >= C) return -1;
    if (MODE == kGather) {
      const int64_t id = idx[base + c];
      return id < 0 ? -1 : static_cast<int>(id);
    }
    return (idx == nullptr || idx[base + c] >= 0)
               ? static_cast<int>(base + c) : -1;
  };

  const int groups = (C + 31) / 32;
  const int g_begin = static_cast<int>(blockIdx.y) * groups_per_cta;
  const int g_end = min(groups, g_begin + groups_per_cta);
  int r_next = g_begin + warp < g_end ? row_of(g_begin + warp) : -1;
  for (int g = g_begin + warp; g < g_end; g += kScoreWarps) {
    const int c = g * 32 + lane;
    const int r = r_next;
    if (g + kScoreWarps < g_end) r_next = row_of(g + kScoreWarps);
    const float xv = (EPI == kEpiL2 && r >= 0) ? __ldg(xn + r) : 0.0f;
    const unsigned live = __ballot_sync(kFull, r >= 0);
    const int n = __popc(live);
    if (r >= 0) live_slot[warp][__popc(live & ((1u << lane) - 1u))] = lane;
    __syncwarp();
    const int src = lane < n ? live_slot[warp][lane] : lane;
    const int rk = __shfl_sync(kFull, r, src);        // position lane's row
    // this group's rows: live positions 4 t + grp
    int rows[kI8Rows];
#pragma unroll
    for (int t = 0; t < kI8Rows; ++t) {
      rows[t] = __shfl_sync(kFull, rk, 4 * t + grp);
    }
    float part[kI8Rows][4];
#pragma unroll
    for (int t = 0; t < kI8Rows; ++t) {
#pragma unroll
      for (int m = 0; m < 4; ++m) part[t][m] = 0.0f;
    }
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      const int d = d0 + 16 * p;
      const bool in = d < D;
      // elements of this lane's 16 below D (LOAD 16: all 16 when in)
      const int lim = LOAD == 16 ? 16 : D - d;
      int4 v[kI8Rows];
#pragma unroll
      for (int t = 0; t < kI8Rows; ++t) {
        const bool ok = 4 * t + grp < n;
        v[t] = sptag_int8_rows::load16<sptag_int8_rows::kPlain, LOAD>(
            x + static_cast<int64_t>(ok ? rows[t] : 0) * D, d, D, ok, 0);
      }
      if (in) {
        float qv[16];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 f = *reinterpret_cast<const float4*>(qs + d + 4 * m);
          qv[4 * m + 0] = f.x; qv[4 * m + 1] = f.y;
          qv[4 * m + 2] = f.z; qv[4 * m + 3] = f.w;
        }
#pragma unroll
        for (int t = 0; t < kI8Rows; ++t) {
          if (4 * t >= n) break;                      // whole warps
          const unsigned w[4] = {
              static_cast<unsigned>(v[t].x) ^ 0x80808080u,
              static_cast<unsigned>(v[t].y) ^ 0x80808080u,
              static_cast<unsigned>(v[t].z) ^ 0x80808080u,
              static_cast<unsigned>(v[t].w) ^ 0x80808080u};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (LOAD == 16 || 4 * m + j < lim) {
                const float xd = __fmul_rn(i8_to_f32(w[m], j), scale);
                part[t][m] = fmaf(qv[4 * m + j], xd, part[t][m]);
              }
            }
          }
        }
      }
    }
    // logical stages 16, 8, 4 across the group, then 2 and 1 in the thread
    fold_rows<4>(part, lane);
    fold_rows<2>(part, lane);
    fold_rows<1>(part, lane);
    const float dot = (part[0][0] + part[0][2]) + (part[0][1] + part[0][3]);
    // lane p of group grp holds live position 4 p + grp
    const int k = 4 * p + grp;
    const int ks = k < n ? live_slot[warp][k] : lane;
    const float xk = __shfl_sync(kFull, xv, ks);
    if (k < n) out[base + g * 32 + ks] = epilogue<EPI>(dot, qn, xk);
    if (c < C && r < 0) out[base + c] = max_dist;
    __syncwarp();                     // live_slot is rewritten next group
  }
}

// ---- the norm helper -----------------------------------------------------

constexpr int kNormWarps = 8;

template <bool VEC>
__global__ void __launch_bounds__(32 * kNormWarps)
walk_sqnorms_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int64_t N, int D) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kNormWarps +
                    (threadIdx.x >> 5);
  if (r >= N) return;                          // whole warps leave together
  const float v = warp_sqnorm<VEC, true>(x + r * D, D, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) out[r] = v;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

#define SPTAG_EPI_SWITCH(EPI_VAR, ...)          \
  switch (EPI_VAR) {                            \
    case kEpiL2: { constexpr int E = kEpiL2; __VA_ARGS__; } break;         \
    case kEpiCosine: { constexpr int E = kEpiCosine; __VA_ARGS__; } break; \
    case kEpiDot: { constexpr int E = kEpiDot; __VA_ARGS__; } break;       \
    default: return -2;                         \
  }

}  // namespace

// out (Q, P) = epilogue(q @ x.T); xn (P,) is read for L2 only.
extern "C" int sptag_walk_seed(const void* q, const void* x, const void* xn,
                               void* out, int Q, int P, int D, int epi,
                               void* stream) {
  if (Q <= 0 || P <= 0) return 0;
  if (D <= 0) return -1;
  const dim3 grid((P + kTileN - 1) / kTileN, (Q + kTileM - 1) / kTileM);
  if (grid.y > 65535u) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(xn);
  float* o = static_cast<float*>(out);
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(x);
  SPTAG_EPI_SWITCH(epi,
    if (vec) {
      walk_seed_kernel<E, true><<<grid, kSeedThreads, 0, s>>>(qf, xf, nf, o,
                                                              Q, P, D);
    } else {
      walk_seed_kernel<E, false><<<grid, kSeedThreads, 0, s>>>(qf, xf, nf, o,
                                                               Q, P, D);
    })
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The scoring kernels' grid: one row of CTAs a query, its 32-slot groups
// split over CTAs when Q is small.
struct ScoreGrid {
  dim3 grid;
  int per_cta;
  size_t smem;
};

int score_grid(int Q, int C, int D, ScoreGrid* g) {
  if (D <= 0) return -1;
  const int groups = (C + 31) / 32;
  const int splits = max(1, min((groups + kScoreWarps - 1) / kScoreWarps,
                                (kScoreCtas + Q - 1) / Q));
  g->per_cta = (groups + splits - 1) / splits;
  g->grid = dim3(Q, (groups + g->per_cta - 1) / g->per_cta);
  g->smem = static_cast<size_t>((D + kChunk - 1) / kChunk) * kChunk *
            sizeof(float);
  return g->smem > 48 * 1024 ? -1 : 0;
}

}  // namespace

// out (Q, C) = epilogue of each slot's dot, max_dist where the slot is
// masked.
extern "C" int sptag_walk_score(const void* q, const void* x, const void* idx,
                                const void* xn, void* out, int Q, int C,
                                int D, int mode, int epi, float max_dist,
                                void* stream) {
  if (Q <= 0 || C <= 0) return 0;
  ScoreGrid g;
  if (score_grid(Q, C, D, &g) != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const float* nf = static_cast<const float*>(xn);
  float* o = static_cast<float*>(out);
  const bool vec = D % 4 == 0 && aligned16(x);
  const dim3 block(32 * kScoreWarps);
#define SPTAG_SCORE(M)                                                      \
  SPTAG_EPI_SWITCH(epi,                                                     \
    if (vec) {                                                              \
      walk_score_kernel<M, E, true><<<g.grid, block, g.smem, s>>>(          \
          qf, xf, ix, nf, o, C, D, g.per_cta, max_dist);                    \
    } else {                                                                \
      walk_score_kernel<M, E, false><<<g.grid, block, g.smem, s>>>(         \
          qf, xf, ix, nf, o, C, D, g.per_cta, max_dist);                    \
    })
  switch (mode) {
    case kGather: SPTAG_SCORE(kGather) break;
    case kRows: SPTAG_SCORE(kRows) break;
    default: return -2;
  }
#undef SPTAG_SCORE
  return static_cast<int>(cudaGetLastError());
}

// walk_score_i8: the same over int8 rows x, each element dequantized as
// float(x) * scale (kernel 3).
extern "C" int sptag_walk_score_i8(const void* q, const void* x,
                                   const void* idx, const void* xn, void* out,
                                   int Q, int C, int D, int mode, int epi,
                                   float scale, float max_dist,
                                   void* stream) {
  if (Q <= 0 || C <= 0) return 0;
  ScoreGrid g;
  if (score_grid(Q, C, D, &g) != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int8_t* x8 = static_cast<const int8_t*>(x);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const float* nf = static_cast<const float*>(xn);
  float* o = static_cast<float*>(out);
  const int load = sptag_int8_rows::load_width(x, D);
  const dim3 block(32 * kScoreWarps);
#define SPTAG_SCORE_I8(M, L)                                                \
  SPTAG_EPI_SWITCH(epi,                                                     \
    walk_score_i8_kernel<M, E, L><<<g.grid, block, g.smem, s>>>(            \
        qf, x8, ix, nf, o, C, D, g.per_cta, max_dist, scale))
#define SPTAG_SCORE_I8_LOAD(M)                                              \
  switch (load) {                                                           \
    case 16: SPTAG_SCORE_I8(M, 16) break;                                   \
    case 4: SPTAG_SCORE_I8(M, 4) break;                                     \
    default: SPTAG_SCORE_I8(M, 1) break;                                    \
  }
  switch (mode) {
    case kGather: SPTAG_SCORE_I8_LOAD(kGather) break;
    case kRows: SPTAG_SCORE_I8_LOAD(kRows) break;
    default: return -2;
  }
#undef SPTAG_SCORE_I8_LOAD
#undef SPTAG_SCORE_I8
  return static_cast<int>(cudaGetLastError());
}

// out (N,) = each row's squared norm by warp_sqnorm.
extern "C" int sptag_walk_sqnorms(const void* x, void* out, long long N,
                                  int D, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0) return -1;
  const long long blocks = (N + kNormWarps - 1) / kNormWarps;
  if (blocks > 2147483647LL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(32 * kNormWarps);
  if (D % 4 == 0 && aligned16(x)) {
    walk_sqnorms_kernel<true><<<grid, block, 0, s>>>(xf, o, N, D);
  } else {
    walk_sqnorms_kernel<false><<<grid, block, 0, s>>>(xf, o, N, D);
  }
  return static_cast<int>(cudaGetLastError());
}
