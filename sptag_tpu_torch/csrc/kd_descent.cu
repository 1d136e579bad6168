// The kd forest's seed descent (sptag_tpu_torch/ops/kd_descent.py): for
// each query and tree, the greedy leaf and the leaves under the
// `backtrack` lowest-bound other branches of its path, the seeds of a KDT
// index's graph walk (algo/engine.py, `_seed_from_seeds`).
//
// Replaces no Pallas kernel: the JAX package descends the forest in host
// numpy (sptag_tpu/trees/kdtree.py, `collect_seeds`), which the port kept
// (trees/kdtree.py) and ran before every search, then uploaded the seeds.
// Here the descent runs on the card in the walk's stream, so a captured
// walk holds it and a KDT search uploads only its queries.
//
// One warp a (query, tree), four warps a CTA (one where a deep forest's
// path slices need the room).  The descent is a chain of dependent loads,
// one 16-byte node record (KDTNode: left, right, split_dim, split_value's
// bits) a level; its bytes are a few kilobytes a query, so the kernel is
// bound by that chain's latency, not by bandwidth:
//
//  1. The warp walks the greedy path in step (the same node in every lane,
//     one broadcast load a level).  Lane 0 writes each level's other child
//     and its bound, diff^2 with diff = q[split_dim] - split_value in
//     float32, into the warp's slice of shared memory.
//  2. Each lane takes path entries j = lane, lane + 32, ...: an entry with
//     a finite bound gets its rank among the finite bounds, ordered by
//     (bound, level), and one whose rank is below `backtrack` is descended
//     greedily by its lane alone (the lanes' chains in flight at once)
//     and written at output slot 1 + rank.
//
// The output row of (q, t) is [greedy leaf, the chosen leaves by rank,
// -1 ...], as trees/kdtree.py's `collect_seeds` gives them up to the order
// of the chosen leaves (numpy's argpartition leaves that order open; here
// it is the bounds' ascending order, ties to the shallower level).  A leaf
// is encoded as -id - 1 in a child slot.
//
// `depth` is the forest's longest root-to-leaf path in internal nodes
// (the wrapper computes it once a forest); each warp's shared slice holds
// `depth` (child, bound) pairs, and no loop runs longer than `depth`.
// Every thread counts the node records it read; a warp adds its sum into
// `reads` (one int64 on the card that the engine owns) with one atomicAdd,
// which a captured graph replays like any other launch.  The kernel
// neither allocates nor synchronises and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;

// the greedy child of node record `nd` for the query row `q`; `other`
// and `bound` get the other child and its split-plane bound
__device__ __forceinline__ int greedy_child(const int4 nd,
                                            const float* __restrict__ q,
                                            int D, int* other,
                                            float* bound) {
  const int dim = min(max(nd.z, 0), D - 1);
  const float diff = __fsub_rn(__ldg(q + dim), __int_as_float(nd.w));
  *bound = __fmul_rn(diff, diff);
  const bool left = diff < 0.0f;
  *other = left ? nd.y : nd.x;
  return left ? nd.x : nd.y;
}

__device__ __forceinline__ int64_t leaf_id(int ptr) {
  return ptr < 0 ? -static_cast<int64_t>(ptr) - 1 : -1;
}

__global__ void kd_descent_kernel(const float* __restrict__ queries,
                                  const int4* __restrict__ nodes,
                                  const int32_t* __restrict__ tree_starts,
                                  int64_t* __restrict__ out,
                                  unsigned long long* __restrict__ reads,
                                  int Q, int D, int T, int backtrack,
                                  int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (pair >= static_cast<long long>(Q) * T) return;
  const int q = static_cast<int>(pair / T), t = static_cast<int>(pair % T);
  int* p_other = reinterpret_cast<int*>(smem) + 2 * warp * depth;
  float* p_bound = reinterpret_cast<float*>(p_other + depth);
  const float* qrow = queries + static_cast<long long>(q) * D;
  const int per = 1 + backtrack;
  int64_t* orow = out + pair * per;
  unsigned long long count = 0;

  // 1. the greedy path, the warp in step
  int ptr = tree_starts[t];
  int n = 0;
  while (ptr >= 0 && n < depth) {
    int other;
    float bound;
    ptr = greedy_child(__ldg(nodes + ptr), qrow, D, &other, &bound);
    if (lane == 0) {
      p_other[n] = other;
      p_bound[n] = bound;
    }
    ++n;
  }
  if (lane == 0) count = n;
  for (int j = lane; j < per; j += 32) orow[j] = j == 0 ? leaf_id(ptr) : -1;
  __syncwarp();

  // 2. the `backtrack` lowest finite bounds, each descended by its lane
  for (int j = lane; j < n; j += 32) {
    const float bj = p_bound[j];
    if (!isfinite(bj)) continue;
    int rank = 0;
    for (int i = 0; i < n; ++i) {
      const float bi = p_bound[i];
      rank += (bi < bj) | ((bi == bj) & (i < j));
    }
    if (rank >= backtrack) continue;
    int p = p_other[j];
    for (int s = 0; p >= 0 && s < depth; ++s) {
      int other;
      float bound;
      p = greedy_child(__ldg(nodes + p), qrow, D, &other, &bound);
      ++count;
    }
    orow[1 + rank] = leaf_id(p);
  }

  // the warp's node reads, one atomic a warp
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(kFull, count, off);
  if (lane == 0 && count && reads != nullptr) atomicAdd(reads, count);
}

}  // namespace

extern "C" int sptag_kd_descent(const void* queries, const void* nodes,
                                const void* tree_starts, void* out,
                                void* reads, int Q, int D, int T,
                                int backtrack, int depth, int warps,
                                int smem_bytes, void* stream) {
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kd_descent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const long long pairs = static_cast<long long>(Q) * T;
  const int blocks = static_cast<int>((pairs + warps - 1) / warps);
  kd_descent_kernel<<<blocks, warps * 32, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const int4*>(nodes),
      static_cast<const int32_t*>(tree_starts), static_cast<int64_t*>(out),
      static_cast<unsigned long long*>(reads), Q, D, T, backtrack, depth);
  return static_cast<int>(cudaGetLastError());
}
