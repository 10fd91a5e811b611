// edge_popcount: for each pair p, the number of common neighbours of
// u[p] and v[p], sum over w of popcount(adj[u, w] & adj[v, w]) over the
// rows of a packed uint32 adjacency bitset [n, words].
//
// Replaces flink_tpu/graph/library.py _edge_common_neighbors.per_edge
// (:398-400), the shared kernel of TriangleCount and
// ClusteringCoefficient.
//
// Bound on this card: bytes.  The bitset is read at least once
// (n * words * 4 B); read pair by pair, as here, each pair moves its two
// rows (8 * words B), and rows of high-degree vertices come from the L2.
//
// Design: one warp per pair.  The lanes walk the two rows together, 16 B
// a lane a step (uint4 loads, when the row length is a multiple of four
// words; one word a lane otherwise), AND them and count with __popc,
// then reduce the 32 partial counts with shuffles and write one int32.
// Integer work: bit-equal to the plain version and to the reference.
#include "common.cuh"

__global__ void edge_popcount_kernel(const uint32_t* __restrict__ adj,
                                     long long words,
                                     const int32_t* __restrict__ u,
                                     const int32_t* __restrict__ v,
                                     long long n_pairs,
                                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_grid =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long p = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       p < n_pairs; p += warps_per_grid) {
    const uint32_t* a = adj + static_cast<long long>(u[p]) * words;
    const uint32_t* b = adj + static_cast<long long>(v[p]) * words;
    int count = 0;
    if ((words & 3) == 0) {
      const uint4* a4 = reinterpret_cast<const uint4*>(a);
      const uint4* b4 = reinterpret_cast<const uint4*>(b);
      for (long long w = lane; w < (words >> 2); w += 32) {
        const uint4 x = __ldg(a4 + w);
        const uint4 y = __ldg(b4 + w);
        count += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
                 __popc(x.w & y.w);
      }
    } else {
      for (long long w = lane; w < words; w += 32) {
        count += __popc(__ldg(a + w) & __ldg(b + w));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
    }
    if (lane == 0) out[p] = count;
  }
}

extern "C" int ft_edge_popcount(const void* adj, long long words,
                                const void* u, const void* v,
                                long long n_pairs, void* out, void* stream) {
  if (n_pairs > 0) {
    const int threads = 256;
    long long blocks = (n_pairs + (threads / 32) - 1) / (threads / 32);
    const long long cap = 132LL * 64LL;
    if (blocks > cap) blocks = cap;
    edge_popcount_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(adj), words,
        static_cast<const int32_t*>(u), static_cast<const int32_t*>(v),
        n_pairs, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
