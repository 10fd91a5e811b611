// gather_segment_sum: out[dst[e]] += x[src[e]] over the edges of a graph
// (float32 values, int32 endpoints), into an out that the caller zeroed.
//
// Replaces flink_tpu/graph/library.py PageRank.run.step
// (`jax.ops.segment_sum((ranks / deg)[src], dst)`, :40-49) and both
// segment sums of HITS.run.step (:243-255).
//
// Bound on this card: bytes.  Each edge reads 8 B of endpoints, gathers
// one 4 B value and does one 4 B read-modify-write of out; the gather
// and the atomic touch one 32 B sector each where the endpoints have no
// locality.
//
// Design: one thread per edge over a grid-stride loop, float atomicAdd
// into out (the L2's atomic units do the adds; no sort of the edges by
// dst).  The adds land in an order that changes from run to run, so the
// sums are not bit-equal to XLA's segment_sum or to the plain version's
// index_add_: they agree within a bound set by the edge count and
// float32 epsilon, which the tests state.
#include "common.cuh"

__global__ void gather_segment_sum_kernel(float* __restrict__ out,
                                          const float* __restrict__ x,
                                          const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          long long n_edges) {
  FT_GRID_STRIDE(e, n_edges) {
    atomicAdd(out + dst[e], __ldg(x + src[e]));
  }
}

extern "C" int ft_gather_segment_sum(void* out, const void* x,
                                     const void* src, const void* dst,
                                     long long n_edges, void* stream) {
  if (n_edges > 0) {
    const int threads = 256;
    gather_segment_sum_kernel<<<grid_for(n_edges, threads), threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), static_cast<const float*>(x),
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
        n_edges);
  }
  return static_cast<int>(cudaGetLastError());
}
