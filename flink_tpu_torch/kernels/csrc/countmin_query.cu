// countmin_query: Count-Min point queries, min over the d rows.
//
// Replaces flink_tpu/ops/sketches.py CountMinSketchAggregate.point_query,
// reached through flink_tpu/streaming/heavy_hitters.py _jit_point_query:
// for query i, out[i] = min over r < d of table[slot_i, r, col_r], with
// col_r = (lo_i + r * hi_i) mod w in uint32 arithmetic.
//
// Bound on this card: bytes.  Each query reads 12 B (slot, two hash
// lanes), gathers d random 4-byte cells and writes 4 B; the arithmetic
// is a few integer operations per row.
//
// Design: one thread per query over a grid-stride loop; the d gathers
// are independent loads the thread issues back to back.  The slot is
// clamped into [0, C), as XLA's gather clamps an out-of-range index.
// Addressing is 64-bit.  An integer min: bit-equal to the reference.
#include "common.cuh"

__global__ void countmin_query_kernel(const int32_t* __restrict__ table,
                                      const int32_t* __restrict__ slots,
                                      const uint32_t* __restrict__ hi,
                                      const uint32_t* __restrict__ lo,
                                      long long q, int depth, long long width,
                                      long long capacity,
                                      int32_t* __restrict__ out) {
  FT_GRID_STRIDE(i, q) {
    long long slot = slots[i];
    slot = slot < 0 ? 0 : (slot >= capacity ? capacity - 1 : slot);
    const uint32_t h_hi = hi[i];
    const uint32_t h_lo = lo[i];
    const int32_t* row = table + slot * depth * width;
    int32_t best = 0;
    for (int r = 0; r < depth; ++r) {
      const uint32_t h = h_lo + static_cast<uint32_t>(r) * h_hi;
      const int32_t v =
          __ldg(row + r * width + static_cast<long long>(h % static_cast<uint32_t>(width)));
      best = r == 0 ? v : min(best, v);
    }
    out[i] = best;
  }
}

extern "C" int ft_countmin_query(const void* table, const void* slots,
                                 const void* hi, const void* lo, long long q,
                                 int depth, long long width,
                                 long long capacity, void* out, void* stream) {
  if (q > 0) {
    const int threads = 256;
    countmin_query_kernel<<<grid_for(q, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), static_cast<const int32_t*>(slots),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), q,
        depth, width, capacity, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
