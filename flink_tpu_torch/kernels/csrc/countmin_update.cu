// countmin_update: Count-Min scatter-add into an int32 [C, d, w] table
// and an int32 [C] total.
//
// Replaces flink_tpu/ops/sketches.py CountMinSketchAggregate.update
// (with ops/hashing.py countmin_rows), reached through
// flink_tpu/streaming/vectorized.py make_masked_update and
// streaming/vectorized_sessions.py _jit_update: per record i < n and
// row r < d, col = (lo + r * hi) mod w in uint32 arithmetic (r * hi
// wraps before the add and the mod), table[slot, r, col] += weight and
// total[slot] += weight, weight = int32(value) rounded toward zero.
//
// Bound on this card: bytes.  Each record reads 16 B (slot, weight,
// two hash lanes) and makes d + 1 random 4-byte read-modify-writes;
// the arithmetic (a multiply, an add and a modulo per row) is far
// below the compute roof.
//
// Design: one thread per (record, row) over a grid-stride loop, so the
// d atomics of one record go out from d neighbouring threads.  Integer
// atomicAdd makes the result independent of order: tables are
// bit-equal to the reference's.  The row-0 thread also adds to total.
// Addressing is 64-bit ((slot * d + r) * w + col): at 2^17 slots of
// 4 x 2048 the table passes 2^31 bytes.  The weight converts with
// __float2int_rz (toward zero, saturating, NaN -> 0), as XLA's
// convert does.  Records at or beyond n, and slots outside [0, C),
// write nothing, as the reference's mask and XLA's out-of-bounds
// scatter drop them.
#include "common.cuh"

__global__ void countmin_update_kernel(int32_t* __restrict__ table,
                                       int32_t* __restrict__ total,
                                       const int32_t* __restrict__ slots,
                                       const float* __restrict__ values,
                                       const uint32_t* __restrict__ hi,
                                       const uint32_t* __restrict__ lo,
                                       long long n, int depth, long long width,
                                       long long capacity) {
  const long long items = n * depth;
  FT_GRID_STRIDE(i, items) {
    const long long rec = i / depth;
    const int r = static_cast<int>(i - rec * depth);
    const long long slot = slots[rec];
    if (slot < 0 || slot >= capacity) continue;
    const int w = __float2int_rz(values[rec]);
    const uint32_t h = lo[rec] + static_cast<uint32_t>(r) * hi[rec];
    const long long col = static_cast<long long>(h % static_cast<uint32_t>(width));
    atomicAdd(table + (slot * depth + r) * width + col, w);
    if (r == 0) atomicAdd(total + slot, w);
  }
}

extern "C" int ft_countmin_update(void* table, void* total, const void* slots,
                                  const void* values, const void* hi,
                                  const void* lo, long long n, int depth,
                                  long long width, long long capacity,
                                  void* stream) {
  if (n > 0 && depth > 0) {
    const int threads = 256;
    countmin_update_kernel<<<grid_for(n * depth, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(table), static_cast<int32_t*>(total),
        static_cast<const int32_t*>(slots), static_cast<const float*>(values),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), n,
        depth, width, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
