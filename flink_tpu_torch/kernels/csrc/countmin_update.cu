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
// Bound on this card: bytes, scattered.  Each record reads 16 B (slot,
// weight, two hash lanes) and makes d + 1 random 4-byte
// read-modify-writes; a random word costs its 32-byte sector each way
// in practice, and the L2 applies the atomics.  The arithmetic (a
// multiply, an add and a mask or modulo per row) is far below the
// compute roof.
//
// Design: one thread per record, all d rows from one load of its slot,
// weight and lanes, so each record's 16 B are read once and no index is
// divided.  A power-of-two width takes a mask, any other a 32-bit
// modulo.  The table adds are fire-and-forget reductions (the
// return value unused: RED, no round trip).  The total adds are merged
// within a warp: the lanes whose records share a slot sum their weights
// (__match_any_sync, __reduce_add_sync) and the lowest of them adds the
// sum, one atomic per distinct slot.  At 2^14 slots of 4 x 2048 the
// table's adds alone take as long as the kernel: the L2's atomics on
// words that miss it are the limit (scripts/kernel_probe.py).  Integer
// adds wrap, so any order and any merge give the same bits: tables are
// bit-equal to the reference's.  Addressing is 64-bit (slot * d * w): at 2^17 slots of
// 4 x 2048 the table passes 2^31 bytes.  The weight converts with
// __float2int_rz (toward zero, saturating, NaN -> 0), as XLA's convert
// does; a record of weight 0 adds nothing and is skipped.  Records at or
// beyond n write nothing, as the reference's mask drops them, and so do
// slots outside [0, C): -1 is the port's skip mark.  XLA's scatter would
// wrap a slot in [-C, -1] to s + C and drop only the rest; the
// reference's callers mask negative slots first (ops/slot_index.py).
#include "common.cuh"

#define CM_THREADS 256

template <bool kPow2>
__global__ void __launch_bounds__(CM_THREADS)
countmin_update_kernel(int32_t* __restrict__ table,
                       int32_t* __restrict__ total,
                       const int32_t* __restrict__ slots,
                       const float* __restrict__ values,
                       const uint32_t* __restrict__ hi,
                       const uint32_t* __restrict__ lo, long long n, int depth,
                       uint32_t width, long long capacity) {
  const long long step = static_cast<long long>(gridDim.x) * CM_THREADS;
  // the loop bound is uniform across a warp, so the warp's votes below
  // see all 32 lanes
  for (long long base = static_cast<long long>(blockIdx.x) * CM_THREADS;
       base < n; base += step) {
    const long long i = base + threadIdx.x;
    int32_t slot = -1;
    int w = 0;
    uint32_t h1 = 0, h0 = 0;
    if (i < n) {
      slot = slots[i];
      w = __float2int_rz(values[i]);
      h1 = hi[i];
      h0 = lo[i];
    }
    const bool live = w != 0 && slot >= 0 && slot < capacity;
    if (live) {
      int32_t* cells = table + static_cast<long long>(slot) * depth * width;
#pragma unroll 4
      for (int r = 0; r < depth; ++r) {
        const uint32_t h = h0 + static_cast<uint32_t>(r) * h1;
        const uint32_t col = kPow2 ? (h & (width - 1u)) : (h % width);
        atomicAdd(cells + col, w);
        cells += width;
      }
    }
    const unsigned active = __ballot_sync(0xFFFFFFFFu, live);
    if (live) {
      const unsigned peers = __match_any_sync(active, slot);
      const int sum = __reduce_add_sync(peers, w);
      if ((threadIdx.x & 31u) == static_cast<unsigned>(__ffs(peers) - 1))
        atomicAdd(total + slot, sum);
    }
  }
}

extern "C" int ft_countmin_update(void* table, void* total, const void* slots,
                                  const void* values, const void* hi,
                                  const void* lo, long long n, int depth,
                                  long long width, long long capacity,
                                  void* stream) {
  if (n > 0 && depth > 0) {
    const unsigned int grid = grid_for(n, CM_THREADS);
    const uint32_t w = static_cast<uint32_t>(width);
    auto* t = static_cast<int32_t*>(table);
    auto* tot = static_cast<int32_t*>(total);
    auto* s = static_cast<const int32_t*>(slots);
    auto* v = static_cast<const float*>(values);
    auto* h = static_cast<const uint32_t*>(hi);
    auto* l = static_cast<const uint32_t*>(lo);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if ((w & (w - 1u)) == 0u)
      countmin_update_kernel<true><<<grid, CM_THREADS, 0, st>>>(
          t, tot, s, v, h, l, n, depth, w, capacity);
    else
      countmin_update_kernel<false><<<grid, CM_THREADS, 0, st>>>(
          t, tot, s, v, h, l, n, depth, w, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
