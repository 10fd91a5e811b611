// quantile_update: log-bucket histogram add into an int32 [C, B] file.
//
// Replaces flink_tpu/ops/sketches.py QuantileSketchAggregate._bucket_of
// and .update, reached through flink_tpu/streaming/vectorized.py
// make_masked_update and streaming/vectorized_sessions.py _jit_update:
// per record i < n, in float32,
//   logs = log(max(v, min_value)) / log_gamma,
//   b = clamp(1 + floor(logs) - offset, 1, B - 1), b = 0 where v <= min_value,
// and hist[slot, b] += 1.
//
// Bound on this card: bytes.  Each record reads 8 B (slot, value) and
// makes one random 4-byte read-modify-write; a log, a division and a
// floor per record are far below the compute roof.
//
// Design: one thread per record over a grid-stride loop, integer
// atomicAdd (order-free, so histograms are exact).  The float steps are
// the reference's, each rounded as IEEE float32: logf (this file builds
// without fast math, so logf is the libdevice function PyTorch's CUDA
// log calls too) and a true division, not a multiply by a reciprocal.
// The floor converts with __float2int_rz, which saturates (+inf lands
// in the top bucket) and maps NaN to 0; the bucket is then clamped in
// 64-bit arithmetic.  max() keeps a NaN value NaN, as jnp.maximum and
// torch.maximum do (fmaxf would not).  Addressing is 64-bit: at 2^22
// slots of 209 buckets the file passes 2^31 bytes.  Records at or
// beyond n, and slots outside [0, C), write nothing (-1 is the port's
// skip mark; XLA's scatter would wrap a slot in [-C, -1] to s + C, but
// the reference's callers mask negative slots first: ops/slot_index.py).
#include "common.cuh"

__global__ void quantile_update_kernel(int32_t* __restrict__ hist,
                                       const int32_t* __restrict__ slots,
                                       const float* __restrict__ values,
                                       long long n, long long buckets,
                                       long long capacity, float min_value,
                                       float log_gamma, long long offset) {
  FT_GRID_STRIDE(i, n) {
    const long long slot = slots[i];
    if (slot < 0 || slot >= capacity) continue;
    const float v = values[i];
    const float x = (v != v) ? v : fmaxf(v, min_value);
    const float logs = __fdiv_rn(logf(x), log_gamma);
    long long b = 1 + static_cast<long long>(__float2int_rz(floorf(logs))) - offset;
    b = b < 1 ? 1 : (b > buckets - 1 ? buckets - 1 : b);
    if (v <= min_value) b = 0;
    atomicAdd(hist + slot * buckets + b, 1);
  }
}

extern "C" int ft_quantile_update(void* hist, const void* slots,
                                  const void* values, long long n,
                                  long long buckets, long long capacity,
                                  float min_value, float log_gamma,
                                  long long offset, void* stream) {
  if (n > 0) {
    const int threads = 256;
    quantile_update_kernel<<<grid_for(n, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(hist), static_cast<const int32_t*>(slots),
        static_cast<const float*>(values), n, buckets, capacity, min_value,
        log_gamma, offset);
  }
  return static_cast<int>(cudaGetLastError());
}
