// quantile_result: per-slot quantiles of an int32 [C, B] histogram.
//
// Replaces flink_tpu/ops/sketches.py QuantileSketchAggregate.result
// (and result_dense, which the reference defaults through result,
// flink_tpu/ops/device_agg.py:121-130), reached through the window
// engines' fire (_jit_result / _result_contig in
// flink_tpu/streaming/vectorized.py, _jit_result in
// streaming/vectorized_sessions.py): per row, cum = cumsum(hist) in
// float32, total = cum[B - 1]; for each quantile q, target =
// max(q * total, 1) and the answer is bucket_val[first b with
// cum[b] >= target], or bucket_val[0] (= 0) when there is none, which
// is argmax of an all-false row: the empty slot.
//
// Bound on this card: bytes.  A row of B * 4 bytes is read and Q * 4
// written; a scan of B integers is a few operations per byte.
//
// Design: one warp per row, rows over a grid-stride loop of warps.
// Pass 1 sums the row (lane j reads buckets j, j + 32, ..., coalesced)
// into total.  Pass 2 walks the row again 32 buckets at a time (from
// L1/L2: a row at the config-#3 geometry is 836 bytes): a warp
// inclusive scan with __shfl_up_sync plus the carry of earlier chunks
// gives cum, and for each quantile still open __ballot_sync of
// cum >= target finds the first such bucket in the chunk; the pass
// stops once every quantile is found.  The counts are integers summed
// exactly (they stay below 2^24, so the float32 cumsum of the
// reference is exact in any order too) and converted to float32 for
// the comparisons, so the selected bucket is exactly the reference's.
// bucket_val is a float32 table of B values the caller computes once
// (the aggregate, from the reference's formula); the kernel indexes
// it, so its values are bit-equal to the plain version's.  Dense form
// (slots == nullptr): rows 0 .. S of the given file, which may be a
// row slice of a larger one; gathered form: row = slots[i], clamped
// into [0, C) as XLA's gather clamps.  Addressing is 64-bit.
#include "common.cuh"

constexpr int kMaxQ = 16;

__global__ void quantile_result_kernel(const int32_t* __restrict__ hist,
                                       const int32_t* __restrict__ slots,
                                       long long rows, long long buckets,
                                       long long capacity,
                                       const float* __restrict__ qs, int nq,
                                       const float* __restrict__ bucket_val,
                                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * warps_per_block +
                          (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * warps_per_block;
  for (long long i = first; i < rows; i += stride) {
    long long row;
    if (slots != nullptr) {
      row = slots[i];
      row = row < 0 ? 0 : (row >= capacity ? capacity - 1 : row);
    } else {
      row = i;
    }
    const int32_t* h = hist + row * buckets;
    int s = 0;
    for (long long b = lane; b < buckets; b += 32) s += h[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
    const float total = static_cast<float>(s);
    float target[kMaxQ];
    long long found[kMaxQ];
    int open = 0;
    for (int k = 0; k < nq; ++k) {
      target[k] = fmaxf(__fmul_rn(qs[k], total), 1.0f);
      found[k] = -1;
      ++open;
    }
    int carry = 0;
    for (long long base = 0; base < buckets && open > 0; base += 32) {
      const long long b = base + lane;
      int c = b < buckets ? h[b] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, c, off);
        if (lane >= off) c += up;
      }
      c += carry;
      const float cum = static_cast<float>(c);
      for (int k = 0; k < nq; ++k) {
        if (found[k] >= 0) continue;
        const unsigned int hit =
            __ballot_sync(0xFFFFFFFFu, b < buckets && cum >= target[k]);
        if (hit != 0u) {
          found[k] = base + __ffs(hit) - 1;
          --open;
        }
      }
      carry = __shfl_sync(0xFFFFFFFFu, c, 31);
    }
    for (int k = lane; k < nq; k += 32) {
      out[i * nq + k] = bucket_val[found[k] >= 0 ? found[k] : 0];
    }
  }
}

extern "C" int ft_quantile_result(const void* hist, const void* slots,
                                  long long rows, long long buckets,
                                  long long capacity, const void* qs, int nq,
                                  const void* bucket_val, void* out,
                                  void* stream) {
  if (nq < 1 || nq > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const int threads = 256;
    const long long warps = threads / 32;
    long long blocks = (rows + warps - 1) / warps;
    const long long cap = 132LL * 16LL;
    if (blocks > cap) blocks = cap;
    quantile_result_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hist), static_cast<const int32_t*>(slots),
        rows, buckets, capacity, static_cast<const float*>(qs), nq,
        static_cast<const float*>(bucket_val), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
