// hll_estimate: per-slot HyperLogLog estimate over a uint8 [C, m] file.
//
// Replaces flink_tpu/streaming/vectorized.py _jit_result_all,
// _result_contig and _jit_result -> flink_tpu/ops/sketches.py
// HyperLogLogAggregate.result / result_dense / _estimate: per slot,
// sum of 2^-r (float32 exponent bits (127 - r) << 23), count of zero
// registers, est = alpha * m * m / sum, linear counting
// m * (log m - log zeros) when est <= 2.5 m and zeros > 0.
//
// Bound on this card: bytes.  S * m register bytes are read once and
// S * 4 bytes written; the arithmetic (a subtract, a shift and an add
// per register) is far below the compute roof.  A full fire of 1.25M
// slots at p = 12 reads 5.12 GB.
//
// Design: one block per slot row.  Threads read the row 16 bytes at a
// time (uint4 loads, neighbouring threads on neighbouring addresses, so
// a warp reads 512 contiguous bytes), build 2^-r from exponent bits
// without a transcendental, and keep a float sum and an int zero count
// in registers; a warp-shuffle then shared-memory reduction combines
// them, and thread 0 applies the estimator.  One kernel, compiled for
// each form (no branch on the form in the block), serves the dense form
// (slots == nullptr: rows 0 .. S of the given file, which may be a row
// slice of a larger one) and the gathered form (row = slots[b]: a
// negative slot wraps once to s + C, then the row clamps into [0, C),
// the reference's index rule, ft_gather_row).  The reduction order
// differs from XLA's, so results agree to float32 rounding (held at
// rtol 1e-5), not bit for bit.  The
// linear-counting logs are correctly rounded float32 values; XLA's
// float32 log of some integers is one ulp off, which the tests against
// the JAX package allow for (see tests/torch_port_util.py).
#include "common.cuh"

__device__ __forceinline__ void accumulate_word(unsigned int w, float& s,
                                                int& z) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = static_cast<int>((w >> (8 * k)) & 0xFFu);
    s += __int_as_float((127 - r) << 23);
    z += (r == 0);
  }
}

// kGathered: row = slots[b] by the index rule; otherwise row b
template <bool kGathered>
__global__ void hll_estimate_kernel(const uint8_t* __restrict__ regs,
                                    const int32_t* __restrict__ slots,
                                    long long m,
                                    long long capacity, float alpha_m2,
                                    float* __restrict__ out) {
  const long long row = kGathered ? ft_gather_row(slots[blockIdx.x], capacity)
                                  : static_cast<long long>(blockIdx.x);
  const uint4* p = reinterpret_cast<const uint4*>(regs + row * m);
  const long long nvec = m / 16;
  float s = 0.0f;
  int z = 0;
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 v = p[i];
    accumulate_word(v.x, s, z);
    accumulate_word(v.y, s, z);
    accumulate_word(v.z, s, z);
    accumulate_word(v.w, s, z);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    z += __shfl_down_sync(0xFFFFFFFFu, z, off);
  }
  __shared__ float ws[32];
  __shared__ int wz[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wz[warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? ws[lane] : 0.0f;
    z = lane < nwarps ? wz[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xFFFFFFFFu, s, off);
      z += __shfl_down_sync(0xFFFFFFFFu, z, off);
    }
    if (lane == 0) {
      const float mf = static_cast<float>(m);
      const float est = alpha_m2 / s;
      const float zf = static_cast<float>(z);
      // correctly rounded float32 logs (double log, then one rounding):
      // m * (log m - log zeros) cancels badly when zeros is near m, so
      // an ulp of either log moves the result by up to ~4e-3 relative;
      // with correctly rounded logs the kernel, the plain version and
      // an independent reference agree exactly in this branch
      const float lm = __double2float_rn(log(static_cast<double>(m)));
      const float lz = __double2float_rn(log(static_cast<double>(fmaxf(zf, 1.0f))));
      const float linear = mf * (lm - lz);
      out[blockIdx.x] = (est <= 2.5f * mf && z > 0) ? linear : est;
    }
  }
}

// alpha_m2 is (float(alpha) * float(m)) * float(m), rounded to float32
// at each step as the reference computes it.
extern "C" int ft_hll_estimate(const void* regs, const void* slots,
                               long long rows, long long m,
                               long long capacity, float alpha_m2,
                               void* out, void* stream) {
  if (rows > 0) {
    long long t = m / 16;
    int threads = t >= 256 ? 256 : (t <= 32 ? 32 : static_cast<int>(t));
    threads = (threads + 31) / 32 * 32;
    auto kernel =
        slots != nullptr ? hll_estimate_kernel<true> : hll_estimate_kernel<false>;
    kernel<<<static_cast<unsigned int>(rows), threads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(regs),
        static_cast<const int32_t*>(slots), m, capacity, alpha_m2,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
