// hll_log_finish: the log tier's HLL fire finish over compacted cells.
//
// Replaces flink_tpu/streaming/log_windows.py _HllMode._device_finish
// (the jitted finish): per key k, its compacted cells are the run
// [ends[k-1], ends[k]) of ranks (one cell per present register, the
// register's max rank); inv_sum = (m - present) + sum 2^-rank, the
// estimate alpha * m * m / inv_sum, and linear counting
// m * (log m - log zeros) when est <= 2.5 m and zeros = m - present > 0.
// The fire needs the estimates only; inv_sum is written when the caller
// passes an array for it (a check of the sums), and is skipped otherwise.
//
// Exactness: every term 2^-rank (rank <= 33) is dyadic and a key has at
// most m <= 2^16 cells, so each partial sum needs at most 49 mantissa
// bits: the float64 segment sum is exact in any order.  The kernel
// therefore equals its plain version and the C++ host fire
// (ft_hll_log_fire, inv_sum in double) bit for bit on inv_sum, and on
// the estimate too: alpha * m * m arrives precomputed in double as the
// host computes it, the division is IEEE, and the logs come from a
// table the host fills with libm's log (log_tab[z] = log z, 1 <= z <= m),
// the function the C++ fire calls.  (The JAX finish takes a float32
// cumsum over the whole window and differences it at run ends, so its
// error grows with the position in the log.)
//
// Bound on this card: bytes, and launch latency at real sizes.  n_cells
// rank bytes and 4 n_keys end bytes are read once, 8 n_keys estimate
// bytes written; at BASELINE config #2 (~8.4M cells, ~1M keys) that is
// ~20 MB, about 6 us at 3.35 TB/s.
//
// Design: one warp per key.  The lanes stride over the key's run (32
// neighbouring bytes a step, so a warp's loads coalesce), build 2^-rank
// from the exponent bits ((1023 - r) << 52, no transcendental), sum in
// float64 and reduce by shuffles; lane 0 applies the estimator.  A
// config #2 key has ~8 cells, so most lanes of a warp idle: the kernel
// stays simple because the launch, not the bandwidth, bounds it.
#include "common.cuh"

__global__ void hll_log_finish_kernel(const uint8_t* __restrict__ ranks,
                                      const int32_t* __restrict__ ends,
                                      long long n_keys, long long m,
                                      double alpha_m2,
                                      const double* __restrict__ log_tab,
                                      double* __restrict__ est,
                                      double* __restrict__ inv_sum_out) {
  const long long key =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (key >= n_keys) return;  // uniform across the warp
  const long long lo = key == 0 ? 0 : static_cast<long long>(ends[key - 1]);
  const long long hi = static_cast<long long>(ends[key]);
  double s = 0.0;
  for (long long i = lo + lane; i < hi; i += 32)
    s += __longlong_as_double((1023LL - static_cast<long long>(ranks[i]))
                              << 52);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
  if (lane == 0) {
    const double mf = static_cast<double>(m);
    const double present = static_cast<double>(hi - lo);
    // registers not present contribute 2^-0 = 1 each
    const double inv_sum = (mf - present) + s;
    double e = alpha_m2 / inv_sum;
    const double zeros = mf - present;
    if (e <= 2.5 * mf && zeros > 0.0)
      e = mf * (log_tab[m] - log_tab[m - (hi - lo)]);
    est[key] = e;
    if (inv_sum_out != nullptr) inv_sum_out[key] = inv_sum;
  }
}

// alpha_m2 is (alpha * m) * m in double; log_tab holds m + 1 doubles;
// inv_sum may be null.
extern "C" int ft_hll_log_finish(const void* ranks, const void* ends,
                                 long long n_keys, long long m,
                                 double alpha_m2, const void* log_tab,
                                 void* est, void* inv_sum, void* stream) {
  if (n_keys > 0) {
    const int threads = 256;
    const long long blocks = (n_keys * 32 + threads - 1) / threads;
    hll_log_finish_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ranks),
        static_cast<const int32_t*>(ends), n_keys, m, alpha_m2,
        static_cast<const double*>(log_tab), static_cast<double*>(est),
        static_cast<double*>(inv_sum));
  }
  return static_cast<int>(cudaGetLastError());
}
