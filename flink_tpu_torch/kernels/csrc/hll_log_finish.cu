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
// Exactness: ranks lie in [0, 33] (hll_make_cells gives 1..33: the clz
// of 32 hash bits, plus one), and a key has at most m <= 2^16 cells, so
// every partial sum of its terms 2^-rank is a multiple of 2^-33 below
// 2^16 + 1: at most 49 mantissa bits, and the float64 sum is exact in
// any order (the kernel's lanes and shuffles, the plain version's
// index_add_, the host's loop).  So inv_sum equals its plain version and the
// C++ host fire (ft_hll_log_fire, inv_sum in double) bit for bit, and
// so does the estimate: alpha * m * m arrives precomputed in double as
// the host computes it, the division is IEEE, and the logs come from a
// table the host fills with libm's log (log_tab[z] = log z, 1 <= z <= m),
// the function the C++ fire calls.  (The JAX finish takes a float32
// cumsum over the whole window and differences it at run ends, so its
// error grows with the position in the log.)
//
// Bound on this card: bytes.  n_cells rank bytes and 4 n_keys end bytes
// are read once, 8 n_keys estimate bytes written; at BASELINE config #2
// (~8.4M cells, ~1M keys) that is ~20 MB, about 6 us at 3.35 TB/s.
// Positions are 32-bit: the wrapper takes at most 2^31 - 64 rank bytes.
//
// Design: a group of G lanes (1 to 32, a power of two, chosen by the
// launcher from n_keys and n_cells: a word of the mean run a lane in a
// small launch, else up to LF_BATCH words a lane: 1 at config #2, 8 at
// a mesh launch) takes a key.  Its
// lanes read the key's two run ends, then the run's 16-byte words of
// ranks straight from memory (aligned in memory: a run starts at any
// byte, and bytes outside it are masked), word w0 + lane, + G, ...,
// LF_BATCH words a lane issued before any is added, so one memory trip
// serves a run of up to 16 LF_BATCH G bytes.  Each lane adds 2^-rank of its bytes
// in float64 (the term from its exponent bits, a byte out of the run
// predicated off), the group adds its lanes' parts by shuffles,
// and the group's first lane applies the estimator (the log_tab lookup
// through the read-only path) and stores the estimate: consecutive keys,
// so a warp's stores coalesce.  A run longer than LF_LONG_WORDS words a
// lane (a hot key among cold ones: keys drawn from a Zipf law put runs
// of all 4,096 cells at p = 12 among runs of a few) is summed by the
// whole warp, a word a lane, after the groups' own runs (later rounds of
// the same loop: the code stays small, which a launch of a few thousand
// threads feels), so one long run holds its warp for ~1/32 of what one
// lane would take (kernel_probe.py's zipf case, config #2's events with
// Zipf keys, s = 0.99: 1,096 such runs among 733,875 at 1 lane a key,
// 0.038 ms on an H100 with the round, 0.109 without it).  No
// shared memory, barrier or atomic: kernel_probe.py measured two tiled
// forms (a block's run ends and rank span staged in shared memory, each
// thread walking its bytes and adding its keys' parts by 64-bit shared
// atomics) at ~0.042 ms at config #2, the barriers and staged ends ~0.019
// of it and the walk with its atomics ~0.024.  The old design (a warp a
// key: ~8 cells on 32 lanes) ran in ~124 rounds of warps at config #2.
#include "common.cuh"

#define LF_THREADS 256
#define LF_BATCH 2        // words a lane loads before adding any
#define LF_LONG_WORDS 32  // a run over this many words a lane: the warp's

// sum over the bytes [b0, b1) of the 16-byte word w of 2^-rank, each
// term built from its exponent bits (no transcendental, exact); four
// partial sums, one a 4-byte lane of the word, so the adds do not wait
// on each other
__device__ __forceinline__ double lf_word_sum(uint4 w, int b0, int b1) {
  const unsigned int c[4] = {w.x, w.y, w.z, w.w};
  double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const unsigned int r = (c[b >> 2] >> (8 * (b & 3))) & 0xFFu;
    if (static_cast<unsigned int>(b - b0) < static_cast<unsigned int>(b1 - b0))
      s[b >> 2] += __hiloint2double(static_cast<int>((1023u - r) << 20), 0);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// the words first, first + step, ... below b of ranks' memory, summed
// over the positions [lo, hi); LF_BATCH loads issued at a time
__device__ __forceinline__ double lf_run_sum(const uint4* __restrict__ words,
                                             int off, int first, int b,
                                             int step, int lo, int hi) {
  double s = 0.0;
  for (int w0 = first; w0 < b; w0 += LF_BATCH * step) {
    uint4 v[LF_BATCH];
#pragma unroll
    for (int i = 0; i < LF_BATCH; ++i)
      if (w0 + i * step < b) v[i] = __ldg(words + w0 + i * step);
#pragma unroll
    for (int i = 0; i < LF_BATCH; ++i) {
      const int p0 = ((w0 + i * step) << 4) - off;  // the word's first byte
      if (w0 + i * step < b) s += lf_word_sum(v[i], max(lo - p0, 0), min(hi - p0, 16));
    }
  }
  return s;
}

__global__ void __launch_bounds__(LF_THREADS)
hll_log_finish_kernel(const uint8_t* __restrict__ ranks,
                      const int32_t* __restrict__ ends, long long n_keys,
                      int group, int long_words, long long m, double alpha_m2,
                      const double* __restrict__ log_tab,
                      double* __restrict__ est,
                      double* __restrict__ inv_sum_out) {
  const long long key =
      (static_cast<long long>(blockIdx.x) * LF_THREADS + threadIdx.x) >> (__ffs(group) - 1);
  const int lane = threadIdx.x & 31, g = lane & (group - 1);
  int lo = 0, hi = 0;
  if (key < n_keys) {
    lo = key == 0 ? 0 : ends[key - 1];
    hi = ends[key];
  }
  // 16-byte words of memory: byte p of ranks is byte p + off of them
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(ranks) & 15);
  const uint4* words = reinterpret_cast<const uint4*>(ranks - off);
  const int words_of_run = hi > lo ? ((hi - 1 + off) >> 4) + 1 - ((lo + off) >> 4) : 0;
  const bool long_run = group < 32 && words_of_run > long_words * group;
  // round 0: each group sums its own run (a long one: nothing); then the
  // warp sums each long run, a word a lane, for its group's first lane
  unsigned int pending = __ballot_sync(0xFFFFFFFFu, long_run && g == 0);
  int l = long_run ? 0 : lo, h = long_run ? 0 : hi, step = group, src = -1;
  double s = 0.0;
  while (true) {
    const int a = (l + off) >> 4, b = h > l ? ((h - 1 + off) >> 4) + 1 : a;
    double part = lf_run_sum(words, off, a + (lane & (step - 1)), b, step, l, h);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      if (d < step) part += __shfl_xor_sync(0xFFFFFFFFu, part, d);
    if (src < 0 || lane == src) s = part;
    if (!pending) break;
    src = __ffs(pending) - 1;
    pending &= pending - 1;
    l = __shfl_sync(0xFFFFFFFFu, lo, src);
    h = __shfl_sync(0xFFFFFFFFu, hi, src);
    step = 32;
  }
  if (key >= n_keys || g != 0) return;

  const double mf = static_cast<double>(m);
  const long long present = static_cast<long long>(hi) - lo;
  // registers not present contribute 2^-0 = 1 each
  const double zeros = mf - static_cast<double>(present);
  const double inv_sum = zeros + s;
  double e = alpha_m2 / inv_sum;
  if (e <= 2.5 * mf && zeros > 0.0)
    e = mf * (__ldg(log_tab + m) - __ldg(log_tab + (m - present)));
  est[key] = e;
  if (inv_sum_out != nullptr) inv_sum_out[key] = inv_sum;
}

// the least power of two >= x, at most 32
static int lf_pow2_at_least(long long x) {
  int g = 1;
  while (g < 32 && g < x) g <<= 1;
  return g;
}

// lanes a key: the fewest with which a lane loads one 16-byte word of
// the mean run (n_cells / n_keys bytes from any byte: a word more)
// where the launch then holds a block an SM at most (small launches are
// bound by latency), else the fewest with which a lane loads at most
// LF_BATCH of them
static int lf_lanes_per_key(long long n_keys, long long n_cells) {
  const long long unit = 16 * n_keys;  // n_keys words
  const int one = lf_pow2_at_least((n_cells + 2 * unit - 1) / unit);
  if (n_keys * one <= static_cast<long long>(sm_count()) * LF_THREADS) return one;
  return lf_pow2_at_least((n_cells + unit + LF_BATCH * unit - 1) / (LF_BATCH * unit));
}

// group lanes a key (a power of two <= 32); runs over long_words words a
// lane go to the warp
static int lf_launch(const void* ranks, const void* ends, long long n_keys,
                     int group, int long_words, long long m, double alpha_m2,
                     const void* log_tab, void* est, void* inv_sum,
                     void* stream) {
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || long_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_keys > 0) {
    const long long blocks = (n_keys * group + LF_THREADS - 1) / LF_THREADS;
    hll_log_finish_kernel<<<static_cast<unsigned int>(blocks), LF_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ranks),
        static_cast<const int32_t*>(ends), n_keys, group, long_words, m,
        alpha_m2, static_cast<const double*>(log_tab),
        static_cast<double*>(est), static_cast<double*>(inv_sum));
  }
  return static_cast<int>(cudaGetLastError());
}

// n_cells is the length of ranks (the wrapper's MAX_CELLS at most); alpha_m2 is
// (alpha * m) * m in double; log_tab holds m + 1 doubles; inv_sum may be
// null.
extern "C" int ft_hll_log_finish(const void* ranks, const void* ends,
                                 long long n_keys, long long n_cells,
                                 long long m, double alpha_m2,
                                 const void* log_tab, void* est,
                                 void* inv_sum, void* stream) {
  const int group = n_keys > 0 ? lf_lanes_per_key(n_keys, n_cells) : 1;
  return lf_launch(ranks, ends, n_keys, group, LF_LONG_WORDS, m, alpha_m2,
                   log_tab, est, inv_sum, stream);
}
