// hll_update: HLL register scatter-max into a uint8 [C, m] register file.
//
// Replaces flink_tpu/streaming/vectorized.py make_masked_update ->
// flink_tpu/ops/sketches.py HyperLogLogAggregate.update (with
// ops/hashing.py hll_register_and_rank): per row, register = low p bits
// of the value hash's lo lane, rank = clz(hi) + 1, or both arrive
// precompressed from the host (rank uint8, register uint16/uint32);
// regs[slot, reg] = max(regs[slot, reg], rank).
//
// Bound on this card: bytes.  Each row reads 7 B of input (int32 slot,
// uint8 rank, uint16 register) and does one random read-modify-write of
// the 32-bit word that holds its register byte; the memory moves that
// word as a 32-byte sector each way, so a floor counted in sectors is
// about 2^20 x (7 + 64) B / 3.35 TB/s = 0.022 ms for 2^20 rows.
//
// Design.  Hopper has no byte atomics, so the max is an atomicCAS on the
// aligned 32-bit word holding the byte (rows are word-aligned because
// m >= 16).  What limits the kernel on an H100 SXM is the L2's CAS rate:
// 2^20 CAS take about 0.086 ms whether they hit or miss and whether they
// succeed or fail, while 2^20 word loads that hit the L2 take 0.04.  So
// a row should issue one CAS if it must write and none if it need not.
// Each thread takes R rows (8 while the grid still covers every SM
// twice, fewer for small batches), strided by the block so the input
// loads (streaming, so the registers keep the L2) coalesce.  The first
// row of each thread is the warp's sample: its word is loaded, and the
// warp counts how many of those words were empty.  Where at least 3 in 4
// were (early in a window, after a clear), the other rows issue their
// CAS at once, expecting an empty word: a row that wins costs one CAS and
// no load, and one that finds the word taken uses the value the CAS
// returned as its load.  Otherwise the other rows load their words
// first, and a row whose stored byte is already >= its rank issues no
// atomic: late in a window, when most rows change nothing, most rows
// cost one load.  A row that loses a CAS to another row retries from the
// word the CAS returned.  Addressing is 64-bit ((int64)slot * m + reg):
// at 1.25M slots x 4096 registers the file is 5.12e9 bytes, past 2^31.
// Rows at or beyond n and rank-0 rows write nothing, as the reference's
// mask drops them, and so do slots outside [0, C): -1 is the port's skip
// mark.  XLA's scatter would wrap a slot in [-C, -1] to s + C and drop
// only the rest; the reference's callers mask negative slots first
// (ops/slot_index.py).  Max is order-free, so the result is bit-equal
// to the reference.
#include "common.cuh"

#define HU_THREADS 256

// One row's target: the word holding its register byte, the byte's
// shift in it, and the rank (0: the row writes nothing).
struct HuRow {
  unsigned int* word;
  unsigned int shift;
  unsigned int rank;
};

struct HuRaw {
  const int32_t* slots;
  const uint32_t* hi;
  const uint32_t* lo;
  __device__ __forceinline__ void load(long long i, int& slot,
                                       unsigned int& rank,
                                       unsigned int& reg) const {
    slot = __ldcs(slots + i);
    rank = static_cast<unsigned int>(__clz(static_cast<int>(__ldcs(hi + i)))) + 1u;
    reg = __ldcs(lo + i);
  }
};

template <typename RegT>
struct HuCompressed {
  const int32_t* slots;
  const uint8_t* rank;
  const RegT* reg;
  __device__ __forceinline__ void load(long long i, int& slot,
                                       unsigned int& r,
                                       unsigned int& g) const {
    slot = __ldcs(slots + i);
    r = __ldcs(rank + i);
    g = static_cast<unsigned int>(__ldcs(reg + i));
  }
};

// Step 1: the targets of rows first, first + HU_THREADS, ... (R rows).
template <int R, typename Src>
__device__ __forceinline__ void hu_rows(const Src& src, uint8_t* regs,
                                        long long first, long long n,
                                        long long m, long long capacity,
                                        HuRow (&rows)[R]) {
  const unsigned int reg_mask = static_cast<unsigned int>(m - 1);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long i = first + static_cast<long long>(k) * HU_THREADS;
    int slot = 0;
    unsigned int rank = 0, reg = 0;
    if (i < n) src.load(i, slot, rank, reg);
    if (slot < 0 || slot >= capacity) rank = 0;
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        regs + (rank ? static_cast<long long>(slot) * m + (reg & reg_mask) : 0));
    rows[k].word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
    rows[k].shift = static_cast<unsigned int>(a & 3u) * 8u;
    rows[k].rank = rank;
  }
}

__device__ __forceinline__ unsigned int hu_set(unsigned int word,
                                               const HuRow& row) {
  return (word & ~(0xFFu << row.shift)) | (row.rank << row.shift);
}

__device__ __forceinline__ bool hu_below(unsigned int word, const HuRow& row) {
  return ((word >> row.shift) & 0xFFu) < row.rank;
}

// Retry a row's CAS from the word the last CAS returned until its byte
// is at least its rank.
__device__ __forceinline__ void hu_retry(const HuRow& row, unsigned int old) {
  while (hu_below(old, row)) {
    const unsigned int prev = atomicCAS(row.word, old, hu_set(old, row));
    if (prev == old) break;
    old = prev;
  }
}

// One CAS for each row whose byte, in the word old[k] it expects, is
// below its rank, all issued before the first retry.  A row that
// expected an empty word it did not find takes the word the CAS returned
// as its load.
template <int R>
__device__ __forceinline__ void hu_cas(const HuRow (&rows)[R],
                                       const unsigned int (&old)[R]) {
  unsigned int prev[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    prev[k] = old[k];
    if (rows[k].rank && hu_below(old[k], rows[k]))
      prev[k] = atomicCAS(rows[k].word, old[k], hu_set(old[k], rows[k]));
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (prev[k] != old[k]) hu_retry(rows[k], prev[k]);
}

template <int R, typename Src>
__global__ void __launch_bounds__(HU_THREADS)
hll_update_kernel(uint8_t* __restrict__ regs, Src src, long long n,
                  long long m, long long capacity) {
  const long long first =
      static_cast<long long>(blockIdx.x) * (HU_THREADS * R) + threadIdx.x;
  HuRow rows[R];
  hu_rows<R>(src, regs, first, n, m, capacity, rows);
  // the warp's first row each is the sample: if at least 3 in 4 of its
  // live rows found an empty word, the other rows try a CAS on an empty
  // word first; otherwise they load their words first
  unsigned int old[R];
  old[0] = rows[0].rank ? __ldcg(rows[0].word) : 0u;
  const unsigned int live = __ballot_sync(0xffffffffu, rows[0].rank != 0u);
  const unsigned int empty =
      __ballot_sync(0xffffffffu, rows[0].rank != 0u && old[0] == 0u);
  const bool cas_first = live != 0u && 4 * __popc(empty) >= 3 * __popc(live);
#pragma unroll
  for (int k = 1; k < R; ++k)
    old[k] = rows[k].rank && !cas_first ? __ldcg(rows[k].word) : 0u;
  hu_cas<R>(rows, old);
}

// Rows a thread: 8 while the grid still covers every SM twice.
static inline int hu_rows_per_thread(long long n) {
  const long long want = 2LL * sm_count();
  for (int r = 8; r > 1; r >>= 1)
    if ((n + HU_THREADS * r - 1) / (HU_THREADS * r) >= want) return r;
  return 1;
}

template <typename Src>
static void hu_launch(uint8_t* regs, const Src& src, long long n, long long m,
                      long long capacity, cudaStream_t s) {
  const int r = hu_rows_per_thread(n);
  const unsigned int grid =
      static_cast<unsigned int>((n + HU_THREADS * r - 1) / (HU_THREADS * r));
  switch (r) {
    case 8: hll_update_kernel<8, Src><<<grid, HU_THREADS, 0, s>>>(regs, src, n, m, capacity); break;
    case 4: hll_update_kernel<4, Src><<<grid, HU_THREADS, 0, s>>>(regs, src, n, m, capacity); break;
    case 2: hll_update_kernel<2, Src><<<grid, HU_THREADS, 0, s>>>(regs, src, n, m, capacity); break;
    default: hll_update_kernel<1, Src><<<grid, HU_THREADS, 0, s>>>(regs, src, n, m, capacity); break;
  }
}

extern "C" int ft_hll_update_raw(void* regs, const void* slots,
                                 const void* hi, const void* lo, long long n,
                                 long long m, long long capacity,
                                 void* stream) {
  if (n > 0) {
    const HuRaw src{static_cast<const int32_t*>(slots),
                    static_cast<const uint32_t*>(hi),
                    static_cast<const uint32_t*>(lo)};
    hu_launch(static_cast<uint8_t*>(regs), src, n, m, capacity,
              static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_hll_update_compressed(void* regs, const void* slots,
                                        const void* rank, const void* reg,
                                        int reg_bytes, long long n,
                                        long long m, long long capacity,
                                        void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint8_t* r = static_cast<uint8_t*>(regs);
    const int32_t* sl = static_cast<const int32_t*>(slots);
    const uint8_t* rk = static_cast<const uint8_t*>(rank);
    if (reg_bytes == 2) {
      const HuCompressed<uint16_t> src{sl, rk, static_cast<const uint16_t*>(reg)};
      hu_launch(r, src, n, m, capacity, s);
    } else if (reg_bytes == 4) {
      const HuCompressed<uint32_t> src{sl, rk, static_cast<const uint32_t*>(reg)};
      hu_launch(r, src, n, m, capacity, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
