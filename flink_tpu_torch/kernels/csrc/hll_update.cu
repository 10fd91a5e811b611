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
// the 32-bit word that holds its register byte.
//
// Design: one thread per row over a grid-stride loop.  Hopper has no
// byte atomics, so the max is an atomicCAS loop on the aligned 32-bit
// word holding the byte (rows are word-aligned because m >= 16), and a
// thread whose stored byte is already >= its rank exits without an
// atomic: late in a window most rows change nothing, so most rows cost
// one load.  Addressing is 64-bit ((int64)slot * m + reg): at 1.25M
// slots x 4096 registers the file is 5.12e9 bytes, past 2^31.  Rows at
// or beyond n, rank-0 rows and slots outside [0, C) write nothing, as
// the reference's mask and XLA's out-of-bounds scatter drop them.
// Max is order-free, so the result is bit-equal to the reference.
#include "common.cuh"

__device__ __forceinline__ void byte_max(uint8_t* p, unsigned int v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
  const unsigned int shift = static_cast<unsigned int>(a & 3u) * 8u;
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
  while (((old >> shift) & 0xFFu) < v) {
    const unsigned int next = (old & ~(0xFFu << shift)) | (v << shift);
    const unsigned int prev = atomicCAS(word, old, next);
    if (prev == old) break;
    old = prev;
  }
}

__global__ void hll_update_raw_kernel(uint8_t* __restrict__ regs,
                                      const int32_t* __restrict__ slots,
                                      const uint32_t* __restrict__ hi,
                                      const uint32_t* __restrict__ lo,
                                      long long n, long long m,
                                      long long capacity) {
  const uint32_t reg_mask = static_cast<uint32_t>(m - 1);
  FT_GRID_STRIDE(i, n) {
    const long long slot = slots[i];
    if (slot < 0 || slot >= capacity) continue;
    const unsigned int rank =
        static_cast<unsigned int>(__clz(static_cast<int>(hi[i]))) + 1u;
    const long long reg = static_cast<long long>(lo[i] & reg_mask);
    byte_max(regs + slot * m + reg, rank);
  }
}

template <typename RegT>
__global__ void hll_update_compressed_kernel(uint8_t* __restrict__ regs,
                                             const int32_t* __restrict__ slots,
                                             const uint8_t* __restrict__ rank,
                                             const RegT* __restrict__ reg,
                                             long long n, long long m,
                                             long long capacity) {
  const uint32_t reg_mask = static_cast<uint32_t>(m - 1);
  FT_GRID_STRIDE(i, n) {
    const unsigned int r = rank[i];
    if (r == 0) continue;
    const long long slot = slots[i];
    if (slot < 0 || slot >= capacity) continue;
    const long long g =
        static_cast<long long>(static_cast<uint32_t>(reg[i]) & reg_mask);
    byte_max(regs + slot * m + g, r);
  }
}

extern "C" int ft_hll_update_raw(void* regs, const void* slots,
                                 const void* hi, const void* lo, long long n,
                                 long long m, long long capacity,
                                 void* stream) {
  if (n > 0) {
    const int threads = 256;
    hll_update_raw_kernel<<<grid_for(n, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(regs), static_cast<const int32_t*>(slots),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        n, m, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_hll_update_compressed(void* regs, const void* slots,
                                        const void* rank, const void* reg,
                                        int reg_bytes, long long n,
                                        long long m, long long capacity,
                                        void* stream) {
  if (n > 0) {
    const int threads = 256;
    const unsigned int grid = grid_for(n, threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (reg_bytes == 2) {
      hll_update_compressed_kernel<uint16_t><<<grid, threads, 0, s>>>(
          static_cast<uint8_t*>(regs), static_cast<const int32_t*>(slots),
          static_cast<const uint8_t*>(rank),
          static_cast<const uint16_t*>(reg), n, m, capacity);
    } else if (reg_bytes == 4) {
      hll_update_compressed_kernel<uint32_t><<<grid, threads, 0, s>>>(
          static_cast<uint8_t*>(regs), static_cast<const int32_t*>(slots),
          static_cast<const uint8_t*>(rank),
          static_cast<const uint32_t*>(reg), n, m, capacity);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
