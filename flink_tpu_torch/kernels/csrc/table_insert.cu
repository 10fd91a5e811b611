// table_insert: batched insert-or-lookup into the device hash table.
//
// Replaces flink_tpu/ops/device_table.py insert_or_lookup_impl and
// insert_or_lookup_regions_impl: a linear-probing open-addressing table
// of 64-bit keys stored as (hi, lo) uint32 lanes, with an occupancy byte
// per position (key (0, 0) is a valid user key, so no key value can
// mark a position empty).  Record i probes
//   pos = (fmix32(lo ^ hi * 0x9E3779B9) + p) mod 2^32 mod capacity
// or, with regions, region[i] * region_size + (... + p) mod region_size,
// the JAX package's sequence bit for bit, for p = 0 .. max_probes - 1.
// It resolves to the position holding its key, or claims the first
// empty one; a record that finds neither within max_probes positions
// gets slot -1 and adds one to the overflow counter on the device (no
// per-batch sync).  Rows i >= n, or with mask[i] == 0, are padding:
// slot -1, nothing inserted.
//
// max_probes bounds probe POSITIONS here.  In the JAX package it
// bounds claim ROUNDS (a loser of a claim re-checks the same position
// without advancing), so near overflow the two may disagree on which
// keys overflow; both report every overflow and resolve at most
// capacity keys.
//
// Claim protocol: the occupancy byte is a state, 0 empty, 2 busy,
// 1 full.  A thread claims an empty position with a compare-and-swap
// of the 32-bit word holding its byte (empty -> busy), writes the key
// lanes, fences, and publishes full (xor 3: busy -> full).  A thread
// that reads busy waits until it reads full, then compares the lanes;
// so duplicates of one key in a batch all resolve to the position the
// first claimer took.  Which duplicate claims first, and so the table's
// layout, depends on thread timing: the wrapper's tests compare tables
// as key -> slot maps, not position by position.
//
// Bound on this card: bytes, scattered.  8 bytes of lanes read and 4 of
// slot written per record, plus about 12 bytes of table touched per
// probe (a 32-byte sector each in practice: the accesses are random).
// Design: one thread per record, a grid-stride loop; the table arrays
// are not __restrict__ and are read with volatile loads, so a key that
// another thread published is seen.
#include "common.cuh"

namespace {

constexpr unsigned int kEmpty = 0u, kFull = 1u, kBusy = 2u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned int* state_word(uint8_t* occ,
                                                    long long pos,
                                                    unsigned int& shift) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(occ + pos);
  shift = static_cast<unsigned int>(a & 3u) * 8u;
  return reinterpret_cast<unsigned int*>(a & ~static_cast<uintptr_t>(3));
}

__device__ __forceinline__ unsigned int read_state(const unsigned int* w,
                                                   unsigned int shift) {
  return (*reinterpret_cast<const volatile unsigned int*>(w) >> shift) & 0xFFu;
}

}  // namespace

__global__ void table_insert_kernel(uint32_t* key_hi, uint32_t* key_lo,
                                    uint8_t* occupied,
                                    long long capacity,
                                    const uint32_t* __restrict__ h_hi,
                                    const uint32_t* __restrict__ h_lo,
                                    const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ region,
                                    long long region_size, long long n,
                                    long long n_rows, int max_probes,
                                    int32_t* __restrict__ slots,
                                    unsigned long long* __restrict__ overflow) {
  FT_GRID_STRIDE(i, n_rows) {
    if (i >= n || (mask != nullptr && mask[i] == 0)) {
      slots[i] = -1;
      continue;
    }
    const uint32_t hi = h_hi[i], lo = h_lo[i];
    const uint32_t base = fmix32(lo ^ (hi * 0x9E3779B9u));
    const uint32_t modulus = static_cast<uint32_t>(
        region != nullptr ? region_size : capacity);
    const long long offset =
        region != nullptr ? static_cast<long long>(region[i]) * region_size : 0;
    int32_t slot = -1;
    for (int p = 0; p < max_probes; ++p) {
      const long long pos =
          offset + static_cast<long long>((base + static_cast<uint32_t>(p))
                                          % modulus);
      unsigned int shift;
      unsigned int* w = state_word(occupied, pos, shift);
      unsigned int old = *reinterpret_cast<volatile unsigned int*>(w);
      while (((old >> shift) & 0xFFu) == kEmpty) {
        const unsigned int prev = atomicCAS(w, old, old | (kBusy << shift));
        if (prev == old) {
          key_hi[pos] = hi;
          key_lo[pos] = lo;
          __threadfence();
          atomicXor(w, (kBusy ^ kFull) << shift);
          slot = static_cast<int32_t>(pos);
          break;
        }
        old = prev;
      }
      if (slot >= 0) break;
      while (read_state(w, shift) == kBusy) __nanosleep(32);
      __threadfence();
      if (*reinterpret_cast<volatile uint32_t*>(key_hi + pos) == hi &&
          *reinterpret_cast<volatile uint32_t*>(key_lo + pos) == lo) {
        slot = static_cast<int32_t>(pos);
        break;
      }
    }
    slots[i] = slot;
    if (slot < 0 && overflow != nullptr) atomicAdd(overflow, 1ULL);
  }
}

// key_hi, key_lo: uint32 [capacity]; occupied: uint8 [capacity] whose
// allocation covers the last 32-bit word (capacity rounded up to 4) and
// starts 4-byte aligned; mask (uint8 [n_rows]), region (int32
// [n_rows]) and overflow (uint64 [1]) may be null.
extern "C" int ft_table_insert(void* key_hi, void* key_lo, void* occupied,
                               long long capacity, const void* h_hi,
                               const void* h_lo, const void* mask,
                               const void* region, long long region_size,
                               long long n, long long n_rows, int max_probes,
                               void* slots, void* overflow, void* stream) {
  if (n_rows > 0) {
    const int threads = 256;
    table_insert_kernel<<<grid_for(n_rows, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(key_hi), static_cast<uint32_t*>(key_lo),
        static_cast<uint8_t*>(occupied), capacity,
        static_cast<const uint32_t*>(h_hi), static_cast<const uint32_t*>(h_lo),
        static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(region),
        region_size, n, n_rows, max_probes, static_cast<int32_t*>(slots),
        static_cast<unsigned long long*>(overflow));
  }
  return static_cast<int>(cudaGetLastError());
}
