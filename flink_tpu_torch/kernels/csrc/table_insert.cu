// table_insert: batched insert-or-lookup into the device hash table.
//
// Replaces flink_tpu/ops/device_table.py insert_or_lookup_impl and
// insert_or_lookup_regions_impl: a linear-probing open-addressing table
// of 64-bit keys stored as (hi, lo) uint32 lanes, with an occupancy byte
// per position (key (0, 0) is a valid user key, so no key value can
// mark a position empty).  Record i probes
//   pos = (fmix32(lo ^ hi * 0x9E3779B9) + p) mod 2^32 mod capacity
// or, with regions, region[i] * region_size + (... + p) mod 2^32 mod
// region_size, the JAX package's sequence bit for bit, for p = 0 ..
// max_probes - 1.  It resolves to the position holding its key, or
// claims the first empty one; a record that finds neither within
// max_probes positions gets slot -1 and adds one to the overflow
// counter on the device (no per-batch sync).  Rows i >= n, or with
// mask[i] == 0, are padding: slot -1, nothing inserted.
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
// lanes, and publishes full with a release (xor 3: busy -> full).
// Readers load the state word with acquire semantics, so a reader that
// sees full also sees the lanes written before the release, and no
// thread issues a fence.  A reader that sees busy waits until it reads
// full, then compares the lanes; so duplicates of one key in a batch
// all resolve to the position the first claimer took.  Which duplicate
// claims first, and so the table's layout, depends on thread timing:
// the wrapper's tests compare tables as key -> slot maps, not position
// by position.
//
// Bound on this card: bytes, scattered.  8 bytes of lanes read and 4 of
// slot written per record, plus about 9 bytes of table touched per
// probe (a 32-byte sector of each array in practice: the accesses are
// random).
//
// Design: a group of G lanes of a warp takes one record and reads G
// positions of its probe sequence at once (lane j position p0 + j);
// a vote over the group takes the first position, in probe order, that
// holds the key or is empty.  Positions before it hold other keys, and
// a full position stays full for the rest of the launch, so on a lost
// claim the group goes on from the position after it.  Four lanes: at
// half full and all hits they beat 1, 2, 8 and 16; where most records
// claim (an empty table, regions), one or two lanes are 10-15% faster
// (scripts/kernel_probe.py).
#include "common.cuh"

#define TI_GROUP 4
#define TI_THREADS 256

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

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_xor(unsigned int* p,
                                                unsigned int v) {
  asm volatile("red.release.gpu.global.xor.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned int state_of(unsigned int word,
                                                 unsigned int shift) {
  return (word >> shift) & 0xFFu;
}

// The word holding a position's state once that state is not busy
// (waits out a claim).
__device__ __forceinline__ unsigned int settled_word(const unsigned int* w,
                                                     unsigned int shift) {
  unsigned int word = ld_acquire(w);
  while (state_of(word, shift) == kBusy) {
    __nanosleep(32);
    word = ld_acquire(w);
  }
  return word;
}

// Claim an empty position, starting from the word last read: true if
// this thread took it and published the key; false if another claim
// got there first (the position is then busy or full, and the caller
// compares its lanes once it is full).
__device__ __forceinline__ bool try_claim(unsigned int* w, unsigned int shift,
                                          unsigned int old, uint32_t* key_hi,
                                          uint32_t* key_lo, long long pos,
                                          uint32_t hi, uint32_t lo) {
  while (state_of(old, shift) == kEmpty) {
    const unsigned int prev = atomicCAS(w, old, old | (kBusy << shift));
    if (prev == old) {
      key_hi[pos] = hi;
      key_lo[pos] = lo;
      red_release_xor(w, (kBusy ^ kFull) << shift);
      return true;
    }
    old = prev;
  }
  return false;
}

}  // namespace

template <int G>
__global__ void __launch_bounds__(TI_THREADS)
table_insert_kernel(uint32_t* key_hi, uint32_t* key_lo, uint8_t* occupied,
                    long long capacity, const uint32_t* __restrict__ h_hi,
                    const uint32_t* __restrict__ h_lo,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ region,
                    long long region_size, long long n, long long n_rows,
                    int max_probes, int32_t* __restrict__ slots,
                    unsigned long long* __restrict__ overflow) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 1, 2, 4, .. 32");
  const unsigned int lane = threadIdx.x & 31u;
  const unsigned int sub = lane & (G - 1u);
  const unsigned int first_lane = lane & ~(G - 1u);
  const unsigned int gmask =
      G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << first_lane;
  const long long stride = static_cast<long long>(gridDim.x) * (TI_THREADS / G);
  // i is uniform within a group: its lanes take every branch together
  // up to the vote
  for (long long i = (static_cast<long long>(blockIdx.x) * TI_THREADS +
                      threadIdx.x) / G;
       i < n_rows; i += stride) {
    if (i >= n || (mask != nullptr && mask[i] == 0)) {
      if (sub == 0) slots[i] = -1;
      continue;
    }
    const uint32_t hi = h_hi[i], lo = h_lo[i];
    const uint32_t base = fmix32(lo ^ (hi * 0x9E3779B9u));
    const uint32_t modulus = static_cast<uint32_t>(
        region != nullptr ? region_size : capacity);
    const long long offset =
        region != nullptr ? static_cast<long long>(region[i]) * region_size : 0;
    int32_t slot = -1;
    int p0 = 0;
    while (p0 < max_probes) {
      const int p = p0 + static_cast<int>(sub);
      bool stop = false, match = false;
      long long pos = 0;
      unsigned int shift = 0, word = 0;
      unsigned int* w = nullptr;
      if (p < max_probes) {
        pos = offset + static_cast<long long>(
                           (base + static_cast<uint32_t>(p)) % modulus);
        w = state_word(occupied, pos, shift);
        word = settled_word(w, shift);
        if (state_of(word, shift) == kEmpty) {
          stop = true;
        } else if (ld_relaxed(key_hi + pos) == hi &&
                   ld_relaxed(key_lo + pos) == lo) {
          stop = match = true;
        }
      }
      const unsigned int votes = __ballot_sync(gmask, stop) >> first_lane;
      if (votes == 0) {
        p0 += G;
        continue;
      }
      const int first = __ffs(votes) - 1;
      // the first stop either holds the key, or is empty: its lane
      // claims it, or compares the lanes of whoever claimed it first
      bool found = match;
      if (static_cast<int>(sub) == first && !match) {
        found = try_claim(w, shift, word, key_hi, key_lo, pos, hi, lo) ||
                (state_of(settled_word(w, shift), shift) == kFull &&
                 ld_relaxed(key_hi + pos) == hi &&
                 ld_relaxed(key_lo + pos) == lo);
      }
      if (__shfl_sync(gmask, found ? 1 : 0, first, G)) {
        slot = __shfl_sync(gmask, static_cast<int32_t>(pos), first, G);
        break;
      }
      p0 += first + 1;
    }
    if (sub == 0) {
      slots[i] = slot;
      if (slot < 0 && overflow != nullptr) atomicAdd(overflow, 1ULL);
    }
  }
}

template <int G>
static int launch_table_insert(void* key_hi, void* key_lo, void* occupied,
                               long long capacity, const void* h_hi,
                               const void* h_lo, const void* mask,
                               const void* region, long long region_size,
                               long long n, long long n_rows, int max_probes,
                               void* slots, void* overflow, void* stream) {
  if (n_rows > 0) {
    table_insert_kernel<G><<<grid_for(n_rows * G, TI_THREADS), TI_THREADS, 0,
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
  return launch_table_insert<TI_GROUP>(key_hi, key_lo, occupied, capacity,
                                       h_hi, h_lo, mask, region, region_size,
                                       n, n_rows, max_probes, slots, overflow,
                                       stream);
}
