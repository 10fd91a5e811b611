// clear_rows: fill rows of one [C, row_bytes] state component with a
// fill bit pattern, either the rows of a slot list or a contiguous
// range [start, start + count).
//
// Replaces flink_tpu/streaming/vectorized.py _jit_clear, _clear_contig
// and the full re-init after a full-arena fire, and
// flink_tpu/ops/device_agg.py clear_slots / init_state / grow_state's
// fill: every row gets spec.fill (0 for registers and sums, finfo.max /
// finfo.min for Min / Max).  The JAX engine drops and reallocates the
// whole register file after a full fire; the port clears it in place.
//
// Bound on this card: bytes written (count * row_bytes, plus 4 B per
// listed slot read).  A pure store stream reaches the bound only with
// enough 16-byte stores in flight and next to nothing else per store.
//
// Range form.  The range is one run of bytes: its head up to the first
// 16-byte boundary and its tail after the last one (each < 16 B) are
// written once by block 0, byte by byte; the body goes in 16-byte
// stores.  Each block owns a chunk of 32 KiB (2048 stores): a thread
// issues its 8 stores of the chunk back to back at 32-bit offsets inside
// it, so a store costs one instruction and no index arithmetic.  The grid
// has a block per chunk: on an H100 SXM (700 W) that cleared 5.12 GB in
// 1.555 ms against 1.577 for 8 blocks an SM walking the chunks, the same
// kernel with streaming stores, and TMA bulk stores from a shared-memory
// copy of the fill (scripts/kernel_probe.py).
//
// List form.  A warp takes the listed rows in batches of 32: each lane
// loads one slot (one coalesced load a batch), and a group of G lanes
// (G = 1..32, the largest power of two not above the row's words) takes
// one row at a time, its slot broadcast with __shfl_sync.  The lanes
// then store the row's words with no division: a 4,096-byte HLL row is
// 8 16-byte stores a lane, a [C] float32 row one store by one thread.
// The grid is capped at 8 blocks an SM.  Rows of 8 KiB or more, and rows
// of 64 words or more in a list shorter than that grid's warps (the
// session path's few dozen 4 KiB rows), go a block a row instead, so a
// short list still spreads over the card.  Slots outside [0, C) are
// skipped (-1 is the port's skip mark; ops/slot_index.py).  On an H100
// SXM (700 W) 2^18 random 4 KiB rows of a 5.12 GB
// file take 0.347 ms, 92% of the bound, and the same slots sorted 0.325,
// 99%: what the rest costs is the rows' random order over the file, not
// the stores (scripts/kernel_probe.py).
//
// The fill arrives widened by the wrapper to W bytes (W in 1, 2, 4, 8,
// 16: the widest store that the row, the element pattern and the base's
// alignment allow); the range form repeats it to 16 bytes, which keeps
// its phase at any 16-byte boundary because the range starts on an
// element and W divides 16.
#include "common.cuh"

#define CR_THREADS 256
#define CR_CHUNK (8 * CR_THREADS)          // 16-byte stores a chunk
#define CR_BLOCKS_PER_SM 8
#define CR_BLOCK_ROW_BYTES 8192            // a row this wide takes a block

// byte k (0..15) of a 16-byte word
__device__ __forceinline__ unsigned char cr_byte(uint4 f, unsigned int k) {
  const unsigned int w = k < 8 ? (k < 4 ? f.x : f.y) : (k < 12 ? f.z : f.w);
  return static_cast<unsigned char>(w >> ((k & 3u) * 8u));
}

__global__ void __launch_bounds__(CR_THREADS)
clear_range_kernel(uint4* __restrict__ body, long long body_words,
                   unsigned char* head, int head_bytes, unsigned char* tail,
                   int tail_bytes, uint4 fill) {
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int t = threadIdx.x & 15;
    unsigned char* p = threadIdx.x < 16 ? head : tail;
    if (t < (threadIdx.x < 16 ? head_bytes : tail_bytes))
      p[t] = cr_byte(fill, static_cast<unsigned int>(
                               reinterpret_cast<uintptr_t>(p + t) & 15u));
  }
  const long long chunks = (body_words + CR_CHUNK - 1) / CR_CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    uint4* p = body + c * CR_CHUNK;
    const long long left = body_words - c * CR_CHUNK;
    if (left >= CR_CHUNK) {
#pragma unroll
      for (int k = 0; k < CR_CHUNK / CR_THREADS; ++k)
        p[threadIdx.x + k * CR_THREADS] = fill;
    } else {
      for (int i = threadIdx.x; i < static_cast<int>(left); i += CR_THREADS)
        p[i] = fill;
    }
  }
}

// A warp takes batches of 32 listed rows: each lane loads one slot of
// the batch, then the batch goes in G steps, each group of
// G = 1 << group_log2 lanes taking one row per step, its slot broadcast
// from the lane that loaded it.
template <typename W>
__global__ void __launch_bounds__(CR_THREADS)
clear_list_warp_kernel(W* __restrict__ base, const int32_t* __restrict__ slots,
                       long long nslots, int row_words, int group_log2,
                       long long capacity, W fill) {
  const int lane = threadIdx.x & 31;
  const int g = 1 << group_log2;
  const int sub = lane & (g - 1);
  const int group = lane >> group_log2;
  const long long batches = (nslots + 31) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * (CR_THREADS / 32);
  for (long long b = (static_cast<long long>(blockIdx.x) * CR_THREADS + threadIdx.x) / 32;
       b < batches; b += warps) {
    const long long r = b * 32 + lane;
    const int mine = r < nslots ? slots[r] : -1;
    for (int step = 0; step < g; ++step) {
      const int slot = __shfl_sync(0xffffffffu, mine, (step << (5 - group_log2)) + group);
      if (slot < 0 || slot >= capacity) continue;
      W* row = base + static_cast<long long>(slot) * row_words;
#pragma unroll 8
      for (int w = sub; w < row_words; w += g) row[w] = fill;
    }
  }
}

// A block a listed row: every thread loads the row's slot (one address a
// warp) and stores every CR_THREADS-th word of the row.
template <typename W>
__global__ void __launch_bounds__(CR_THREADS)
clear_list_block_kernel(W* __restrict__ base, const int32_t* __restrict__ slots,
                        long long nslots, int row_words, long long capacity,
                        W fill) {
  for (long long r = blockIdx.x; r < nslots; r += gridDim.x) {
    const int slot = slots[r];
    if (slot < 0 || slot >= capacity) continue;
    W* row = base + static_cast<long long>(slot) * row_words;
#pragma unroll 8
    for (int w = threadIdx.x; w < row_words; w += CR_THREADS) row[w] = fill;
  }
}

template <typename W>
static W cr_narrow(uint4 f);
template <>
uint8_t cr_narrow<uint8_t>(uint4 f) { return static_cast<uint8_t>(f.x); }
template <>
uint16_t cr_narrow<uint16_t>(uint4 f) { return static_cast<uint16_t>(f.x); }
template <>
uint32_t cr_narrow<uint32_t>(uint4 f) { return f.x; }
template <>
unsigned long long cr_narrow<unsigned long long>(uint4 f) {
  return (static_cast<unsigned long long>(f.y) << 32) | f.x;
}
template <>
uint4 cr_narrow<uint4>(uint4 f) { return f; }

template <typename W>
static void launch_list(void* base, const int32_t* slots, long long nslots,
                        long long row_words, long long capacity, uint4 f,
                        cudaStream_t s) {
  W* b = static_cast<W*>(base);
  const W fill = cr_narrow<W>(f);
  const int words = static_cast<int>(row_words);
  // a block a row for wide rows, and for rows of 64 words or more in a
  // list shorter than the warp grid's warps
  const long long warps = static_cast<long long>(sm_count()) * CR_BLOCKS_PER_SM *
                          (CR_THREADS / 32);
  if (row_words * static_cast<long long>(sizeof(W)) >= CR_BLOCK_ROW_BYTES ||
      (row_words >= 64 && nslots < warps)) {
    const long long blocks = nslots < (1LL << 31) - 1 ? nslots : (1LL << 31) - 1;
    clear_list_block_kernel<W><<<static_cast<unsigned int>(blocks),
                                 CR_THREADS, 0, s>>>(b, slots, nslots, words,
                                                     capacity, fill);
    return;
  }
  int group_log2 = 0;
  while (group_log2 < 5 && (2LL << group_log2) <= row_words) ++group_log2;
  long long blocks = (nslots + CR_THREADS - 1) / CR_THREADS;   // a warp per 32 rows
  const long long cap = warps / (CR_THREADS / 32);
  if (blocks > cap) blocks = cap;
  clear_list_warp_kernel<W><<<static_cast<unsigned int>(blocks), CR_THREADS,
                              0, s>>>(b, slots, nslots, words, group_log2,
                                      capacity, fill);
}

static void launch_range(void* base, long long start, long long count,
                         long long row_bytes, uint4 f, cudaStream_t s) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base) + start * row_bytes;
  const uintptr_t end = p + count * row_bytes;
  // [p, a) head, [a, z) body of whole 16-byte words, [z, end) tail
  uintptr_t a = (p + 15) & ~uintptr_t(15);
  uintptr_t z = end & ~uintptr_t(15);
  if (a > end) a = end;         // the range lies inside one word
  if (z < a) z = a;
  const long long body_words = static_cast<long long>((z - a) / 16);
  long long blocks = (body_words + CR_CHUNK - 1) / CR_CHUNK;   // a block a chunk
  if (blocks > (1LL << 31) - 1) blocks = (1LL << 31) - 1;
  if (blocks < 1) blocks = 1;
  clear_range_kernel<<<static_cast<unsigned int>(blocks), CR_THREADS, 0, s>>>(
      reinterpret_cast<uint4*>(a), body_words,
      reinterpret_cast<unsigned char*>(p), static_cast<int>(a - p),
      reinterpret_cast<unsigned char*>(z), static_cast<int>(end - z), f);
}

// width: bytes per store (1, 2, 4, 8 or 16); the fill pattern is the
// little-endian bytes of (fill_lo, fill_hi) truncated to width.
// slots == nullptr selects the range form (start, count).  Rows must be
// fewer than 2^31 words.
extern "C" int ft_clear_rows(void* base, const void* slots, long long nslots,
                             long long start, long long count,
                             long long row_words, long long capacity,
                             int width, unsigned long long fill_lo,
                             unsigned long long fill_hi, void* stream) {
  if (width != 1 && width != 2 && width != 4 && width != 8 && width != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_words >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long work = slots != nullptr ? nslots : count;
  if (work > 0 && row_words > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the fill repeated to 16 bytes
    unsigned char in[16], rep[16];
    for (int i = 0; i < 8; ++i) {
      in[i] = static_cast<unsigned char>(fill_lo >> (8 * i));
      in[8 + i] = static_cast<unsigned char>(fill_hi >> (8 * i));
    }
    for (int i = 0; i < 16; ++i) rep[i] = in[i % width];
    uint4 f;
    f.x = rep[0] | rep[1] << 8 | rep[2] << 16 | static_cast<unsigned int>(rep[3]) << 24;
    f.y = rep[4] | rep[5] << 8 | rep[6] << 16 | static_cast<unsigned int>(rep[7]) << 24;
    f.z = rep[8] | rep[9] << 8 | rep[10] << 16 | static_cast<unsigned int>(rep[11]) << 24;
    f.w = rep[12] | rep[13] << 8 | rep[14] << 16 | static_cast<unsigned int>(rep[15]) << 24;
    if (slots == nullptr) {
      launch_range(base, start, count, row_words * width, f, s);
    } else {
      const int32_t* sl = static_cast<const int32_t*>(slots);
      switch (width) {
        case 1: launch_list<uint8_t>(base, sl, nslots, row_words, capacity, f, s); break;
        case 2: launch_list<uint16_t>(base, sl, nslots, row_words, capacity, f, s); break;
        case 4: launch_list<uint32_t>(base, sl, nslots, row_words, capacity, f, s); break;
        case 8: launch_list<unsigned long long>(base, sl, nslots, row_words, capacity, f, s); break;
        default: launch_list<uint4>(base, sl, nslots, row_words, capacity, f, s); break;
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
