// chain_route: the fixed part of the fused chain program (sm_90a).
//
// Replaces the partition and gather of flink_tpu/streaming/chain_fusion.py
// _build_fn (`body` and `stable_order`, with _jnp_splitmix64 and
// _jnp_operator_indexes).  After the map/filter stages (user code, run as
// torch ops by the caller) every row has a keep flag; this kernel gives
// each row a class, partitions the rows stably by class and moves every
// kept row's columns to its place in the partition:
//
//   route mode  (key given, nclass = nch + 1):
//     h = splitmix64(uint64(key)); kg = fmix32(h & 0xFFFFFFFF) % maxpar;
//     class = keep ? kg * nch / maxpar : nch
//   plain mode  (no key, nclass = 2): class = keep ? 0 : 1
//   window mode: plain, plus pane = t - floor_mod(t - offset, slide) of
//     each kept row's timestamp
//
// The order inside every class is row order, so the result equals
// np.argsort(class, kind="stable") followed by a gather; starts[c] is the
// first position of class c (np.searchsorted of the sorted classes), and
// starts[nclass - 1] the count of kept rows.  Rows of the last class are
// dropped rows: they are counted, never moved.
//
// Three kernels, launched in turn by one C function:
//   1. chain_count: one warp per tile of CR_TILE rows counts the rows of
//      each class (shared-memory counters; counting is order-free) and
//      writes counts[class * tiles + tile];
//   2. chain_scan: one block scans counts in class-major order: the
//      exclusive prefix of (class, tile) is where the tile's rows of that
//      class start; it also writes starts[];
//   3. chain_scatter: one warp per tile again, walking its tile 32 rows a
//      step in row order.  In a step, __match_any_sync groups the lanes of
//      one class; a lane's rank is the number of lower lanes of its class
//      plus the rows of that class in earlier steps (a per-warp counter in
//      shared memory that the group's lowest lane advances).  Ranks follow
//      row order with no atomics, so the partition is stable.  The row
//      then writes its bytes for every column (1, 2, 4 or 8 bytes wide,
//      from a pointer/width table passed by value) and its pane start.
//      The table holds CR_MAX_COLS columns; more columns take further
//      chain_scatter launches of CR_MAX_COLS columns each, which rank the
//      rows again the same way.
//
// Bound on this card: bytes.  Each input row is read (key 8 bytes, keep 1,
// the columns) and each kept row written (the columns, pane 8), about 16 us
// at 3.35 TB/s for 2^20 rows of three int64 columns.  The design is
// simple, not fast: a warp walks its tile in 16 dependent steps, the key
// is read and hashed twice (count and scatter, instead of a class array),
// and the scan runs in one block.  Stores of a step land in up to nclass
// runs, each contiguous.
#include "common.cuh"

#define CR_MAX_COLS 16
#define CR_WARPS 4
#define CR_TILE 512
#define CR_THREADS (CR_WARPS * 32)
#define CR_SCAN_THREADS 1024

struct ColTable {
  const unsigned char* src[CR_MAX_COLS];
  unsigned char* dst[CR_MAX_COLS];
  int width[CR_MAX_COLS];
  int n;
};

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long z) {
  z += 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

__device__ __forceinline__ unsigned int fmix32(unsigned int h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The class of row i: nclass - 1 for a dropped row; in route mode the
// downstream channel of its key, else 0.
__device__ __forceinline__ int row_class(const long long* __restrict__ key,
                                         const unsigned char* __restrict__ keep,
                                         long long i, int nclass,
                                         unsigned long long maxpar) {
  const int drop = nclass - 1;
  if (!keep[i]) return drop;
  if (key == nullptr) return 0;
  const unsigned int h = fmix32(static_cast<unsigned int>(
      splitmix64(static_cast<unsigned long long>(key[i])) & 0xFFFFFFFFULL));
  const unsigned long long kg = h % maxpar;
  return static_cast<int>(kg * static_cast<unsigned long long>(drop) / maxpar);
}

__global__ void chain_count(const long long* __restrict__ key,
                            const unsigned char* __restrict__ keep,
                            long long n, int nclass, unsigned long long maxpar,
                            long long tiles, int* __restrict__ counts) {
  extern __shared__ int s_count[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * CR_WARPS + warp;
  int* mine = s_count + warp * nclass;
  for (int c = lane; c < nclass; c += 32) mine[c] = 0;
  __syncwarp();
  if (tile >= tiles) return;  // uniform across the warp
  const long long base = tile * CR_TILE;
  for (int step = 0; step < CR_TILE / 32; ++step) {
    const long long i = base + step * 32 + lane;
    if (i < n) atomicAdd(&mine[row_class(key, keep, i, nclass, maxpar)], 1);
  }
  __syncwarp();
  for (int c = lane; c < nclass; c += 32)
    counts[static_cast<long long>(c) * tiles + tile] = mine[c];
}

// One block: the exclusive prefix sums of counts[0, total) in order, where
// total = nclass * tiles; starts[c] = the prefix at (c, tile 0).
__global__ void chain_scan(const int* __restrict__ counts, long long total,
                           long long tiles, int* __restrict__ offsets,
                           long long* __restrict__ starts) {
  __shared__ long long warp_sums[CR_SCAN_THREADS / 32];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const long long per = (total + CR_SCAN_THREADS - 1) / CR_SCAN_THREADS;
  const long long lo = t * per;
  const long long hi = lo + per < total ? lo + per : total;
  long long mine = 0;
  for (long long j = lo; j < hi; ++j) mine += counts[j];
  long long incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = warp_sums[lane];
    long long wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long v = __shfl_up_sync(0xFFFFFFFFu, wi, off);
      if (lane >= off) wi += v;
    }
    __syncwarp();
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  long long run = warp_sums[warp] + incl - mine;
  for (long long j = lo; j < hi; ++j) {
    offsets[j] = static_cast<int>(run);
    if (j % tiles == 0) starts[j / tiles] = run;
    run += counts[j];
  }
}

__device__ __forceinline__ void move_bytes(const unsigned char* src,
                                           unsigned char* dst, int width,
                                           long long i, long long d) {
  switch (width) {
    case 1: dst[d] = src[i]; break;
    case 2:
      reinterpret_cast<uint16_t*>(dst)[d] =
          reinterpret_cast<const uint16_t*>(src)[i];
      break;
    case 4:
      reinterpret_cast<uint32_t*>(dst)[d] =
          reinterpret_cast<const uint32_t*>(src)[i];
      break;
    default:
      reinterpret_cast<unsigned long long*>(dst)[d] =
          reinterpret_cast<const unsigned long long*>(src)[i];
      break;
  }
}

__global__ void chain_scatter(const long long* __restrict__ key,
                              const unsigned char* __restrict__ keep,
                              long long n, int nclass,
                              unsigned long long maxpar, long long tiles,
                              const int* __restrict__ offsets, ColTable cols,
                              const long long* __restrict__ ts,
                              long long pane_offset, long long slide,
                              long long* __restrict__ pane) {
  extern __shared__ int s_seen[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * CR_WARPS + warp;
  int* seen = s_seen + warp * nclass;  // rows of each class in earlier steps
  for (int c = lane; c < nclass; c += 32) seen[c] = 0;
  __syncwarp();
  if (tile >= tiles) return;  // uniform across the warp
  const int drop = nclass - 1;
  const unsigned int lower = (1u << lane) - 1u;
  const long long base = tile * CR_TILE;
  for (int step = 0; step < CR_TILE / 32; ++step) {
    const long long i = base + step * 32 + lane;
    const bool valid = i < n;
    const int cls = valid ? row_class(key, keep, i, nclass, maxpar) : -1;
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, cls);
    const bool moves = valid && cls != drop;
    int rank = 0;
    if (moves) rank = seen[cls] + __popc(peers & lower);
    __syncwarp();
    if (moves && (peers & lower) == 0) seen[cls] += __popc(peers);
    __syncwarp();
    if (!moves) continue;
    const long long d =
        static_cast<long long>(offsets[static_cast<long long>(cls) * tiles + tile]) +
        rank;
    for (int j = 0; j < cols.n; ++j)
      move_bytes(cols.src[j], cols.dst[j], cols.width[j], i, d);
    if (pane != nullptr) {
      // numpy's floor modulo with int64 wrap-around: slide > 0
      const long long t = ts[i];
      const long long diff = static_cast<long long>(
          static_cast<unsigned long long>(t) -
          static_cast<unsigned long long>(pane_offset));
      long long r = diff % slide;
      if (r < 0) r += slide;
      pane[d] = static_cast<long long>(static_cast<unsigned long long>(t) -
                                       static_cast<unsigned long long>(r));
    }
  }
}

// Launches the three kernels on `stream` (chain_scatter once for each
// CR_MAX_COLS columns).  src_ptrs, dst_ptrs and widths are HOST arrays of
// ncols entries (copied into the kernel's parameters); key, ts and pane
// may be null.  Scratch: counts and offsets hold nclass * tiles ints,
// starts nclass long longs (tiles = ceil(n / 512)).
extern "C" int ft_chain_route(const void* key, const void* keep, long long n,
                              int nclass, long long max_parallelism,
                              const void* src_ptrs, const void* dst_ptrs,
                              const void* widths, int ncols, const void* ts,
                              long long pane_offset, long long slide,
                              void* pane, void* counts, void* offsets,
                              void* starts, void* stream) {
  if (n <= 0 || ncols < 0 || nclass < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* sp = static_cast<const long long*>(src_ptrs);
  const long long* dp = static_cast<const long long*>(dst_ptrs);
  const int* wp = static_cast<const int*>(widths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + CR_TILE - 1) / CR_TILE;
  const unsigned int blocks =
      static_cast<unsigned int>((tiles + CR_WARPS - 1) / CR_WARPS);
  const size_t shmem = static_cast<size_t>(CR_WARPS) * nclass * sizeof(int);
  const unsigned long long maxpar =
      max_parallelism > 0 ? static_cast<unsigned long long>(max_parallelism) : 1ULL;
  const long long* k = static_cast<const long long*>(key);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  chain_count<<<blocks, CR_THREADS, shmem, s>>>(k, kp, n, nclass, maxpar, tiles,
                                                static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_scan<<<1, CR_SCAN_THREADS, 0, s>>>(
      static_cast<const int*>(counts), static_cast<long long>(nclass) * tiles,
      tiles, static_cast<int*>(offsets), static_cast<long long*>(starts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the first launch also writes the panes (and runs with no columns)
  for (int j0 = 0; j0 == 0 || j0 < ncols; j0 += CR_MAX_COLS) {
    ColTable tab;
    tab.n = ncols - j0 < CR_MAX_COLS ? ncols - j0 : CR_MAX_COLS;
    for (int j = 0; j < CR_MAX_COLS; ++j) {
      const bool used = j < tab.n;
      tab.src[j] = used ? reinterpret_cast<const unsigned char*>(sp[j0 + j]) : nullptr;
      tab.dst[j] = used ? reinterpret_cast<unsigned char*>(dp[j0 + j]) : nullptr;
      tab.width[j] = used ? wp[j0 + j] : 0;
    }
    chain_scatter<<<blocks, CR_THREADS, shmem, s>>>(
        k, kp, n, nclass, maxpar, tiles, static_cast<const int*>(offsets), tab,
        static_cast<const long long*>(ts), pane_offset, slide,
        j0 == 0 ? static_cast<long long*>(pane) : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
