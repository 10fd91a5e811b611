// The stable class partition shared by chain_route and shard_pack (sm_90a).
//
// n rows, each of one class in [0, nclass): a partition that keeps row
// order inside every class (np.argsort(class, kind="stable")), in three
// passes that the two kernels' launchers run in turn:
//
//   1. pt_count: one warp per tile of PT_TILE rows counts the rows of each
//      class (shared-memory counters; counting is order-free) and writes
//      counts[class * tiles + tile];
//   2. pt_scan: one block of PT_SCAN_THREADS threads scans counts in
//      class-major order: the exclusive prefix of (class, tile) is where
//      the tile's rows of that class start; starts[c] is the first
//      position of class c;
//   3. pt_scatter: one warp per tile again, walking its tile 32 rows a
//      step in row order.  In a step, __match_any_sync groups the lanes of
//      one class; a lane's rank is the number of lower lanes of its class
//      plus the rows of that class in earlier steps (a per-warp counter in
//      shared memory that the group's lowest lane advances).  Ranks follow
//      row order with no atomics, so the partition is stable.  Each row's
//      place goes to the caller's emitter, which moves what it moves.
//
// A class is whatever the caller's functor returns: chain_route's fused
// chain classes (channel, keep flag, and with row shards shard * nclass +
// class), shard_pack's (source * (S + 1) + target).  Both keep their own
// kernel names and call these device functions; the dynamic shared memory
// of the count and scatter kernels holds PT_WARPS * nclass ints.
#pragma once

#include "common.cuh"

#define PT_WARPS 4
#define PT_TILE 512
#define PT_THREADS (PT_WARPS * 32)
#define PT_SCAN_THREADS 1024

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

static inline long long pt_tiles(long long n) {
  return (n + PT_TILE - 1) / PT_TILE;
}

static inline unsigned int pt_blocks(long long tiles) {
  return static_cast<unsigned int>((tiles + PT_WARPS - 1) / PT_WARPS);
}

static inline size_t pt_shmem(int nclass) {
  return static_cast<size_t>(PT_WARPS) * nclass * sizeof(int);
}

// Copies one element of `width` bytes: src[i] -> dst[d], in elements.
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

// Pass 1, for the warp's tile; s_count: the block's dynamic shared memory.
template <class Classify>
__device__ __forceinline__ void pt_count(const Classify& class_of, long long n,
                                         int nclass, long long tiles,
                                         int* __restrict__ counts,
                                         int* s_count) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * PT_WARPS + warp;
  int* mine = s_count + warp * nclass;
  for (int c = lane; c < nclass; c += 32) mine[c] = 0;
  __syncwarp();
  if (tile >= tiles) return;  // uniform across the warp
  const long long base = tile * PT_TILE;
  for (int step = 0; step < PT_TILE / 32; ++step) {
    const long long i = base + step * 32 + lane;
    if (i < n) atomicAdd(&mine[class_of(i)], 1);
  }
  __syncwarp();
  for (int c = lane; c < nclass; c += 32)
    counts[static_cast<long long>(c) * tiles + tile] = mine[c];
}

// Pass 2, run by one block of PT_SCAN_THREADS threads: the exclusive
// prefix sums of counts[0, total) in order, total = nclass * tiles;
// starts[c] = the prefix at (c, tile 0).  warp_sums: PT_SCAN_THREADS / 32
// long longs of the block's shared memory.
__device__ __forceinline__ void pt_scan(const int* __restrict__ counts,
                                        long long total, long long tiles,
                                        int* __restrict__ offsets,
                                        long long* __restrict__ starts,
                                        long long* warp_sums) {
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const long long per = (total + PT_SCAN_THREADS - 1) / PT_SCAN_THREADS;
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

// Pass 3, for the warp's tile: emit(i, class, place) for every row i < n,
// in row order within a class; place = the row's position in the stable
// partition.  s_seen: the block's dynamic shared memory.
template <class Classify, class Emit>
__device__ __forceinline__ void pt_scatter(const Classify& class_of,
                                           const Emit& emit, long long n,
                                           int nclass, long long tiles,
                                           const int* __restrict__ offsets,
                                           int* s_seen) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * PT_WARPS + warp;
  int* seen = s_seen + warp * nclass;  // rows of each class in earlier steps
  for (int c = lane; c < nclass; c += 32) seen[c] = 0;
  __syncwarp();
  if (tile >= tiles) return;  // uniform across the warp
  const unsigned int lower = (1u << lane) - 1u;
  const long long base = tile * PT_TILE;
  for (int step = 0; step < PT_TILE / 32; ++step) {
    const long long i = base + step * 32 + lane;
    const bool valid = i < n;
    const int cls = valid ? class_of(i) : -1;
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, cls);
    int rank = 0;
    if (valid) rank = seen[cls] + __popc(peers & lower);
    __syncwarp();
    if (valid && (peers & lower) == 0) seen[cls] += __popc(peers);
    __syncwarp();
    if (valid)
      emit(i, cls,
           static_cast<long long>(offsets[static_cast<long long>(cls) * tiles + tile]) +
               rank);
  }
}
