// The tiled stable partition shared by chain_route and shard_pack (sm_90a).
//
// n rows lie in `parts` blocks of m rows (shard_pack's source shards,
// chain_route's row shards; one block of n rows without them), the last
// blocks possibly short or empty.  Every row has a class in [0, C) of its
// block.  The partition keeps row order inside every (block, class), as
// np.argsort(block * C + class, kind="stable") does, in three launches
// whose kernels live in the two .cu files and call these device
// functions:
//
//   1. classify: a block per tile of PT_TILE rows of ONE block of rows
//      (tiles never cross a block, also when m is not a multiple of
//      PT_TILE or is smaller than a tile, so a tile's classes are just the
//      C of its block) computes each row's class once, stores it as uint16
//      and counts the tile's rows per class (__match_any_sync groups, one
//      shared-memory add per group): pt_classify;
//   2. scan: a warp per (block, class) column scans its tiles' counts,
//      32 tiles a step: each tile's first rank in the column, and the
//      column's total (pt_scan_column);
//   3. scatter: a block per tile ranks its rows stably (pt_rank_tile: warp
//      w takes rows [w * 512, w * 512 + 512) of the tile in 16 steps of
//      32; ranks from __match_any_sync within a step, per-warp counters
//      across steps, a prefix over warps and classes across the block) and
//      keeps the tile's permutation in shared memory in class order; then
//      column by column consecutive threads write consecutive rows of a
//      class run (pt_move_staged: the tile's rows of the column are first
//      staged in shared memory by coalesced loads).
//
// Nothing walks the whole count table in one block: the table has
// parts * C columns of ceil(m / PT_TILE) tiles.
#pragma once

#include "common.cuh"

#define PT_THREADS 256
#define PT_WARPS (PT_THREADS / 32)
#define PT_ROWS 16                          // rows a thread ranks
#define PT_TILE (PT_THREADS * PT_ROWS)      // rows of a tile (4096)
#define PT_WARP_ROWS (PT_TILE / PT_WARPS)   // contiguous rows of a warp
#define PT_MAX_CLASSES 65535                // classes fit 16 bits

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

// The index in [0, n) of hash h's key group, (h % maxpar) * n / maxpar
// (KeyGroupRangeAssignment's range arithmetic), in 32-bit arithmetic when
// maxpar * n fits 32 bits (a 64-bit division is a long software routine
// on the card).
__device__ __forceinline__ int pt_key_group_index(unsigned int h,
                                                  unsigned long long maxpar,
                                                  unsigned int n) {
  if (maxpar * n <= 0xFFFFFFFFULL) {
    const unsigned int mp = static_cast<unsigned int>(maxpar);
    return static_cast<int>((h % mp) * n / mp);
  }
  const unsigned long long kg = h % maxpar;
  return static_cast<int>(kg * n / maxpar);
}

struct PtGeometry {
  long long n;        // rows in all
  long long m;        // rows of a block
  int parts;          // blocks
  int tps;            // tiles per block
  long long tiles;    // parts * tps
  int nclass;         // classes of a block (C)
};

static inline PtGeometry pt_geometry(long long n, long long m, int parts,
                                     int nclass) {
  PtGeometry g;
  g.n = n;
  g.m = m;
  g.parts = parts;
  g.tps = static_cast<int>((m + PT_TILE - 1) / PT_TILE);
  if (g.tps < 1) g.tps = 1;
  g.tiles = static_cast<long long>(parts) * g.tps;
  g.nclass = nclass;
  return g;
}

// The rows [row0, row0 + nrows) of tile `tile` (nrows may be 0: a tile of
// an empty block), its block and its index j in the block.
__device__ __forceinline__ void pt_tile_rows(const PtGeometry& g, long long tile,
                                             int* part, int* j, long long* row0,
                                             int* nrows) {
  *part = static_cast<int>(tile / g.tps);
  *j = static_cast<int>(tile - static_cast<long long>(*part) * g.tps);
  const long long first = static_cast<long long>(*j) * PT_TILE;
  *row0 = static_cast<long long>(*part) * g.m + first;
  long long left = g.m - first;
  if (g.n - *row0 < left) left = g.n - *row0;
  *nrows = static_cast<int>(left < 0 ? 0 : (left < PT_TILE ? left : PT_TILE));
}

// Exclusive prefix of v over the block's threads, in thread order.
// scratch: PT_WARPS ints of shared memory.
__device__ __forceinline__ int pt_block_exclusive(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < PT_WARPS ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, wi, off);
      if (lane >= off) wi += u;
    }
    if (lane < PT_WARPS) scratch[lane] = wi - w;
  }
  __syncthreads();
  const int out = scratch[warp] + incl - v;
  __syncthreads();  // scratch is free again
  return out;
}

// put(c, exclusive prefix of get(0 .. c)) for every c < C, each thread a
// contiguous range of classes.  Every thread of the block calls it.
template <class Get, class Put>
__device__ __forceinline__ void pt_exclusive_over(int C, const Get& get,
                                                  const Put& put, int* scratch) {
  const int per = (C + PT_THREADS - 1) / PT_THREADS;
  const int lo = threadIdx.x * per < C ? threadIdx.x * per : C;
  const int hi = lo + per < C ? lo + per : C;
  int local = 0;
  for (int c = lo; c < hi; ++c) local += get(c);
  int run = pt_block_exclusive(local, scratch);
  for (int c = lo; c < hi; ++c) {
    const int v = get(c);
    put(c, run);
    run += v;
  }
}

// 1. For the block's tile: each row's class (a class of the row's block in
// [0, C)) and the tile's count of the classes [0, ncount):
// counts[(part * ncount + c) * tps + j].  hist: C ints of shared memory.
// The classifier has two steps: load(row) reads the row's inputs into a
// Classify::Row, and classify(Row) computes the class; all PT_ROWS rows of
// a thread are loaded before the first is classified, so their loads are
// in flight together.
template <class Classify>
__device__ __forceinline__ void pt_classify(const Classify& class_of,
                                            const PtGeometry& g,
                                            unsigned short* __restrict__ cls,
                                            int* __restrict__ counts, int ncount,
                                            int* hist) {
  const int C = g.nclass;
  const int lane = threadIdx.x & 31;
  int part, j, nrows;
  long long row0;
  pt_tile_rows(g, blockIdx.x, &part, &j, &row0, &nrows);
  for (int c = threadIdx.x; c < C; c += PT_THREADS) hist[c] = 0;
  __syncthreads();
  const unsigned int lower = (1u << lane) - 1u;
  typename Classify::Row in[PT_ROWS];
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int r = k * PT_THREADS + threadIdx.x;
    if (r < nrows) in[k] = class_of.load(row0 + r);
  }
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int c = k * PT_THREADS + threadIdx.x < nrows ? class_of.classify(in[k]) : -1;
    if (c >= 0) cls[row0 + k * PT_THREADS + threadIdx.x] = static_cast<unsigned short>(c);
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, c);
    if (c >= 0 && (peers & lower) == 0) atomicAdd(&hist[c], __popc(peers));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncount; c += PT_THREADS)
    counts[(static_cast<long long>(part) * ncount + c) * g.tps + j] = hist[c];
}

// 2. Run by one warp for one column of tps tile counts: out[j] = the
// exclusive prefix of in[0 .. j]; returns the column's total (every lane).
__device__ __forceinline__ long long pt_scan_column(const int* __restrict__ in,
                                                    int* __restrict__ out, int tps) {
  const int lane = threadIdx.x & 31;
  long long carry = 0;
  for (int j0 = 0; j0 < tps; j0 += 32) {
    const int j = j0 + lane;
    const int v = j < tps ? in[j] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += u;
    }
    if (j < tps) out[j] = static_cast<int>(carry + incl - v);
    carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
  }
  return carry;
}

// Shared memory of a scatter block: stage | dbase[C] | sorted[PT_TILE] |
// seen[PT_WARPS][C] | tstart[C] | lim[C] | scratch[PT_WARPS].
struct PtShared {
  unsigned char* stage;    // stage_bytes per row of the tile
  long long* dbase;        // where sorted position p of class c goes: dbase[c] + p
  unsigned int* sorted;    // (class << 16) | row in the tile, in class order
  int* seen;
  int* tstart;             // first sorted position of class c
  int* lim;                // rows of class c, then the caller's write limit
  int* scratch;
};

static inline size_t pt_scatter_smem(int C, int stage_bytes) {
  return static_cast<size_t>(stage_bytes) * PT_TILE + sizeof(long long) * C +
         sizeof(unsigned int) * PT_TILE + sizeof(int) * (PT_WARPS * C + 2 * C) +
         sizeof(int) * PT_WARPS;
}

__device__ __forceinline__ PtShared pt_carve(unsigned char* smem, int C,
                                             int stage_bytes) {
  PtShared s;
  s.stage = smem;
  s.dbase = reinterpret_cast<long long*>(smem + static_cast<size_t>(stage_bytes) * PT_TILE);
  s.sorted = reinterpret_cast<unsigned int*>(s.dbase + C);
  s.seen = reinterpret_cast<int*>(s.sorted + PT_TILE);
  s.tstart = s.seen + PT_WARPS * C;
  s.lim = s.tstart + C;
  s.scratch = s.lim + C;
  return s;
}

// 3a. Rank the tile's nrows rows (classes cls[row0 ...]) stably: fills
// sh.sorted[0, nrows) in class order, sh.tstart[c] and sh.lim[c] = the
// tile's rows of class c.  Ends with the block synchronized.
__device__ __forceinline__ void pt_rank_tile(int C,
                                             const unsigned short* __restrict__ cls,
                                             long long row0, int nrows,
                                             const PtShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < PT_WARPS * C; c += PT_THREADS) sh.seen[c] = 0;
  __syncthreads();
  // rank each row among its warp's rows of its class, in row order
  int* mine = sh.seen + warp * C;
  const unsigned int lower = (1u << lane) - 1u;
  int cl[PT_ROWS], rank[PT_ROWS];
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int r = warp * PT_WARP_ROWS + k * 32 + lane;
    cl[k] = r < nrows ? static_cast<int>(cls[row0 + r]) : -1;
  }
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int c = cl[k];
    const unsigned int peers = __match_any_sync(0xFFFFFFFFu, c);
    rank[k] = c >= 0 ? mine[c] + __popc(peers & lower) : 0;
    __syncwarp();
    if (c >= 0 && (peers & lower) == 0) mine[c] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per class: each warp's base within the tile's run, the tile's count
  for (int c = threadIdx.x; c < C; c += PT_THREADS) {
    int run = 0;
    for (int w = 0; w < PT_WARPS; ++w) {
      const int v = sh.seen[w * C + c];
      sh.seen[w * C + c] = run;
      run += v;
    }
    sh.lim[c] = run;
  }
  __syncthreads();
  // the runs in class order: tstart = exclusive prefix of the counts
  pt_exclusive_over(
      C, [&](int c) { return sh.lim[c]; },
      [&](int c, int v) { sh.tstart[c] = v; }, sh.scratch);
  __syncthreads();
  // the tile's permutation, in class order
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int c = cl[k];
    if (c >= 0) {
      const int r = warp * PT_WARP_ROWS + k * 32 + lane;
      sh.sorted[sh.tstart[c] + sh.seen[warp * C + c] + rank[k]] =
          (static_cast<unsigned int>(c) << 16) | static_cast<unsigned int>(r);
    }
  }
  __syncthreads();
}

struct PtSame {
  template <typename T>
  __device__ __forceinline__ T operator()(T v) const { return v; }
};

// 3b. One column of rows of at most 8 bytes: stage the tile's rows in
// shared memory (coalesced), then write each class run with consecutive
// threads on consecutive rows: dst[dbase[c] + p] = f(row) for sorted
// position p < lim[c] (the caller sets dbase and lim per class).
template <typename T, class F = PtSame>
__device__ __forceinline__ void pt_move_staged(const unsigned char* src_b,
                                               unsigned char* dst_b, long long row0,
                                               int nrows, const PtShared& sh,
                                               const F& f = F()) {
  const T* src = reinterpret_cast<const T*>(src_b) + row0;
  T* dst = reinterpret_cast<T*>(dst_b);
  T* stage = reinterpret_cast<T*>(sh.stage);
  T v[PT_ROWS];
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int r = k * PT_THREADS + threadIdx.x;
    if (r < nrows) v[k] = src[r];
  }
#pragma unroll
  for (int k = 0; k < PT_ROWS; ++k) {
    const int r = k * PT_THREADS + threadIdx.x;
    if (r < nrows) stage[r] = v[k];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nrows; p += PT_THREADS) {
    const unsigned int e = sh.sorted[p];
    const int c = static_cast<int>(e >> 16);
    if (p < sh.lim[c]) dst[sh.dbase[c] + p] = f(stage[e & 0xFFFFu]);
  }
  __syncthreads();  // the stage is reused by the next column
}

// 3b for a column of 1, 2, 4 or 8-byte rows.
__device__ __forceinline__ void pt_move_width(const unsigned char* src,
                                              unsigned char* dst, int width,
                                              long long row0, int nrows,
                                              const PtShared& sh) {
  switch (width) {
    case 1: pt_move_staged<unsigned char>(src, dst, row0, nrows, sh); break;
    case 2: pt_move_staged<unsigned short>(src, dst, row0, nrows, sh); break;
    case 4: pt_move_staged<unsigned int>(src, dst, row0, nrows, sh); break;
    default: pt_move_staged<unsigned long long>(src, dst, row0, nrows, sh); break;
  }
}
