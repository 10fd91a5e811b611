// chain_route: the fixed part of the fused chain program (sm_90a).
//
// Replaces the partition and gather of flink_tpu/streaming/chain_fusion.py
// _build_fn (`body` and `stable_order`, with _jnp_splitmix64 and
// _jnp_operator_indexes) and, with row shards, its mesh leg `shard_body`
// (:832-849).  After the map/filter stages (user code, run as torch ops by
// the caller) every row has a keep flag; this kernel gives each row a
// class, partitions the rows stably by class and moves every kept row's
// columns to its place in the partition:
//
//   route mode  (key given, nclass = nch + 1):
//     h = splitmix64(uint64(key)); kg = fmix32(h & 0xFFFFFFFF) % maxpar;
//     class = keep ? kg * nch / maxpar : nch
//   plain mode  (no key, nclass = 2): class = keep ? 0 : 1
//   window mode: plain, plus pane = t - floor_mod(t - offset, slide) of
//     each kept row's timestamp
//   row shards  (shard_rows > 0, the mesh leg): row i belongs to shard
//     i / shard_rows and its class becomes shard * nclass + class, so one
//     launch partitions every shard's block on its own: shard s's rows
//     fill positions [s * shard_rows, ...) with its kept rows first, class
//     by class, and its dropped rows' places after them left unwritten.
//
// The order inside every class is row order, so the result equals
// np.argsort(class, kind="stable") followed by a gather; starts[c] is the
// first position of class c (np.searchsorted of the sorted classes).
// Rows of a shard's last class are dropped rows: counted, never moved.
//
// Bound on this card: bytes.  Each input row is read (key 8 bytes, keep 1,
// the columns) and each kept row written (the columns, pane 8), about 14 us
// at 3.35 TB/s for 2^20 rows of three int64 columns.
//
// Design: partition.cuh's tiled partition, with a row shard as its block
// of rows (one block of n rows without shards).  Three launches:
//   1. chain_classify: a block per 4096-row tile hashes each row's key
//      once, stores the class (of its shard) as uint16 and counts the
//      tile's rows per class;
//   2. chain_scan: a warp per (shard, class) column scans its tiles;
//   3. chain_scatter: a block per tile ranks its rows stably in shared
//      memory, takes one exclusive prefix of its shard's class totals (at
//      most 2048) for the class starts (tile 0 of each shard writes them to
//      `starts`), and writes each class run with consecutive threads on
//      consecutive rows, column by column, then the panes.
// A launch of the scatter moves up to CR_MAX_COLS columns; more columns
// take further scatter launches, which rank the tile again from the
// stored classes (no second hash).  At 2048 classes the scatter's shared
// memory is ~144 KB (set with cudaFuncSetAttribute).
#include "partition.cuh"

#define CR_MAX_COLS 16

struct ColTable {
  const unsigned char* src[CR_MAX_COLS];
  unsigned char* dst[CR_MAX_COLS];
  int width[CR_MAX_COLS];
  int n;
};

// The class of a row in its shard: nclass - 1 for a dropped row; in route
// mode the downstream channel of its key, else 0.
struct ChainClass {
  const long long* key;
  const unsigned char* keep;
  int nclass;
  unsigned long long maxpar;

  struct Row {
    unsigned long long key;
    bool kept;
  };

  __device__ __forceinline__ Row load(long long i) const {
    Row r;
    r.kept = keep[i] != 0;
    r.key = key != nullptr ? static_cast<unsigned long long>(key[i]) : 0ULL;
    return r;
  }

  __device__ __forceinline__ int classify(const Row& r) const {
    const int drop = nclass - 1;
    if (!r.kept) return drop;
    if (key == nullptr) return 0;
    const unsigned int h =
        fmix32(static_cast<unsigned int>(splitmix64(r.key) & 0xFFFFFFFFULL));
    return pt_key_group_index(h, maxpar, static_cast<unsigned int>(drop));
  }
};

// numpy's floor modulo with int64 wrap-around: slide > 0
struct PaneStart {
  long long offset;
  long long slide;

  __device__ __forceinline__ long long operator()(long long t) const {
    const long long diff = static_cast<long long>(
        static_cast<unsigned long long>(t) - static_cast<unsigned long long>(offset));
    long long r = diff % slide;
    if (r < 0) r += slide;
    return static_cast<long long>(static_cast<unsigned long long>(t) -
                                  static_cast<unsigned long long>(r));
  }
};

__global__ void __launch_bounds__(PT_THREADS)
chain_classify(ChainClass class_of, PtGeometry g, unsigned short* __restrict__ cls,
               int* __restrict__ counts) {
  extern __shared__ int cr_hist[];  // C ints
  pt_classify(class_of, g, cls, counts, g.nclass, cr_hist);
}

__global__ void __launch_bounds__(PT_THREADS)
chain_scan(const int* __restrict__ counts, long long columns, int tps,
           int* __restrict__ offs, int* __restrict__ totals) {
  const long long col =
      static_cast<long long>(blockIdx.x) * PT_WARPS + (threadIdx.x >> 5);
  if (col >= columns) return;  // uniform across the warp
  const long long total = pt_scan_column(counts + col * tps, offs + col * tps, tps);
  if ((threadIdx.x & 31) == 0) totals[col] = static_cast<int>(total);
}

__global__ void __launch_bounds__(PT_THREADS)
chain_scatter(ColTable cols, const long long* __restrict__ ts, PaneStart pane_of,
              long long* __restrict__ pane, PtGeometry g,
              const unsigned short* __restrict__ cls, const int* __restrict__ offs,
              const int* __restrict__ totals, long long* __restrict__ starts,
              int stage_bytes) {
  extern __shared__ __align__(16) unsigned char cr_smem[];
  const int C = g.nclass;
  const PtShared sh = pt_carve(cr_smem, C, stage_bytes);
  int part, j, nrows;
  long long row0;
  pt_tile_rows(g, blockIdx.x, &part, &j, &row0, &nrows);
  pt_rank_tile(C, cls, row0, nrows, sh);
  // the shard's class starts: its first row plus the exclusive prefix of
  // its class totals
  const long long base = static_cast<long long>(part) * g.m < g.n
                             ? static_cast<long long>(part) * g.m : g.n;
  const int* tot = totals + static_cast<long long>(part) * C;
  pt_exclusive_over(
      C, [&](int c) { return tot[c]; },
      [&](int c, int v) { sh.dbase[c] = base + v; }, sh.scratch);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += PT_THREADS) {
    const long long col = static_cast<long long>(part) * C + c;
    if (starts != nullptr && j == 0) starts[col] = sh.dbase[c];
    // sorted position p of class c goes to dbase[c] + p, while p < lim[c];
    // the dropped class is never written
    sh.dbase[c] += offs[col * g.tps + j] - sh.tstart[c];
    sh.lim[c] = c == C - 1 ? sh.tstart[c] : sh.tstart[c] + sh.lim[c];
  }
  __syncthreads();
  if (nrows == 0) return;  // uniform across the block
  for (int k = 0; k < cols.n; ++k)
    pt_move_width(cols.src[k], cols.dst[k], cols.width[k], row0, nrows, sh);
  if (pane != nullptr)
    pt_move_staged<long long>(reinterpret_cast<const unsigned char*>(ts),
                              reinterpret_cast<unsigned char*>(pane), row0, nrows,
                              sh, pane_of);
}

static cudaError_t cr_smem_attr(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launches the three kernels on `stream` (chain_scatter once for each
// CR_MAX_COLS columns).  nclass is the classes of one shard; with
// shard_rows > 0 there are nshards shards of shard_rows rows (the last
// ones may be short or empty) and nshards * nclass classes, else one.
// src_ptrs, dst_ptrs and widths are HOST arrays of ncols entries (copied
// into the kernel's parameters); key, ts and pane may be null.  Scratch:
// cls n uint16; counts and offs (classes) * tiles ints, totals (classes)
// ints (tiles = ceil(shard_rows or n / 4096) per shard); starts (classes)
// long longs, written on the device.
extern "C" int ft_chain_route(const void* key, const void* keep, long long n,
                              int nclass, long long max_parallelism,
                              long long shard_rows, int nshards,
                              const void* src_ptrs, const void* dst_ptrs,
                              const void* widths, int ncols, const void* ts,
                              long long pane_offset, long long slide,
                              void* pane, void* cls, void* counts, void* offs,
                              void* totals, void* starts, void* stream) {
  if (n <= 0 || n > 0x7FFFFFFFLL || ncols < 0 || nclass < 2 || nshards < 1 ||
      shard_rows < 0 || nclass > PT_MAX_CLASSES ||
      (shard_rows > 0 && (n + shard_rows - 1) / shard_rows > nshards) ||
      (pane != nullptr && (ts == nullptr || slide <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* sp = static_cast<const long long*>(src_ptrs);
  const long long* dp = static_cast<const long long*>(dst_ptrs);
  const int* wp = static_cast<const int*>(widths);
  for (int k = 0; k < ncols; ++k)
    if (wp[k] != 1 && wp[k] != 2 && wp[k] != 4 && wp[k] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = shard_rows > 0 ? nshards : 1;
  const PtGeometry g = pt_geometry(n, shard_rows > 0 ? shard_rows : n, parts, nclass);
  if (g.tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int tiles = static_cast<unsigned int>(g.tiles);
  const long long columns = static_cast<long long>(parts) * nclass;
  ChainClass class_of;
  class_of.key = static_cast<const long long*>(key);
  class_of.keep = static_cast<const unsigned char*>(keep);
  class_of.nclass = nclass;
  class_of.maxpar = max_parallelism > 0
                        ? static_cast<unsigned long long>(max_parallelism)
                        : 1ULL;
  unsigned short* c16 = static_cast<unsigned short*>(cls);

  const size_t hist = sizeof(int) * nclass;
  cudaError_t err = cr_smem_attr(reinterpret_cast<const void*>(chain_classify), hist);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_classify<<<tiles, PT_THREADS, hist, s>>>(class_of, g, c16,
                                                 static_cast<int*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_scan<<<static_cast<unsigned int>((columns + PT_WARPS - 1) / PT_WARPS),
               PT_THREADS, 0, s>>>(static_cast<const int*>(counts), columns, g.tps,
                                   static_cast<int*>(offs), static_cast<int*>(totals));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  PaneStart pane_of;
  pane_of.offset = pane_offset;
  pane_of.slide = slide > 0 ? slide : 1;
  // the first launch also writes the starts and the panes (and runs with
  // no columns)
  for (int j0 = 0; j0 == 0 || j0 < ncols; j0 += CR_MAX_COLS) {
    ColTable t;
    t.n = ncols - j0 < CR_MAX_COLS ? ncols - j0 : CR_MAX_COLS;
    int stage = 0;
    for (int k = 0; k < CR_MAX_COLS; ++k) {
      const bool used = k < t.n;
      t.src[k] = used ? reinterpret_cast<const unsigned char*>(sp[j0 + k]) : nullptr;
      t.dst[k] = used ? reinterpret_cast<unsigned char*>(dp[j0 + k]) : nullptr;
      t.width[k] = used ? wp[j0 + k] : 0;
      if (t.width[k] > stage) stage = t.width[k];
    }
    long long* pn = j0 == 0 ? static_cast<long long*>(pane) : nullptr;
    if (pn != nullptr) stage = 8;
    const size_t smem = pt_scatter_smem(nclass, stage);
    err = cr_smem_attr(reinterpret_cast<const void*>(chain_scatter), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    chain_scatter<<<tiles, PT_THREADS, smem, s>>>(
        t, static_cast<const long long*>(ts), pane_of, pn, g, c16,
        static_cast<const int*>(offs), static_cast<const int*>(totals),
        j0 == 0 ? static_cast<long long*>(starts) : nullptr, stage);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
