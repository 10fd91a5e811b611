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
// The count, scan and stable warp-ranked scatter are partition.cuh's
// (shared with shard_pack); the kernels here keep the chain_ names.  The
// column table holds CR_MAX_COLS columns; more columns take further
// chain_scatter launches of CR_MAX_COLS columns each, which rank the rows
// again the same way.
//
// Bound on this card: bytes.  Each input row is read (key 8 bytes, keep 1,
// the columns) and each kept row written (the columns, pane 8), about 16 us
// at 3.35 TB/s for 2^20 rows of three int64 columns.  The design is
// simple, not fast: a warp walks its tile in 16 dependent steps, the key
// is read and hashed twice (count and scatter, instead of a class array),
// and the scan runs in one block.  Stores of a step land in up to nclass
// runs, each contiguous.
#include "partition.cuh"

#define CR_MAX_COLS 16

struct ColTable {
  const unsigned char* src[CR_MAX_COLS];
  unsigned char* dst[CR_MAX_COLS];
  int width[CR_MAX_COLS];
  int n;
};

// The class of row i: nclass - 1 for a dropped row; in route mode the
// downstream channel of its key, else 0; with row shards, offset by the
// shard's classes.
struct ChainClass {
  const long long* key;
  const unsigned char* keep;
  int nclass;
  unsigned long long maxpar;
  long long shard_rows;

  __device__ __forceinline__ int operator()(long long i) const {
    const int drop = nclass - 1;
    int c;
    if (!keep[i]) {
      c = drop;
    } else if (key == nullptr) {
      c = 0;
    } else {
      const unsigned int h = fmix32(static_cast<unsigned int>(
          splitmix64(static_cast<unsigned long long>(key[i])) & 0xFFFFFFFFULL));
      const unsigned long long kg = h % maxpar;
      c = static_cast<int>(kg * static_cast<unsigned long long>(drop) / maxpar);
    }
    if (shard_rows > 0) c += static_cast<int>(i / shard_rows) * nclass;
    return c;
  }
};

struct ChainEmit {
  ColTable cols;
  const long long* ts;
  long long pane_offset;
  long long slide;
  long long* pane;
  int nclass;

  __device__ __forceinline__ void operator()(long long i, int cls,
                                             long long d) const {
    if (cls % nclass == nclass - 1) return;  // a dropped row
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
};

__global__ void chain_count(ChainClass class_of, long long n, int total_classes,
                            long long tiles, int* __restrict__ counts) {
  extern __shared__ int s_count[];
  pt_count(class_of, n, total_classes, tiles, counts, s_count);
}

__global__ void chain_scan(const int* __restrict__ counts, long long total,
                           long long tiles, int* __restrict__ offsets,
                           long long* __restrict__ starts) {
  __shared__ long long warp_sums[PT_SCAN_THREADS / 32];
  pt_scan(counts, total, tiles, offsets, starts, warp_sums);
}

__global__ void chain_scatter(ChainClass class_of, ChainEmit emit, long long n,
                              int total_classes, long long tiles,
                              const int* __restrict__ offsets) {
  extern __shared__ int s_seen[];
  pt_scatter(class_of, emit, n, total_classes, tiles, offsets, s_seen);
}

// Launches the three kernels on `stream` (chain_scatter once for each
// CR_MAX_COLS columns).  nclass is the classes of one shard; with
// shard_rows > 0 there are nshards shards of shard_rows rows (the last
// ones may be short or empty) and nshards * nclass classes, else one.
// src_ptrs, dst_ptrs and widths are HOST arrays of ncols entries (copied
// into the kernel's parameters); key, ts and pane may be null.  Scratch:
// counts and offsets hold (classes) * tiles ints, starts (classes) long
// longs (tiles = ceil(n / 512)).
extern "C" int ft_chain_route(const void* key, const void* keep, long long n,
                              int nclass, long long max_parallelism,
                              long long shard_rows, int nshards,
                              const void* src_ptrs, const void* dst_ptrs,
                              const void* widths, int ncols, const void* ts,
                              long long pane_offset, long long slide,
                              void* pane, void* counts, void* offsets,
                              void* starts, void* stream) {
  if (n <= 0 || ncols < 0 || nclass < 2 || nshards < 1 || shard_rows < 0 ||
      (shard_rows > 0 && (n + shard_rows - 1) / shard_rows > nshards))
    return static_cast<int>(cudaErrorInvalidValue);
  const int total_classes = shard_rows > 0 ? nclass * nshards : nclass;
  const long long* sp = static_cast<const long long*>(src_ptrs);
  const long long* dp = static_cast<const long long*>(dst_ptrs);
  const int* wp = static_cast<const int*>(widths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = pt_tiles(n);
  const unsigned int blocks = pt_blocks(tiles);
  const size_t shmem = pt_shmem(total_classes);
  ChainClass class_of;
  class_of.key = static_cast<const long long*>(key);
  class_of.keep = static_cast<const unsigned char*>(keep);
  class_of.nclass = nclass;
  class_of.maxpar = max_parallelism > 0
                        ? static_cast<unsigned long long>(max_parallelism)
                        : 1ULL;
  class_of.shard_rows = shard_rows;
  chain_count<<<blocks, PT_THREADS, shmem, s>>>(class_of, n, total_classes,
                                                tiles, static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_scan<<<1, PT_SCAN_THREADS, 0, s>>>(
      static_cast<const int*>(counts),
      static_cast<long long>(total_classes) * tiles, tiles,
      static_cast<int*>(offsets), static_cast<long long*>(starts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the first launch also writes the panes (and runs with no columns)
  for (int j0 = 0; j0 == 0 || j0 < ncols; j0 += CR_MAX_COLS) {
    ChainEmit emit;
    emit.cols.n = ncols - j0 < CR_MAX_COLS ? ncols - j0 : CR_MAX_COLS;
    for (int j = 0; j < CR_MAX_COLS; ++j) {
      const bool used = j < emit.cols.n;
      emit.cols.src[j] =
          used ? reinterpret_cast<const unsigned char*>(sp[j0 + j]) : nullptr;
      emit.cols.dst[j] =
          used ? reinterpret_cast<unsigned char*>(dp[j0 + j]) : nullptr;
      emit.cols.width[j] = used ? wp[j0 + j] : 0;
    }
    emit.ts = static_cast<const long long*>(ts);
    emit.pane_offset = pane_offset;
    emit.slide = slide;
    emit.pane = j0 == 0 ? static_cast<long long*>(pane) : nullptr;
    emit.nclass = nclass;
    chain_scatter<<<blocks, PT_THREADS, shmem, s>>>(
        class_of, emit, n, total_classes, tiles,
        static_cast<const int*>(offsets));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
