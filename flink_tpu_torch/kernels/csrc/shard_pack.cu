// shard_pack: the keyBy exchange's pack into per-target buckets (sm_90a).
//
// Replaces the device pack of the mesh engines:
//   flink_tpu/parallel/mesh_agg.py:50-84 `_target_shard` + `_bucketize`
//     (mesh_agg.py:112-135 and mesh_windows.py:102-123 call it per source
//     shard under shard_map), and
//   flink_tpu/parallel/mesh_log.py:137-157 `_make_packed_exchange`'s pack.
//
// n rows are `nsrc` source blocks of m = n / nsrc rows each (a source
// shard's data-parallel slice).  Every row has a target shard t in
// [0, S], S meaning "not sent" (padding):
//   given  : tgt[i] (int32; values outside [0, S] count as S), or
//   hashed : fmix32(hash_lo[i]) % maxpar * S / maxpar, the key group's
//            shard (KeyGroupRangeAssignment's range arithmetic);
//   and mask[i] == 0 sends row i to S.
// Within each source, rows are partitioned stably by target (the
// reference's stable argsort and searchsorted rank).  A row of source s,
// target t < S and rank r < cap lands in bucket (s, t) at row r of the
// output, out[(s * S + t) * cap + r] (each lane its own array; a row of
// the [n, K] layout is one lane of 4 K bytes); every other output row is
// zero, and counts[s * S + t] = min(rows of (s, t), cap).
//
// Bound on this card: bytes.  Read the lanes and the targets once, write
// nsrc * S * cap rows of every lane once.  With cap = m most of the output
// is zeros (7/8 of it at S = 8), so the zero fill is most of the bytes.
//
// Design: partition.cuh's tiled partition, with a source as its block of
// rows.  A tile is PT_TILE rows of ONE source (tiles never cross a
// source block, also when m is not a multiple of PT_TILE), so a tile's
// classes are just the S + 1 targets.  Three launches:
//   1. sp_classify: a block per tile computes each row's target once,
//      stores it as uint16 and counts the tile's rows per target
//      (__match_any_sync groups, one shared-memory add per group);
//      counts are laid out [source, target][tile];
//   2. sp_scan: a warp per (source, target) column scans its tiles'
//      counts (shuffles, 32 tiles a step): each tile's rank base in its
//      buckets, and the bucket counts clipped at cap;
//   3. sp_scatter_fill, two kinds of block in one grid:
//      - a tile block ranks its rows stably (warp w takes rows
//        [w * 512, w * 512 + 512) of the tile in 16 steps of 32; ranks
//        from __match_any_sync within a step, per-warp counters across
//        steps, a prefix over warps and targets across the block), keeps
//        the tile's permutation in shared memory in bucket order, and
//        then, lane by lane, consecutive threads write consecutive rows
//        of a bucket run (runs are ~PT_TILE / (S + 1) rows long).  A lane
//        of at most 8 bytes is first staged into shared memory by
//        coalesced loads; a wider row (the [n, K] layout) is moved in
//        16, 8 or 4-byte words, consecutive threads on consecutive words;
//      - a fill block zeroes one chunk of SP_FILL_BYTES of one bucket of
//        one lane, only past the bucket's count, in 16-byte stores.
//   Every output byte is written once.
#include "partition.cuh"

#define SP_FILL_BYTES (PT_THREADS * 16 * 8) // zero bytes a fill block owns
#define SP_MAX_LANES 16

struct SpTargets {
  const int* tgt;
  const unsigned int* hash_lo;
  const unsigned char* mask;
  int nshards;
  unsigned int maxpar;

  struct Row {
    unsigned int word;   // the target, or the hash's low lane
    bool sent;
  };

  __device__ __forceinline__ Row load(long long i) const {
    Row r;
    r.sent = mask == nullptr || mask[i] != 0;
    r.word = tgt != nullptr ? static_cast<unsigned int>(tgt[i]) : hash_lo[i];
    return r;
  }

  __device__ __forceinline__ int classify(const Row& r) const {
    const int S = nshards;
    if (!r.sent) return S;
    if (tgt != nullptr) {
      const int t = static_cast<int>(r.word);
      return (t < 0 || t > S) ? S : t;
    }
    return pt_key_group_index(fmix32(r.word), maxpar, static_cast<unsigned int>(S));
  }
};

struct SpLanes {
  const unsigned char* src[SP_MAX_LANES];
  unsigned char* dst[SP_MAX_LANES];
  int width[SP_MAX_LANES];       // bytes of a row of the lane
  int word[SP_MAX_LANES];        // bytes moved per access (16, 8, 4, 2, 1)
  long long fill_start[SP_MAX_LANES + 1];  // first fill block of each lane
  long long fill_chunks[SP_MAX_LANES];     // fill blocks per bucket
  int n;
  int stage_bytes;               // shared bytes per row for staged lanes
};

// 1. Targets (stored as uint16) and the tile's count per target < S.
__global__ void __launch_bounds__(PT_THREADS)
sp_classify(SpTargets target_of, PtGeometry g, unsigned short* __restrict__ tcls,
            int* __restrict__ counts) {
  extern __shared__ int s_hist[];  // S + 1
  pt_classify(target_of, g, tcls, counts, g.nclass - 1, s_hist);
}

// 2. Per (source, target) column of tps tile counts: the exclusive prefix
// (rank base of each tile's rows in the bucket) and the bucket's count.
__global__ void __launch_bounds__(PT_THREADS)
sp_scan(const int* __restrict__ counts, long long columns, int tps,
        long long cap, int* __restrict__ offs, int* __restrict__ out_counts) {
  const long long col =
      static_cast<long long>(blockIdx.x) * PT_WARPS + (threadIdx.x >> 5);
  if (col >= columns) return;  // uniform across the warp
  const long long carry = pt_scan_column(counts + col * tps, offs + col * tps, tps);
  if ((threadIdx.x & 31) == 0)
    out_counts[col] = static_cast<int>(carry < cap ? carry : cap);
}

// A wide row (words of U per row): consecutive threads on consecutive
// words of a bucket run; each row is read from its tile window (L1/L2).
template <typename U>
__device__ __forceinline__ void sp_move_words(const unsigned char* src_b,
                                              unsigned char* dst_b, int words,
                                              long long row0, int nrows,
                                              const PtShared& sh) {
  const U* src = reinterpret_cast<const U*>(src_b) + row0 * words;
  U* dst = reinterpret_cast<U*>(dst_b);
  const int total = nrows * words;
  for (int x = threadIdx.x; x < total; x += PT_THREADS) {
    const int p = x / words;
    const int u = x - p * words;
    const unsigned int e = sh.sorted[p];
    const int c = static_cast<int>(e >> 16);
    if (p < sh.lim[c])
      dst[(sh.dbase[c] + p) * words + u] =
          src[static_cast<long long>(e & 0xFFFFu) * words + u];
  }
}

__device__ void sp_scatter_tile(const SpLanes& lanes, const PtGeometry& g,
                                long long cap, long long tile,
                                const unsigned short* __restrict__ tcls,
                                const int* __restrict__ offs,
                                unsigned char* smem) {
  const int S = g.nclass - 1;
  const int C = g.nclass;
  int s, j, nrows;
  long long row0;
  pt_tile_rows(g, tile, &s, &j, &row0, &nrows);
  const PtShared sh = pt_carve(smem, C, lanes.stage_bytes);
  pt_rank_tile(C, tcls, row0, nrows, sh);
  // where each run goes: sorted position p of target c is bucket row
  // dbase[c] + p, written while p < lim[c] (the rows below cap)
  for (int c = threadIdx.x; c < C; c += PT_THREADS) {
    const int cnt = sh.lim[c];
    const int st = sh.tstart[c];
    if (c < S) {
      const long long bucket = static_cast<long long>(s) * S + c;
      const long long base = offs[bucket * g.tps + j];
      long long keep = cap - base;
      keep = keep < 0 ? 0 : (keep > cnt ? cnt : keep);
      sh.lim[c] = st + static_cast<int>(keep);
      sh.dbase[c] = bucket * cap + base - st;
    } else {
      sh.lim[c] = st;  // padding: never written
      sh.dbase[c] = 0;
    }
  }
  __syncthreads();

  for (int L = 0; L < lanes.n; ++L) {
    const unsigned char* src = lanes.src[L];
    unsigned char* dst = lanes.dst[L];
    const int w = lanes.width[L];
    if (w <= 8) {
      pt_move_width(src, dst, w, row0, nrows, sh);
    } else {
      switch (lanes.word[L]) {
        case 16: sp_move_words<uint4>(src, dst, w / 16, row0, nrows, sh); break;
        case 8: sp_move_words<uint2>(src, dst, w / 8, row0, nrows, sh); break;
        default: sp_move_words<unsigned int>(src, dst, w / 4, row0, nrows, sh); break;
      }
    }
  }
}

// Zero the bytes [lo, hi) of dst: single bytes up to 16-byte alignment,
// 16-byte stores, single bytes after.
__device__ __forceinline__ void sp_zero_bytes(unsigned char* dst, long long lo,
                                              long long hi) {
  const unsigned long long base = reinterpret_cast<unsigned long long>(dst);
  long long a = static_cast<long long>(((base + lo + 15) & ~15ULL) - base);
  long long b = static_cast<long long>(((base + hi) & ~15ULL) - base);
  if (a > hi) a = hi;
  if (b < a) b = a;
  for (long long q = lo + threadIdx.x; q < a; q += PT_THREADS) dst[q] = 0;
  uint4* v = reinterpret_cast<uint4*>(dst + a);
  const long long nv = (b - a) >> 4;
  for (long long q = threadIdx.x; q < nv; q += PT_THREADS)
    v[q] = make_uint4(0u, 0u, 0u, 0u);
  for (long long q = b + threadIdx.x; q < hi; q += PT_THREADS) dst[q] = 0;
}

__device__ void sp_fill_chunk(const SpLanes& lanes, long long cap, long long f,
                              const int* __restrict__ out_counts) {
  int L = 0;
  while (L + 1 < lanes.n && f >= lanes.fill_start[L + 1]) ++L;
  const long long local = f - lanes.fill_start[L];
  const long long chunks = lanes.fill_chunks[L];
  const long long bucket = local / chunks;
  const long long chunk = local - bucket * chunks;
  const long long w = lanes.width[L];
  const long long b0 = bucket * cap * w;
  const long long b1 = b0 + cap * w;
  long long lo = b0 + chunk * SP_FILL_BYTES;
  long long hi = lo + SP_FILL_BYTES < b1 ? lo + SP_FILL_BYTES : b1;
  const long long z = b0 + static_cast<long long>(out_counts[bucket]) * w;
  if (lo < z) lo = z;
  if (lo >= hi) return;
  sp_zero_bytes(lanes.dst[L], lo, hi);
}

// 3. Tile blocks [0, tiles), then fill blocks.
__global__ void __launch_bounds__(PT_THREADS)
sp_scatter_fill(SpLanes lanes, PtGeometry g, long long cap,
                const unsigned short* __restrict__ tcls,
                const int* __restrict__ offs,
                const int* __restrict__ out_counts) {
  extern __shared__ __align__(16) unsigned char sp_smem[];
  const long long b = blockIdx.x;
  if (b < g.tiles)
    sp_scatter_tile(lanes, g, cap, b, tcls, offs, sp_smem);
  else
    sp_fill_chunk(lanes, cap, b - g.tiles, out_counts);
}

// Packs n rows (nsrc blocks of n / nsrc) into nsrc * S buckets of cap rows.
// tgt or hash_lo gives the targets (tgt wins; max_parallelism with
// hash_lo); mask may be null.  src_ptrs, dst_ptrs and widths are HOST
// arrays of nlanes entries (long long, long long, int; copied into the
// kernels' parameters): a lane's rows are `width` bytes, 1, 2, 4 or 8, or
// a multiple of 4 (a row of 32-bit lanes).  out_counts: nsrc * S ints.
// Scratch: tcls n uint16; counts and offs nsrc * S * ceil(m / 4096) ints
// each.
extern "C" int ft_shard_pack(const void* tgt, const void* hash_lo,
                             long long max_parallelism, const void* mask,
                             long long n, int nsrc, int nshards, long long cap,
                             const void* src_ptrs, const void* dst_ptrs,
                             const void* widths, int nlanes, void* out_counts,
                             void* tcls, void* counts, void* offs,
                             void* stream) {
  if (n <= 0 || nsrc < 1 || n % nsrc != 0 || nshards < 1 ||
      nshards + 1 > PT_MAX_CLASSES || cap < 1 || nlanes < 1 || nlanes > SP_MAX_LANES ||
      n / nsrc > 0x7FFFFFFFLL ||
      (tgt == nullptr && (hash_lo == nullptr || max_parallelism < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PtGeometry g = pt_geometry(n, n / nsrc, nsrc, nshards + 1);
  SpTargets target_of;
  target_of.tgt = static_cast<const int*>(tgt);
  target_of.hash_lo = static_cast<const unsigned int*>(hash_lo);
  target_of.mask = static_cast<const unsigned char*>(mask);
  target_of.nshards = nshards;
  target_of.maxpar = static_cast<unsigned int>(max_parallelism > 0 ? max_parallelism : 1);
  const long long* sp = static_cast<const long long*>(src_ptrs);
  const long long* dp = static_cast<const long long*>(dst_ptrs);
  const int* wp = static_cast<const int*>(widths);
  const long long buckets = static_cast<long long>(nsrc) * nshards;
  SpLanes lanes;
  lanes.n = nlanes;
  lanes.stage_bytes = 0;
  lanes.fill_start[0] = 0;
  for (int k = 0; k < SP_MAX_LANES; ++k) {
    const bool used = k < nlanes;
    const int w = used ? wp[k] : 0;
    if (used && !(w == 1 || w == 2 || w == 4 || w == 8 || w % 4 == 0))
      return static_cast<int>(cudaErrorInvalidValue);
    lanes.src[k] = used ? reinterpret_cast<const unsigned char*>(sp[k]) : nullptr;
    lanes.dst[k] = used ? reinterpret_cast<unsigned char*>(dp[k]) : nullptr;
    lanes.width[k] = w;
    int word = w;
    if (used && w > 8) {
      const unsigned long long both =
          static_cast<unsigned long long>(sp[k]) | static_cast<unsigned long long>(dp[k]);
      word = (w % 16 == 0 && both % 16 == 0) ? 16
             : (w % 8 == 0 && both % 8 == 0) ? 8 : 4;
    } else if (used && w > lanes.stage_bytes) {
      lanes.stage_bytes = w;
    }
    lanes.word[k] = word;
    const long long chunks =
        used ? (cap * w + SP_FILL_BYTES - 1) / SP_FILL_BYTES : 0;
    lanes.fill_chunks[k] = chunks;
    lanes.fill_start[k + 1] = lanes.fill_start[k] + buckets * chunks;
  }
  const long long fill_blocks = lanes.fill_start[SP_MAX_LANES];
  if (g.tiles + fill_blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = nshards + 1;

  const size_t hist = sizeof(int) * C;
  cudaError_t err = cudaFuncSetAttribute(
      sp_classify, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(hist));
  if (err != cudaSuccess) return static_cast<int>(err);
  sp_classify<<<static_cast<unsigned int>(g.tiles), PT_THREADS, hist, st>>>(
      target_of, g, static_cast<unsigned short*>(tcls),
      static_cast<int*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sp_scan<<<static_cast<unsigned int>((buckets + PT_WARPS - 1) / PT_WARPS),
            PT_THREADS, 0, st>>>(static_cast<const int*>(counts), buckets,
                                 g.tps, cap, static_cast<int*>(offs),
                                 static_cast<int*>(out_counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = pt_scatter_smem(C, lanes.stage_bytes);
  err = cudaFuncSetAttribute(sp_scatter_fill,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sp_scatter_fill<<<static_cast<unsigned int>(g.tiles + fill_blocks),
                    PT_THREADS, smem, st>>>(
      lanes, g, cap, static_cast<const unsigned short*>(tcls),
      static_cast<const int*>(offs), static_cast<const int*>(out_counts));
  return static_cast<int>(cudaGetLastError());
}
