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
// Rows are partitioned stably by the class s * (S + 1) + t (s = i / m):
// source blocks are contiguous row ranges, so this one partition is every
// source's stable partition by target, and the row's rank in its class is
// its rank among its source's rows for that target (the stable argsort,
// searchsorted rank of the reference).  A row of target t < S and rank
// r < cap lands in bucket (s, t) at row r of the output
//   out[(s * S + t) * cap + r]   (lane by lane: each lane its own array,
//                                 or K 32-bit lanes of one row-major array)
// every other output row is written with zeros, and counts[s * S + t] =
// min(rows of (s, t), cap).  The count, scan and warp-ranked scatter are
// partition.cuh's, shared with chain_route.
//
// Launches: pack_count, pack_scan, pack_counts (the bucket counts from the
// class starts), pack_fill (zeros into every output row past its bucket's
// count), pack_scatter (the rows).  Bound on this card: bytes: read n rows
// of lanes and targets once, write nsrc * S * cap rows of lanes and the
// counts once.  Simple, not fast: as chain_route, a warp walks its tile in
// 16 dependent steps, the target is computed twice, the scan runs in one
// block, and a row's lanes are stored one lane at a time.
#include "partition.cuh"

#define PK_MAX_LANES 16

struct LaneTable {
  const unsigned char* src[PK_MAX_LANES];
  unsigned char* dst[PK_MAX_LANES];
  int width[PK_MAX_LANES];
  long long src_stride[PK_MAX_LANES];  // elements between rows
  long long dst_stride[PK_MAX_LANES];
  int n;
};

struct PackClass {
  const int* tgt;
  const unsigned int* hash_lo;
  const unsigned char* mask;
  int nshards;
  unsigned int maxpar;
  long long m;

  __device__ __forceinline__ int operator()(long long i) const {
    const int S = nshards;
    int t;
    if (mask != nullptr && !mask[i]) {
      t = S;
    } else if (tgt != nullptr) {
      t = tgt[i];
      if (t < 0 || t > S) t = S;
    } else {
      const unsigned int kg = fmix32(hash_lo[i]) % maxpar;
      t = static_cast<int>(static_cast<long long>(kg) * S / maxpar);
    }
    return static_cast<int>(i / m) * (S + 1) + t;
  }
};

struct PackEmit {
  LaneTable lanes;
  const long long* starts;
  int nshards;
  long long cap;

  __device__ __forceinline__ void operator()(long long i, int cls,
                                             long long d) const {
    const int S = nshards;
    const int s = cls / (S + 1);
    const int t = cls - s * (S + 1);
    if (t >= S) return;  // padding: not sent
    const long long rank = d - starts[cls];
    if (rank >= cap) return;  // beyond the bucket's cap
    const long long q = (static_cast<long long>(s) * S + t) * cap + rank;
    for (int k = 0; k < lanes.n; ++k)
      move_bytes(lanes.src[k], lanes.dst[k], lanes.width[k],
                 i * lanes.src_stride[k], q * lanes.dst_stride[k]);
  }
};

__device__ __forceinline__ void zero_bytes(unsigned char* dst, int width,
                                           long long d) {
  switch (width) {
    case 1: dst[d] = 0; break;
    case 2: reinterpret_cast<uint16_t*>(dst)[d] = 0; break;
    case 4: reinterpret_cast<uint32_t*>(dst)[d] = 0u; break;
    default: reinterpret_cast<unsigned long long*>(dst)[d] = 0ULL; break;
  }
}

__global__ void pack_count(PackClass class_of, long long n, int nclass,
                           long long tiles, int* __restrict__ counts) {
  extern __shared__ int s_count[];
  pt_count(class_of, n, nclass, tiles, counts, s_count);
}

__global__ void pack_scan(const int* __restrict__ counts, long long total,
                          long long tiles, int* __restrict__ offsets,
                          long long* __restrict__ starts) {
  __shared__ long long warp_sums[PT_SCAN_THREADS / 32];
  pt_scan(counts, total, tiles, offsets, starts, warp_sums);
}

// counts[s * S + t] = min(starts[c + 1] - starts[c], cap), c the class of
// (s, t); t < S, so c + 1 is at most source s's padding class.
__global__ void pack_counts(const long long* __restrict__ starts, int nsrc,
                            int S, long long cap, int* __restrict__ counts) {
  FT_GRID_STRIDE(b, static_cast<long long>(nsrc) * S) {
    const long long s = b / S;
    const long long c = s * (S + 1) + (b - s * S);
    const long long cnt = starts[c + 1] - starts[c];
    counts[b] = static_cast<int>(cnt < cap ? cnt : cap);
  }
}

__global__ void pack_fill(LaneTable lanes, const int* __restrict__ counts,
                          long long total, long long cap) {
  FT_GRID_STRIDE(q, total) {
    const long long b = q / cap;
    if (q - b * cap < counts[b]) continue;  // a packed row lands here
    for (int k = 0; k < lanes.n; ++k)
      zero_bytes(lanes.dst[k], lanes.width[k], q * lanes.dst_stride[k]);
  }
}

__global__ void pack_scatter(PackClass class_of, PackEmit emit, long long n,
                             int nclass, long long tiles,
                             const int* __restrict__ offsets) {
  extern __shared__ int s_seen[];
  pt_scatter(class_of, emit, n, nclass, tiles, offsets, s_seen);
}

// Packs n rows (nsrc blocks of n / nsrc) into nsrc * S buckets of cap rows.
// tgt or hash_lo gives the targets (tgt wins; max_parallelism with
// hash_lo); mask may be null.  src_ptrs, dst_ptrs, widths, src_strides and
// dst_strides are HOST arrays of nlanes entries (copied into the kernels'
// parameters; strides in elements).  out_counts: nsrc * S ints.  Scratch:
// counts and offsets hold nsrc * (S + 1) * tiles ints, starts
// nsrc * (S + 1) long longs (tiles = ceil(n / 512)).
extern "C" int ft_shard_pack(const void* tgt, const void* hash_lo,
                             long long max_parallelism, const void* mask,
                             long long n, int nsrc, int nshards, long long cap,
                             const void* src_ptrs, const void* dst_ptrs,
                             const void* widths, const void* src_strides,
                             const void* dst_strides, int nlanes,
                             void* out_counts, void* counts, void* offsets,
                             void* starts, void* stream) {
  if (n <= 0 || nsrc < 1 || n % nsrc != 0 || nshards < 1 || cap < 1 ||
      nlanes < 0 || nlanes > PK_MAX_LANES ||
      (tgt == nullptr && (hash_lo == nullptr || max_parallelism < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nclass = nsrc * (nshards + 1);
  const long long tiles = pt_tiles(n);
  const unsigned int blocks = pt_blocks(tiles);
  const size_t shmem = pt_shmem(nclass);
  PackClass class_of;
  class_of.tgt = static_cast<const int*>(tgt);
  class_of.hash_lo = static_cast<const unsigned int*>(hash_lo);
  class_of.mask = static_cast<const unsigned char*>(mask);
  class_of.nshards = nshards;
  class_of.maxpar = static_cast<unsigned int>(max_parallelism > 0 ? max_parallelism : 1);
  class_of.m = n / nsrc;
  PackEmit emit;
  const long long* sp = static_cast<const long long*>(src_ptrs);
  const long long* dp = static_cast<const long long*>(dst_ptrs);
  const int* wp = static_cast<const int*>(widths);
  const long long* ss = static_cast<const long long*>(src_strides);
  const long long* ds = static_cast<const long long*>(dst_strides);
  emit.lanes.n = nlanes;
  for (int k = 0; k < PK_MAX_LANES; ++k) {
    const bool used = k < nlanes;
    emit.lanes.src[k] = used ? reinterpret_cast<const unsigned char*>(sp[k]) : nullptr;
    emit.lanes.dst[k] = used ? reinterpret_cast<unsigned char*>(dp[k]) : nullptr;
    emit.lanes.width[k] = used ? wp[k] : 0;
    emit.lanes.src_stride[k] = used ? ss[k] : 0;
    emit.lanes.dst_stride[k] = used ? ds[k] : 0;
  }
  emit.starts = static_cast<const long long*>(starts);
  emit.nshards = nshards;
  emit.cap = cap;
  pack_count<<<blocks, PT_THREADS, shmem, s>>>(class_of, n, nclass, tiles,
                                               static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_scan<<<1, PT_SCAN_THREADS, 0, s>>>(
      static_cast<const int*>(counts), static_cast<long long>(nclass) * tiles,
      tiles, static_cast<int*>(offsets), static_cast<long long*>(starts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long buckets = static_cast<long long>(nsrc) * nshards;
  pack_counts<<<grid_for(buckets, 256), 256, 0, s>>>(
      static_cast<const long long*>(starts), nsrc, nshards, cap,
      static_cast<int*>(out_counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_fill<<<grid_for(buckets * cap, 256), 256, 0, s>>>(
      emit.lanes, static_cast<const int*>(out_counts), buckets * cap, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_scatter<<<blocks, PT_THREADS, shmem, s>>>(
      class_of, emit, n, nclass, tiles, static_cast<const int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}
