// edge_popcount: for each pair p, the number of common neighbours of
// u[p] and v[p], sum over w of popcount(adj[u, w] & adj[v, w]) over the
// rows of a packed uint32 adjacency bitset [n, words].
//
// Replaces flink_tpu/graph/library.py _edge_common_neighbors.per_edge
// (:398-400), the shared kernel of TriangleCount and
// ClusteringCoefficient.
//
// Bound on this card: bytes.  The bitset is read at least once
// (n * words * 4 B).  Read pair by pair, each pair moves its two rows
// (8 * words B); at a Kronecker graph's scale 18 that is 3.8M pairs of
// 32 KiB rows, ~125 GB, though almost every word is zero (7.1M nonzero
// words in 2.1G).  The count only needs the words where the pair's
// sparser row is nonzero.
//
// Design, three launches on a plan (kernels/edge_popcount.py):
// 1. ep_scan: a warp a row reads the bitset once, in 16-byte loads (one
//    word a lane when words is not a multiple of 4), and writes each
//    row's count of nonzero words and a mask bit for each nonzero chunk
//    (4 words, or 1).
// 2. ep_fill: for each row with at most dense_above nonzero words (a
//    listed row), a warp walks the row's mask, reads back only the
//    nonzero chunks and writes the row's nonzero words as (word index,
//    word) entries, in word order, at the row's offset.  Rows with more
//    are dense: cheaper read whole, and not listed.
// 3. ep_pairs: the pairs come sorted by their big row (the one with more
//    nonzero words; the small row is the other).  A block takes 256
//    sorted pairs at a time and, for each run of them that shares a big
//    row, builds that row into a shared-memory bitmap (its list
//    scattered into a zero tile, or a dense row copied whole); then each
//    warp takes a pair, reads the small row's list (contiguous, mostly in
//    the L2), probes the bitmap, ANDs and counts with __popc, and reduces
//    across the warp.  A dense small row (then the big row is dense too)
//    is streamed against the bitmap.  After the run the block clears what
//    it wrote.  Rows wider than a block's shared memory take the global
//    form: a warp a pair, the small row's list gathering the big row's
//    words from the bitset.
// Each count is stored at the pair's index in the caller's order.
// Integer work: bit-equal to the plain version and to the reference.
#include "common.cuh"

#define EP_THREADS 256
#define EP_SCAN_UNROLL 4

template <int VEC> struct EpChunk;
template <> struct EpChunk<4> { using T = uint4; };
template <> struct EpChunk<1> { using T = uint32_t; };

__device__ __forceinline__ int ep_nonzero(uint4 x) {
  return (x.x != 0) + (x.y != 0) + (x.z != 0) + (x.w != 0);
}
__device__ __forceinline__ int ep_nonzero(uint32_t x) { return x != 0; }

__device__ __forceinline__ uint32_t ep_word(uint4 x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}
__device__ __forceinline__ uint32_t ep_word(uint32_t x, int) { return x; }

__device__ __forceinline__ unsigned int ep_and_count(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}
__device__ __forceinline__ unsigned int ep_and_count(uint32_t a, uint32_t b) {
  return __popc(a & b);
}

// ---- 1. counts and chunk masks -------------------------------------------
template <int VEC>
__global__ void __launch_bounds__(EP_THREADS)
ep_scan(const uint32_t* __restrict__ adj, long long n, long long words,
        int32_t* __restrict__ counts, uint32_t* __restrict__ masks,
        long long mask_words) {
  using T = typename EpChunk<VEC>::T;
  const int lane = threadIdx.x & 31;
  const long long chunks = words / VEC;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
       row < n; row += nwarps) {
    const T* r = reinterpret_cast<const T*>(adj + row * words);
    uint32_t* m = masks + row * mask_words;
    unsigned int count = 0;
    for (long long m0 = 0; m0 < mask_words; m0 += EP_SCAN_UNROLL) {
      T x[EP_SCAN_UNROLL];
#pragma unroll
      for (int j = 0; j < EP_SCAN_UNROLL; ++j) {
        const long long c = (m0 + j) * 32 + lane;
        x[j] = c < chunks ? __ldcs(r + c) : T{};
      }
#pragma unroll
      for (int j = 0; j < EP_SCAN_UNROLL; ++j) {
        const int nz = ep_nonzero(x[j]);
        count += nz;
        const unsigned int bits = __ballot_sync(0xFFFFFFFFu, nz != 0);
        if (lane == 0 && m0 + j < mask_words) m[m0 + j] = bits;
      }
    }
    count = __reduce_add_sync(0xFFFFFFFFu, count);
    if (lane == 0) counts[row] = static_cast<int32_t>(count);
  }
}

// ---- 2. the listed rows' (word index, word) entries ----------------------
template <int VEC>
__global__ void __launch_bounds__(EP_THREADS)
ep_fill(const uint32_t* __restrict__ adj, long long n, long long words,
        const int32_t* __restrict__ counts, long long dense_above,
        const long long* __restrict__ offsets,
        const uint32_t* __restrict__ masks, long long mask_words,
        int2* __restrict__ entries) {
  using T = typename EpChunk<VEC>::T;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
       row < n; row += nwarps) {
    const int cnt = counts[row];
    if (cnt == 0 || cnt > dense_above) continue;
    const T* r = reinterpret_cast<const T*>(adj + row * words);
    const uint32_t* m = masks + row * mask_words;
    long long pos = offsets[row];
    for (long long m0 = 0; m0 < mask_words; m0 += 32) {
      const uint32_t mine = m0 + lane < mask_words ? m[m0 + lane] : 0u;
      unsigned int left = __ballot_sync(0xFFFFFFFFu, mine != 0);
      while (left) {
        const int j = __ffs(left) - 1;
        left &= left - 1;
        const uint32_t bits = __shfl_sync(0xFFFFFFFFu, mine, j);
        const long long c = (m0 + j) * 32 + lane;
        T x = T{};
        int nz = 0;
        if ((bits >> lane) & 1u) {
          x = r[c];
          nz = ep_nonzero(x);
        }
        int incl = nz;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
          if (lane >= off) incl += up;
        }
        long long at = pos + incl - nz;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const uint32_t w = ep_word(x, k);
          if (w != 0)
            entries[at++] = make_int2(static_cast<int>(c * VEC + k),
                                      static_cast<int>(w));
        }
        pos += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
    }
  }
}

// ---- 3. the pairs ---------------------------------------------------------

// a warp's count of one pair whose big row is in `tile` (shared memory)
template <int VEC>
__device__ __forceinline__ unsigned int ep_pair_tile(
    const uint32_t* __restrict__ adj, long long words,
    const int32_t* __restrict__ counts, long long dense_above,
    const long long* __restrict__ offsets, const int2* __restrict__ entries,
    const uint32_t* tile, int small, int lane) {
  using T = typename EpChunk<VEC>::T;
  const int scnt = counts[small];
  unsigned int acc = 0;
  if (scnt > dense_above) {
    const T* s = reinterpret_cast<const T*>(adj + static_cast<long long>(small) * words);
    const T* b = reinterpret_cast<const T*>(tile);
    for (long long c = lane; c < words / VEC; c += 32)
      acc += ep_and_count(__ldg(s + c), b[c]);
  } else {
    const int2* e = entries + offsets[small];
    for (int i = lane; i < scnt; i += 32) {
      const int2 x = __ldg(e + i);
      acc += __popc(static_cast<uint32_t>(x.y) & tile[x.x]);
    }
  }
  return __reduce_add_sync(0xFFFFFFFFu, acc);
}

template <int VEC>
__global__ void __launch_bounds__(EP_THREADS)
ep_pairs_tile(const uint32_t* __restrict__ adj, long long words,
              const int32_t* __restrict__ counts, long long dense_above,
              const long long* __restrict__ offsets,
              const int2* __restrict__ entries, const int32_t* __restrict__ big,
              const int32_t* __restrict__ small,
              const int32_t* __restrict__ order, long long n_pairs,
              int32_t* __restrict__ out) {
  using T = typename EpChunk<VEC>::T;
  extern __shared__ uint4 ep_tile4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(ep_tile4);
  __shared__ int s_big[EP_THREADS], s_small[EP_THREADS], s_order[EP_THREADS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile4 = (words + 3) / 4;
  for (long long i = t; i < tile4; i += EP_THREADS) ep_tile4[i] = make_uint4(0, 0, 0, 0);
  const long long n_chunks = (n_pairs + EP_THREADS - 1) / EP_THREADS;
  for (long long ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long long c0 = ch * EP_THREADS;
    const int cn = static_cast<int>(min(static_cast<long long>(EP_THREADS), n_pairs - c0));
    __syncthreads();   // the previous chunk's pairs are done with s_*
    if (t < cn) {
      s_big[t] = big[c0 + t];
      s_small[t] = small[c0 + t];
      s_order[t] = order[c0 + t];
    }
    __syncthreads();
    for (int s = 0; s < cn;) {
      const int row = s_big[s];
      // the run of `row`: sorted, so its pairs are the next `len`; the
      // count is also the barrier after the previous run's clearing
      const int len = __syncthreads_count(t < cn && s_big[t] == row);
      const int bcnt = counts[row];
      const bool dense = bcnt > dense_above;
      const long long boff = dense ? 0 : offsets[row];
      if (dense) {
        const T* r = reinterpret_cast<const T*>(adj + static_cast<long long>(row) * words);
        T* d = reinterpret_cast<T*>(tile);
        for (long long c = t; c < words / VEC; c += EP_THREADS) d[c] = __ldg(r + c);
      } else {
        for (int i = t; i < bcnt; i += EP_THREADS) {
          const int2 x = __ldg(entries + boff + i);
          tile[x.x] = static_cast<uint32_t>(x.y);
        }
      }
      __syncthreads();
      for (int q = s + warp; q < s + len; q += EP_THREADS / 32) {
        const unsigned int acc = ep_pair_tile<VEC>(adj, words, counts, dense_above,
                                                   offsets, entries, tile,
                                                   s_small[q], lane);
        if (lane == 0) out[s_order[q]] = static_cast<int32_t>(acc);
      }
      __syncthreads();
      if (dense) {
        for (long long i = t; i < tile4; i += EP_THREADS) ep_tile4[i] = make_uint4(0, 0, 0, 0);
      } else {
        for (int i = t; i < bcnt; i += EP_THREADS) tile[__ldg(entries + boff + i).x] = 0u;
      }
      s += len;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(EP_THREADS)
ep_pairs_global(const uint32_t* __restrict__ adj, long long words,
                const int32_t* __restrict__ counts, long long dense_above,
                const long long* __restrict__ offsets,
                const int2* __restrict__ entries, const int32_t* __restrict__ big,
                const int32_t* __restrict__ small,
                const int32_t* __restrict__ order, long long n_pairs,
                int32_t* __restrict__ out) {
  using T = typename EpChunk<VEC>::T;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long q = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       q < n_pairs; q += nwarps) {
    const uint32_t* b = adj + static_cast<long long>(big[q]) * words;
    const int sm = small[q];
    const int scnt = counts[sm];
    unsigned int acc = 0;
    if (scnt > dense_above) {
      const T* s4 = reinterpret_cast<const T*>(adj + static_cast<long long>(sm) * words);
      const T* b4 = reinterpret_cast<const T*>(b);
      for (long long c = lane; c < words / VEC; c += 32)
        acc += ep_and_count(__ldg(s4 + c), __ldg(b4 + c));
    } else {
      const int2* e = entries + offsets[sm];
      for (int i = lane; i < scnt; i += 32) {
        const int2 x = __ldg(e + i);
        acc += __popc(static_cast<uint32_t>(x.y) & __ldg(b + x.x));
      }
    }
    acc = __reduce_add_sync(0xFFFFFFFFu, acc);
    if (lane == 0) out[order[q]] = static_cast<int32_t>(acc);
  }
}

// ---- C interface ----------------------------------------------------------

static bool ep_vec_ok(const void* adj, long long words, int vec) {
  if (vec == 1) return true;
  return vec == 4 && words % 4 == 0 && reinterpret_cast<uintptr_t>(adj) % 16 == 0;
}

// vec: 4 (16-byte chunks; words a multiple of 4, adj 16-byte aligned) or
// 1; masks: int32 [n, mask_words], mask_words = ceil(words / vec / 32)
extern "C" int ft_edge_scan(const void* adj, long long n, long long words,
                            int vec, void* counts, void* masks,
                            long long mask_words, void* stream) {
  if (!ep_vec_ok(adj, words, vec)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned int grid = grid_for(n * 32, EP_THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* a = static_cast<const uint32_t*>(adj);
    if (vec == 4)
      ep_scan<4><<<grid, EP_THREADS, 0, s>>>(a, n, words, static_cast<int32_t*>(counts),
                                             static_cast<uint32_t*>(masks), mask_words);
    else
      ep_scan<1><<<grid, EP_THREADS, 0, s>>>(a, n, words, static_cast<int32_t*>(counts),
                                             static_cast<uint32_t*>(masks), mask_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// offsets: int64 [n + 1], each listed row's first entry; entries: int32
// [offsets[n], 2]
extern "C" int ft_edge_fill(const void* adj, long long n, long long words,
                            int vec, const void* counts, long long dense_above,
                            const void* offsets, const void* masks,
                            long long mask_words, void* entries, void* stream) {
  if (!ep_vec_ok(adj, words, vec)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned int grid = grid_for(n * 32, EP_THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* a = static_cast<const uint32_t*>(adj);
    const int32_t* c = static_cast<const int32_t*>(counts);
    const long long* o = static_cast<const long long*>(offsets);
    const uint32_t* m = static_cast<const uint32_t*>(masks);
    int2* e = static_cast<int2*>(entries);
    if (vec == 4)
      ep_fill<4><<<grid, EP_THREADS, 0, s>>>(a, n, words, c, dense_above, o, m,
                                             mask_words, e);
    else
      ep_fill<1><<<grid, EP_THREADS, 0, s>>>(a, n, words, c, dense_above, o, m,
                                             mask_words, e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
static int ep_launch_pairs(const uint32_t* adj, long long words,
                           const int32_t* counts, long long dense_above,
                           const long long* offsets, const int2* entries,
                           const int32_t* big, const int32_t* small,
                           const int32_t* order, long long n_pairs,
                           int32_t* out, int global_form, cudaStream_t s) {
  const long long tile_bytes = (words + 3) / 4 * 16;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long static_bytes = 3LL * EP_THREADS * 4;
  if (!global_form && tile_bytes + static_bytes <= optin) {
    const int smem = static_cast<int>(tile_bytes);
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(ep_pairs_tile<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ep_pairs_tile<VEC>,
                                                      EP_THREADS, smem) !=
            cudaSuccess || per_sm < 1)
      per_sm = 1;
    const long long n_chunks = (n_pairs + EP_THREADS - 1) / EP_THREADS;
    long long grid = static_cast<long long>(per_sm) * sm_count();
    if (grid > n_chunks) grid = n_chunks;
    ep_pairs_tile<VEC><<<static_cast<unsigned int>(grid), EP_THREADS, smem, s>>>(
        adj, words, counts, dense_above, offsets, entries, big, small, order,
        n_pairs, out);
  } else {
    ep_pairs_global<VEC><<<grid_for(n_pairs * 32, EP_THREADS), EP_THREADS, 0, s>>>(
        adj, words, counts, dense_above, offsets, entries, big, small, order,
        n_pairs, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// big / small / order: int32 [n_pairs], the pairs sorted by big row and
// each pair's index in the caller's order; global_form: 1 forces the
// global form (a probe's comparison), 0 lets the row width decide
extern "C" int ft_edge_popcount(const void* adj, long long words, int vec,
                                const void* counts, long long dense_above,
                                const void* offsets, const void* entries,
                                const void* big, const void* small,
                                const void* order, long long n_pairs, void* out,
                                int global_form, void* stream) {
  if (!ep_vec_ok(adj, words, vec)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs <= 0) return static_cast<int>(cudaGetLastError());
  const uint32_t* a = static_cast<const uint32_t*>(adj);
  const int32_t* c = static_cast<const int32_t*>(counts);
  const long long* o = static_cast<const long long*>(offsets);
  const int2* e = static_cast<const int2*>(entries);
  const int32_t* b = static_cast<const int32_t*>(big);
  const int32_t* sm = static_cast<const int32_t*>(small);
  const int32_t* ord = static_cast<const int32_t*>(order);
  int32_t* r = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return ep_launch_pairs<4>(a, words, c, dense_above, o, e, b, sm, ord, n_pairs,
                              r, global_form, s);
  return ep_launch_pairs<1>(a, words, c, dense_above, o, e, b, sm, ord, n_pairs, r,
                            global_form, s);
}
