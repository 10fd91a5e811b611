// merge_rows: state[dst[i]] (op)= state[src[i]] for i < k, over the rows
// of one [C, row_bytes] state component (uint8, int32 or float32
// elements; op add, min or max).
//
// Replaces flink_tpu/state/tpu_backend.py _jit_merge ->
// flink_tpu/ops/device_agg.py merge_slots (Sum/Count/Min/Max/Avg:
// .at[dst].add/min/max(state[src])) and flink_tpu/ops/sketches.py
// HyperLogLogAggregate.merge_slots (.at[dst].max on uint8 registers),
// which tolerate a dst that repeats, and _jit_merge_rows ->
// device_agg.py merge_rows (gather both rows, vmap a pair merge,
// .at[dst].set), whose dst are unique.  One kernel serves both: the
// unique_dst flag selects plain stores, else atomics.
//
// Precondition (the caller's, not checked here): no src row is also a
// dst row in the same call.  The reference reads every src from the
// state as it was before the call; with src and dst disjoint the
// src rows do not change during the call, so the kernel reads them
// with plain loads and gives the same answer.  The backend never
// passes such a pair (it frees source slots that equal the target).
//
// Bound on this card: bytes.  Each pair reads two rows and writes one
// (3 x 4096 B for an HLL row at precision 12) and reads 8 B of indices.
//
// Design: a grid-stride loop over k * row_words, where a word is W =
// 16 bytes when the row and the base allow it (HLL rows: 256 words, so
// a 256-thread block covers one pair with consecutive threads on
// consecutive 16-byte words) or W = 4 bytes (scalar Sum/Count/Min/Max
// rows).  A 16-byte word is combined as four 32-bit lanes:
// __vmaxu4/__vminu4/__vadd4 for uint8 bytes, integer or float
// arithmetic for int32/float32.  Unique dst: load both words, combine,
// store.  Repeated dst: atomicAdd/atomicMin/atomicMax for int32,
// atomicAdd for float32 add, float_order.cuh's min/max for float32 (a
// load, then one atomic if the src lane beats it), and an atomicCAS loop on the 32-bit lane for uint8 min/max
// (Hopper has no byte atomics; a lane the combine leaves unchanged costs
// one load and no atomic).  float32 min/max follow the reference's order
// (NaN wins, -0 < +0) in both modes.  Integer
// adds wrap, as XLA's do.  Float adds with a repeated dst run in an
// order that changes from run to run.  Addressing is 64-bit
// ((int64)slot * row_words): at 2^20 slots x 4096 B the file is past
// 2^31 bytes.  Pairs with a slot outside [0, C) are skipped.
#include "common.cuh"
#include "float_order.cuh"

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
enum { DT_U8 = 0, DT_I32 = 1, DT_F32 = 2 };

template <int DT, int OP>
__device__ __forceinline__ unsigned int combine(unsigned int a,
                                                unsigned int b) {
  if (DT == DT_U8) {
    if (OP == OP_MAX) return __vmaxu4(a, b);
    if (OP == OP_MIN) return __vminu4(a, b);
    return __vadd4(a, b);
  } else if (DT == DT_I32) {
    const int x = static_cast<int>(a), y = static_cast<int>(b);
    if (OP == OP_MAX) return static_cast<unsigned int>(x > y ? x : y);
    if (OP == OP_MIN) return static_cast<unsigned int>(x < y ? x : y);
    return a + b;
  } else {
    if (OP == OP_MAX) return fo_pick<false>(a, b);
    if (OP == OP_MIN) return fo_pick<true>(a, b);
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
}

// dst lane (op)= v when other threads may update the same lane
template <int DT, int OP>
__device__ __forceinline__ void combine_atomic(unsigned int* p,
                                               unsigned int v) {
  if (DT == DT_I32) {
    int* q = reinterpret_cast<int*>(p);
    const int x = static_cast<int>(v);
    if (OP == OP_ADD) atomicAdd(q, x);
    else if (OP == OP_MIN) atomicMin(q, x);
    else atomicMax(q, x);
    return;
  }
  if (DT == DT_F32) {
    if (OP == OP_ADD) atomicAdd(reinterpret_cast<float*>(p), __uint_as_float(v));
    else fo_atomic<OP == OP_MIN>(p, v, __ldcg(p));
    return;
  }
  unsigned int old = *reinterpret_cast<volatile unsigned int*>(p);
  while (true) {
    const unsigned int next = combine<DT, OP>(old, v);
    if (next == old) break;
    const unsigned int prev = atomicCAS(p, old, next);
    if (prev == old) break;
    old = prev;
  }
}

template <int DT, int OP, bool UNIQUE, typename W>
__global__ void merge_rows_kernel(W* __restrict__ base,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ src,
                                  long long k, long long row_words,
                                  long long capacity) {
  constexpr int LANES = sizeof(W) / 4;
  FT_GRID_STRIDE(i, k * row_words) {
    const long long r = i / row_words;
    const long long w = i - r * row_words;
    const long long d = dst[r];
    const long long s = src[r];
    if (d < 0 || d >= capacity || s < 0 || s >= capacity) continue;
    W* out = base + d * row_words + w;
    W sv = base[s * row_words + w];
    const unsigned int* sl = reinterpret_cast<const unsigned int*>(&sv);
    if (UNIQUE) {
      W dv = *out;
      unsigned int* dl = reinterpret_cast<unsigned int*>(&dv);
#pragma unroll
      for (int j = 0; j < LANES; ++j) dl[j] = combine<DT, OP>(dl[j], sl[j]);
      *out = dv;
    } else {
      unsigned int* dl = reinterpret_cast<unsigned int*>(out);
#pragma unroll
      for (int j = 0; j < LANES; ++j) combine_atomic<DT, OP>(dl + j, sl[j]);
    }
  }
}

template <int DT, int OP>
static void launch(void* base, const void* dst, const void* src, long long k,
                   long long row_bytes, long long capacity, bool unique,
                   int width, cudaStream_t s) {
  const int threads = 256;
  const long long row_words = row_bytes / width;
  const unsigned int grid = grid_for(k * row_words, threads);
  const int32_t* d = static_cast<const int32_t*>(dst);
  const int32_t* r = static_cast<const int32_t*>(src);
  if (width == 16) {
    uint4* b = static_cast<uint4*>(base);
    if (unique)
      merge_rows_kernel<DT, OP, true, uint4><<<grid, threads, 0, s>>>(
          b, d, r, k, row_words, capacity);
    else
      merge_rows_kernel<DT, OP, false, uint4><<<grid, threads, 0, s>>>(
          b, d, r, k, row_words, capacity);
  } else {
    unsigned int* b = static_cast<unsigned int*>(base);
    if (unique)
      merge_rows_kernel<DT, OP, true, unsigned int><<<grid, threads, 0, s>>>(
          b, d, r, k, row_words, capacity);
    else
      merge_rows_kernel<DT, OP, false, unsigned int><<<grid, threads, 0, s>>>(
          b, d, r, k, row_words, capacity);
  }
}

template <int DT>
static int launch_op(int op, void* base, const void* dst, const void* src,
                     long long k, long long row_bytes, long long capacity,
                     bool unique, int width, cudaStream_t s) {
  switch (op) {
    case OP_ADD:
      launch<DT, OP_ADD>(base, dst, src, k, row_bytes, capacity, unique,
                         width, s);
      return 0;
    case OP_MIN:
      launch<DT, OP_MIN>(base, dst, src, k, row_bytes, capacity, unique,
                         width, s);
      return 0;
    case OP_MAX:
      launch<DT, OP_MAX>(base, dst, src, k, row_bytes, capacity, unique,
                         width, s);
      return 0;
    default:
      return 1;
  }
}

// dtype: 0 uint8, 1 int32, 2 float32; op: 0 add, 1 min, 2 max;
// width: 16 or 4 bytes per word (row_bytes must be a multiple of it).
extern "C" int ft_merge_rows(void* base, const void* dst, const void* src,
                             long long k, long long row_bytes,
                             long long capacity, int dtype, int op,
                             int unique_dst, int width, void* stream) {
  if ((width != 16 && width != 4) || row_bytes % width != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0 && row_bytes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool unique = unique_dst != 0;
    int bad = 1;
    switch (dtype) {
      case DT_U8:
        bad = launch_op<DT_U8>(op, base, dst, src, k, row_bytes, capacity,
                               unique, width, s);
        break;
      case DT_I32:
        bad = launch_op<DT_I32>(op, base, dst, src, k, row_bytes, capacity,
                                unique, width, s);
        break;
      case DT_F32:
        bad = launch_op<DT_F32>(op, base, dst, src, k, row_bytes, capacity,
                                unique, width, s);
        break;
    }
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
