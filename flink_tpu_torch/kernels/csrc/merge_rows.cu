// merge_rows: state[dst[i]] (op)= state[src[i]] for i < k, over the rows
// of every component of one state in one launch ([C, row_bytes] each;
// uint8, int32 or float32 elements; op add, min or max per component).
//
// Replaces flink_tpu/state/tpu_backend.py _jit_merge ->
// flink_tpu/ops/device_agg.py merge_slots (Sum/Count/Min/Max/Avg:
// .at[dst].add/min/max(state[src])) and flink_tpu/ops/sketches.py
// HyperLogLogAggregate.merge_slots (.at[dst].max on uint8 registers),
// which tolerate a dst that repeats, and _jit_merge_rows ->
// device_agg.py merge_rows (gather both rows, vmap a pair merge,
// .at[dst].set), whose dst are unique.  The reference jits one merge
// over the whole state dict; here too one merge is one launch, whatever
// the number of components (Count-Min: table and total; Avg: sum and
// count).  One kernel serves both modes: the unique_dst flag selects
// plain stores, else atomics.
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
// The session path's merges are 1 to a few pairs: a launch there is
// host time, which the wrapper and the loader keep short.
//
// Design: the components travel by value in the kernel's parameters (a
// __grid_constant__ array of descriptors); component j is blockIdx.y,
// and its blocks run a grid-stride loop over k * row_words of that
// component.  A word is W = 16 bytes with a unique dst when the rows and
// base allow it (HLL rows: 256 words, so a 256-thread block covers one
// pair with consecutive threads on consecutive 16-byte words), else W =
// 4 bytes: scalar rows, and every row of the atomic mode, where a warp's
// 32 atomics then fall on 128 consecutive bytes (16-byte words spread
// each atomic instruction over 512 B, and at 32 KiB Count-Min rows the
// kernel took 1.65x the time of the same adds in 4-byte words,
// scripts/kernel_probe.py --groups merge_rows).  When every component has
// one dtype, op, mode and width (one component: the common case) the
// launch takes the kernel compiled for it; components of different kinds
// take a kernel whose blocks branch once on their descriptor.
// A 16-byte word is combined as four 32-bit lanes:
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
// 2^31 bytes.  Pairs with a slot outside [0, C) are skipped: -1 is the
// port's skip mark, where XLA's scatter and gather would wrap a slot in
// [-C, -1] to s + C (ops/slot_index.py).
#include "common.cuh"
#include "float_order.cuh"

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
enum { DT_U8 = 0, DT_I32 = 1, DT_F32 = 2 };

// components of one launch: enough for every aggregate of the port (at
// most two today)
#define MR_MAX_COMPONENTS 8

struct MergeComponent {
  void* base;
  long long row_words;   // words of `width` bytes in a row
  long long capacity;    // rows
  int dtype, op, width, pad;
};

struct MergeComponents {
  MergeComponent c[MR_MAX_COMPONENTS];
};

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

// one component's merge: a grid-stride loop over its k * row_words words
template <int DT, int OP, bool UNIQUE, typename W>
__device__ __forceinline__ void merge_component(const MergeComponent& c,
                                                const int32_t* __restrict__ dst,
                                                const int32_t* __restrict__ src,
                                                long long k) {
  constexpr int LANES = sizeof(W) / 4;
  W* __restrict__ base = static_cast<W*>(c.base);
  const long long row_words = c.row_words;
  const long long capacity = c.capacity;
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
__device__ __forceinline__ void merge_mode(const MergeComponent& c,
                                           const int32_t* dst,
                                           const int32_t* src, long long k,
                                           bool unique) {
  if (c.width == 16) merge_component<DT, OP, true, uint4>(c, dst, src, k);
  else if (unique) merge_component<DT, OP, true, unsigned int>(c, dst, src, k);
  else merge_component<DT, OP, false, unsigned int>(c, dst, src, k);
}

template <int DT>
__device__ __forceinline__ void merge_op(const MergeComponent& c,
                                         const int32_t* dst,
                                         const int32_t* src, long long k,
                                         bool unique) {
  switch (c.op) {
    case OP_ADD: merge_mode<DT, OP_ADD>(c, dst, src, k, unique); break;
    case OP_MIN: merge_mode<DT, OP_MIN>(c, dst, src, k, unique); break;
    default: merge_mode<DT, OP_MAX>(c, dst, src, k, unique); break;
  }
}

// every component of the launch has the dtype, op, mode and width of the
// template (one component, the common case): no branch in the kernel
template <int DT, int OP, bool UNIQUE, typename W>
__global__ void __launch_bounds__(256)
merge_rows_same(const __grid_constant__ MergeComponents comps,
                const int32_t* __restrict__ dst,
                const int32_t* __restrict__ src, long long k) {
  merge_component<DT, OP, UNIQUE, W>(comps.c[blockIdx.y], dst, src, k);
}

// components of different kinds (Count-Min's table and total, Avg's sum
// and count): each block branches once on its component's kind
__global__ void __launch_bounds__(256)
merge_rows_mixed(const __grid_constant__ MergeComponents comps,
                 const int32_t* __restrict__ dst,
                 const int32_t* __restrict__ src, long long k, int unique) {
  const MergeComponent& c = comps.c[blockIdx.y];
  switch (c.dtype) {
    case DT_U8: merge_op<DT_U8>(c, dst, src, k, unique != 0); break;
    case DT_I32: merge_op<DT_I32>(c, dst, src, k, unique != 0); break;
    default: merge_op<DT_F32>(c, dst, src, k, unique != 0); break;
  }
}

template <int DT, int OP>
static void launch_same(const MergeComponents& comps, const int32_t* dst,
                        const int32_t* src, long long k, bool unique,
                        int width, dim3 grid, cudaStream_t s) {
  if (width == 16)
    merge_rows_same<DT, OP, true, uint4><<<grid, 256, 0, s>>>(comps, dst, src, k);
  else if (unique)
    merge_rows_same<DT, OP, true, unsigned int><<<grid, 256, 0, s>>>(comps, dst, src, k);
  else
    merge_rows_same<DT, OP, false, unsigned int><<<grid, 256, 0, s>>>(comps, dst, src, k);
}

template <int DT>
static void launch_same_op(const MergeComponents& comps, const int32_t* dst,
                           const int32_t* src, long long k, bool unique,
                           dim3 grid, cudaStream_t s) {
  const MergeComponent& c = comps.c[0];
  switch (c.op) {
    case OP_ADD: launch_same<DT, OP_ADD>(comps, dst, src, k, unique, c.width, grid, s); break;
    case OP_MIN: launch_same<DT, OP_MIN>(comps, dst, src, k, unique, c.width, grid, s); break;
    default: launch_same<DT, OP_MAX>(comps, dst, src, k, unique, c.width, grid, s); break;
  }
}

// args: dst, src (int32 [k] device pointers), k, unique_dst, then 6 long
// longs a component: base, row_bytes, capacity, dtype (0 uint8, 1 int32,
// 2 float32), op (0 add, 1 min, 2 max), width (16 or 4 bytes a word;
// row_bytes a multiple of it; 16 only with unique_dst).  One array, so
// that a call converts three arguments.
extern "C" int ft_merge_rows(const long long* args, int n_comps, void* stream) {
  if (n_comps < 1 || n_comps > MR_MAX_COMPONENTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* dst = reinterpret_cast<const void*>(args[0]);
  const void* src = reinterpret_cast<const void*>(args[1]);
  const long long k = args[2];
  const int unique_dst = args[3] != 0;
  MergeComponents comps = {};
  long long most = 0;
  bool same = true;
  for (int j = 0; j < n_comps; ++j) {
    const long long* d = args + 4 + 6 * j;
    const long long row_bytes = d[1], width = d[5];
    if ((width != 16 && width != 4) || (width == 16 && !unique_dst) ||
        row_bytes < 0 || row_bytes % width != 0 ||
        d[3] < DT_U8 || d[3] > DT_F32 || d[4] < OP_ADD || d[4] > OP_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    MergeComponent& c = comps.c[j];
    c.base = reinterpret_cast<void*>(d[0]);
    c.row_words = row_bytes / width;
    c.capacity = d[2];
    c.dtype = static_cast<int>(d[3]);
    c.op = static_cast<int>(d[4]);
    c.width = static_cast<int>(width);
    if (k * c.row_words > most) most = k * c.row_words;
    same = same && c.dtype == comps.c[0].dtype && c.op == comps.c[0].op &&
           c.width == comps.c[0].width;
  }
  if (most > 0) {
    const dim3 grid(grid_for(most, 256), n_comps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* d = static_cast<const int32_t*>(dst);
    const int32_t* r = static_cast<const int32_t*>(src);
    const bool unique = unique_dst != 0;
    if (!same) {
      merge_rows_mixed<<<grid, 256, 0, s>>>(comps, d, r, k, unique_dst);
    } else {
      switch (comps.c[0].dtype) {
        case DT_U8: launch_same_op<DT_U8>(comps, d, r, k, unique, grid, s); break;
        case DT_I32: launch_same_op<DT_I32>(comps, d, r, k, unique, grid, s); break;
        default: launch_same_op<DT_F32>(comps, d, r, k, unique, grid, s); break;
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
