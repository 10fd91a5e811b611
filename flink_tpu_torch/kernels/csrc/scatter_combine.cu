// scatter_combine: masked scatter-add / -min / -max of one value column
// into a [C] float32 or int32 state component.
//
// Replaces flink_tpu/streaming/vectorized.py make_masked_update ->
// flink_tpu/ops/device_agg.py Sum/Count/Min/Max/Avg .update:
// state[slot] (+|min|max)= value for rows [0, n); Count (and Avg's
// count) adds 1 per row, passed here as values == nullptr.  Also the
// combine of the graph iteration models (flink_tpu/graph/iterations.py
// segment_sum/min/max into a state filled with the identity).
//
// Bound on this card: bytes.  Each row reads 8 B (int32 slot, 4 B
// value) and does one random 4 B read-modify-write of the state, which
// the L2 absorbs; the state is touched once per distinct slot.
//
// Design.  8 rows a thread: two 16-byte loads of slots and two of values
// (streaming loads, so the state keeps the L2), then the rows' updates
// issued back to back so that they are in flight together.  The grid is
// sized to the card (at most 8 blocks of 256 threads per SM), each thread
// walking the rows in a grid-stride loop.  Rows before the first
// 16-byte-aligned row and after the last full group of 4 go one per
// thread; a values column whose alignment differs from the slots' goes one
// row per thread throughout.  Slots outside [0, C) are dropped, as XLA
// drops out-of-bounds scatter rows.
//
// What limits it is the L2's atomics, not bytes: add issues one atomicAdd
// per row.  Min and max first load the 8 rows' state words (L2 loads, in
// flight together) and issue one atomic only for a row whose value beats
// what its load saw: atomicMin / atomicMax for int32, float_order.cuh's
// one-atomic min / max for float32 (NaN wins, -0 < +0, as the reference).
// The state only moves toward the winner, so a stale load lets an atomic
// through and never holds one back; most rows of a min over many rows per
// slot issue none.
//
// Float atomics add in an order that changes from run to run, so float
// sums are exact only on integer-valued data below 2^24; integer results
// and min / max are exact.
#include "common.cuh"
#include "float_order.cuh"

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

#define SC_THREADS 256
#define SC_BLOCKS_PER_SM 8

template <typename T>
__device__ __forceinline__ T sc_bits(unsigned int b);
template <>
__device__ __forceinline__ float sc_bits<float>(unsigned int b) {
  return __uint_as_float(b);
}
template <>
__device__ __forceinline__ int sc_bits<int>(unsigned int b) {
  return static_cast<int>(b);
}

// the bits of a count's 1
template <typename T>
__device__ __forceinline__ unsigned int sc_one();
template <>
__device__ __forceinline__ unsigned int sc_one<float>() { return 0x3F800000u; }
template <>
__device__ __forceinline__ unsigned int sc_one<int>() { return 1u; }


// a min / max: the atomic when v beats cur, a load of *p made before
template <int OP>
__device__ __forceinline__ void sc_update(float* p, unsigned int v, unsigned int cur) {
  fo_atomic<OP == OP_MIN>(reinterpret_cast<unsigned int*>(p), v, cur);
}

template <int OP>
__device__ __forceinline__ void sc_update(int* p, unsigned int v, unsigned int cur) {
  const int x = static_cast<int>(v), c = static_cast<int>(cur);
  if (OP == OP_MIN) {
    if (x < c) atomicMin(p, x);
  } else if (x > c) {
    atomicMax(p, x);
  }
}

// R rows' updates: for min / max the state words are loaded first, all
// R loads in flight, then an atomic for each row that beats its load.
template <typename T, int OP, int R>
__device__ __forceinline__ void sc_rows(T* __restrict__ state, const int* slot,
                                        const unsigned int* bits,
                                        long long capacity) {
  bool live[R];
#pragma unroll
  for (int k = 0; k < R; ++k) live[k] = slot[k] >= 0 && slot[k] < capacity;
  if (OP == OP_ADD) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (live[k]) atomicAdd(state + slot[k], sc_bits<T>(bits[k]));
    return;
  }
  unsigned int cur[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    cur[k] = live[k] ? __ldcg(reinterpret_cast<const unsigned int*>(state) + slot[k]) : 0u;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (live[k]) sc_update<OP>(state + slot[k], bits[k], cur[k]);
}

// rows [0, head) and [head + 4 * nvec, n) one per thread; the body
// [head, head + 4 * nvec) as 16-byte groups of 4 rows, two a thread a step
template <typename T, int OP>
__global__ void __launch_bounds__(SC_THREADS)
scatter_combine_kernel(T* __restrict__ state, const int32_t* __restrict__ slots,
                       const T* __restrict__ values, long long n,
                       long long capacity, long long head, long long nvec) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tail0 = head + 4 * nvec;
  const long long loose = head + (n - tail0);
  const unsigned int one = sc_one<T>();
  for (long long r = tid; r < loose; r += stride) {
    const long long i = r < head ? r : tail0 + (r - head);
    const int slot = slots[i];
    const unsigned int bits =
        values != nullptr ? reinterpret_cast<const unsigned int*>(values)[i] : one;
    sc_rows<T, OP, 1>(state, &slot, &bits, capacity);
  }
  const int4* s4 = reinterpret_cast<const int4*>(slots + head);
  const uint4* v4 =
      values != nullptr ? reinterpret_cast<const uint4*>(values + head) : nullptr;
  for (long long g0 = tid; g0 < nvec; g0 += 2 * stride) {
    const long long g1 = g0 + stride;
    const bool l1 = g1 < nvec;
    int4 sa = __ldcs(s4 + g0), sb = make_int4(-1, -1, -1, -1);
    uint4 va = make_uint4(one, one, one, one), vb = va;
    if (l1) sb = __ldcs(s4 + g1);
    if (v4 != nullptr) {
      va = __ldcs(v4 + g0);
      if (l1) vb = __ldcs(v4 + g1);
    }
    const int slot[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    const unsigned int bits[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
    sc_rows<T, OP, 8>(state, slot, bits, capacity);
  }
}

template <typename T, int OP>
static void sc_launch(void* state, const void* slots, const void* values,
                      long long n, long long capacity, long long head,
                      long long nvec, cudaStream_t s) {
  // threads wanted: two groups of 4 a thread, plus the loose rows
  const long long work = nvec / 2 + (n - 4 * nvec) + 1;
  long long blocks = (work + SC_THREADS - 1) / SC_THREADS;
  const long long cap = static_cast<long long>(sm_count()) * SC_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  T* st = static_cast<T*>(state);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  const T* va = static_cast<const T*>(values);
  scatter_combine_kernel<T, OP><<<grid, SC_THREADS, 0, s>>>(
      st, sl, va, n, capacity, head, nvec);
}

template <typename T>
static int sc_launch_op(int op, void* state, const void* slots,
                        const void* values, long long n, long long capacity,
                        long long head, long long nvec, cudaStream_t s) {
  switch (op) {
    case OP_ADD: sc_launch<T, OP_ADD>(state, slots, values, n, capacity, head, nvec, s); return 0;
    case OP_MIN: sc_launch<T, OP_MIN>(state, slots, values, n, capacity, head, nvec, s); return 0;
    case OP_MAX: sc_launch<T, OP_MAX>(state, slots, values, n, capacity, head, nvec, s); return 0;
    default: return 1;
  }
}

// dtype: 0 = float32, 1 = int32.  op: 0 add, 1 min, 2 max.
extern "C" int ft_scatter_combine(void* state, const void* slots,
                                  const void* values, long long n,
                                  long long capacity, int dtype, int op,
                                  void* stream) {
  if (op < OP_ADD || op > OP_MAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    // the body starts at the first row whose slot is 16-byte aligned;
    // values must then be aligned at the same row
    const unsigned long long a = reinterpret_cast<unsigned long long>(slots);
    long long head = static_cast<long long>(((16 - a % 16) % 16) / 4);
    if (a % 4 != 0 ||
        (values != nullptr &&
         (reinterpret_cast<unsigned long long>(values) - a) % 16 != 0))
      head = n;
    if (head > n) head = n;
    const long long nvec = (n - head) / 4;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int bad = dtype == 0
        ? sc_launch_op<float>(op, state, slots, values, n, capacity, head, nvec, s)
        : sc_launch_op<int>(op, state, slots, values, n, capacity, head, nvec, s);
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
