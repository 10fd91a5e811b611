// scatter_combine: masked scatter-add / -min / -max of one value column
// into a [C] float32 or int32 state component.
//
// Replaces flink_tpu/streaming/vectorized.py make_masked_update ->
// flink_tpu/ops/device_agg.py Sum/Count/Min/Max/Avg .update:
// state[slot] (+|min|max)= value for rows [0, n); Count (and Avg's
// count) adds 1 per row, passed here as values == nullptr.
//
// Bound on this card: bytes.  Each row reads 8 B (int32 slot, 4 B
// value) and does one random 4 B read-modify-write of the state.
//
// Design: one thread per live row over a grid-stride loop.  atomicAdd
// for float32 and int32, atomicMin / atomicMax for int32, and an
// atomicCAS loop for float32 min and max (Hopper has no float min/max
// atomic) that exits without writing once the stored value already
// wins.  Slots outside [0, C) are dropped, as XLA drops out-of-bounds
// scatter rows.  Float atomics add in an order that changes from run
// to run, so float sums are exact only on integer-valued data below
// 2^24; integer results and min/max are exact.
#include "common.cuh"

enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };

__device__ __forceinline__ void combine(float* p, float v, int op) {
  if (op == OP_ADD) {
    atomicAdd(p, v);
    return;
  }
  int* word = reinterpret_cast<int*>(p);
  int old = *reinterpret_cast<volatile int*>(word);
  while (op == OP_MIN ? v < __int_as_float(old) : v > __int_as_float(old)) {
    const int prev = atomicCAS(word, old, __float_as_int(v));
    if (prev == old) break;
    old = prev;
  }
}

__device__ __forceinline__ void combine(int* p, int v, int op) {
  if (op == OP_ADD) {
    atomicAdd(p, v);
  } else if (op == OP_MIN) {
    atomicMin(p, v);
  } else {
    atomicMax(p, v);
  }
}

template <typename T>
__global__ void scatter_combine_kernel(T* __restrict__ state,
                                       const int32_t* __restrict__ slots,
                                       const T* __restrict__ values,
                                       long long n, long long capacity,
                                       int op) {
  FT_GRID_STRIDE(i, n) {
    const long long slot = slots[i];
    if (slot < 0 || slot >= capacity) continue;
    const T v = values != nullptr ? values[i] : static_cast<T>(1);
    combine(state + slot, v, op);
  }
}

// dtype: 0 = float32, 1 = int32.  op: 0 add, 1 min, 2 max.
extern "C" int ft_scatter_combine(void* state, const void* slots,
                                  const void* values, long long n,
                                  long long capacity, int dtype, int op,
                                  void* stream) {
  if (op < OP_ADD || op > OP_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int threads = 256;
    const unsigned int grid = grid_for(n, threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
      scatter_combine_kernel<float><<<grid, threads, 0, s>>>(
          static_cast<float*>(state), static_cast<const int32_t*>(slots),
          static_cast<const float*>(values), n, capacity, op);
    } else if (dtype == 1) {
      scatter_combine_kernel<int><<<grid, threads, 0, s>>>(
          static_cast<int*>(state), static_cast<const int32_t*>(slots),
          static_cast<const int*>(values), n, capacity, op);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
