// gram_accumulate: the per-row normal equations of one ALS half-step.
// For each row r of a CSR rating matrix (indptr, cols, vals, rows in
// order), with the fixed side's factors V [n_cols, f]:
//   G[r] = sum over its ratings c of V[c] V[c]^T     (float32 [f, f])
//   b[r] = sum over its ratings c of r_c V[c]        (float32 [f])
//
// Replaces flink_tpu/ml/recommendation.py ALS.fit.solve_side (:52-63):
// `segment_sum(outer, rows)` of the [nnz, f, f] outer products and
// `segment_sum(vals[:, None] * vc, rows)`.  The + lambda I and the
// batched solve stay outside (torch.linalg.solve).
//
// Bound on this card: bytes for small f (each rating reads its column
// index, value and factor row, 8 + 4 f B; each row writes 4 f (f + 1)
// B), operations (2 f (f + 1) a rating) from f of about 40 up.
//
// Design: one block per row, no atomics.  The block loads its ratings
// a tile at a time into shared memory as rows [V[c], r_c] of f + 1
// floats; each thread owns up to ENTRIES entries (i, j) of the
// augmented [f, f + 1] matrix (column f is the right-hand side) and
// adds the tile's products to them in registers, in rating order; the
// block writes G[r] and b[r] once.  G is symmetric bit for bit: entry
// (i, j) and (j, i) add the same products in the same order.
#include "common.cuh"

#define GRAM_MAX_F 64
#define GRAM_THREADS 256
#define GRAM_ENTRIES 17  // ceil(64 * 65 / 256)
#define GRAM_TILE 32

__global__ void __launch_bounds__(GRAM_THREADS)
gram_accumulate_kernel(const float* __restrict__ fixed,
                       const long long* __restrict__ indptr,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ vals, int f,
                       float* __restrict__ grams, float* __restrict__ rhs) {
  __shared__ float tile[GRAM_TILE * (GRAM_MAX_F + 1)];
  const long long r = blockIdx.x;
  const long long lo = indptr[r], hi = indptr[r + 1];
  const int width = f + 1;
  const int n_entries = f * width;
  float acc[GRAM_ENTRIES];
  int ei[GRAM_ENTRIES], ej[GRAM_ENTRIES];
#pragma unroll
  for (int k = 0; k < GRAM_ENTRIES; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    acc[k] = 0.0f;
    ei[k] = e < n_entries ? e / width : 0;
    ej[k] = e < n_entries ? e % width : 0;
  }
  for (long long base = lo; base < hi; base += GRAM_TILE) {
    const int count = static_cast<int>(min(static_cast<long long>(GRAM_TILE),
                                           hi - base));
    for (int t = threadIdx.x; t < count * width; t += blockDim.x) {
      const int c = t / width, k = t % width;
      const long long rating = base + c;
      tile[c * width + k] =
          k < f ? fixed[static_cast<long long>(cols[rating]) * f + k]
                : vals[rating];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GRAM_ENTRIES; ++k) {
      if (threadIdx.x + k * blockDim.x < n_entries) {
        float s = acc[k];
        for (int c = 0; c < count; ++c) {
          s += tile[c * width + ei[k]] * tile[c * width + ej[k]];
        }
        acc[k] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < GRAM_ENTRIES; ++k) {
    if (threadIdx.x + k * blockDim.x < n_entries) {
      if (ej[k] < f) {
        grams[(r * f + ei[k]) * f + ej[k]] = acc[k];
      } else {
        rhs[r * f + ei[k]] = acc[k];
      }
    }
  }
}

extern "C" int ft_gram_accumulate(const void* fixed, const void* indptr,
                                  const void* cols, const void* vals,
                                  long long n_rows, int f, void* grams,
                                  void* rhs, void* stream) {
  if (f < 1 || f > GRAM_MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    int threads = ((f * (f + 1) + 31) / 32) * 32;
    if (threads > GRAM_THREADS) threads = GRAM_THREADS;
    gram_accumulate_kernel<<<static_cast<unsigned int>(n_rows), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(fixed),
        static_cast<const long long*>(indptr),
        static_cast<const int32_t*>(cols), static_cast<const float*>(vals), f,
        static_cast<float*>(grams), static_cast<float*>(rhs));
  }
  return static_cast<int>(cudaGetLastError());
}
