// knn_topk: for each query row i, the indices of the k training points of
// smallest squared distance
//   d2[i, j] = (qn[i] + xn[j]) - 2 * qx[i, j]
// from the GEMM output qx = Q X^T [m, n] and the squared norms qn [m],
// xn [n], in that float32 order; on equal distances the lower index
// comes first (the tie rule of lax.top_k).
//
// Replaces flink_tpu/ml/classification.py KNN.kneighbors.nearest
// (:96-102): the distance expression and `lax.top_k(-d2, k)`.  The GEMM
// stays with cuBLAS (torch.matmul in full float32): 2 * qx equals the
// reference's (2 Q) X^T bit for bit, doubling being exact.
//
// Bound on this card: bytes, the m * n floats of qx read once.
//
// Design: one block per query row.  Each thread scans the columns
// j = threadIdx.x, + blockDim.x, ... in increasing order and keeps its k
// best (d2, j) pairs sorted in registers, compared lexicographically
// (a NaN distance never enters); then k rounds of a block-wide
// lexicographic argmin over the threads' list heads pick the row's k
// in order.  Bit-equal to a stable sort of the same d2.
#include <climits>

#include "common.cuh"

#define KNN_THREADS 256

__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

template <int KMAX>
__global__ void __launch_bounds__(KNN_THREADS)
knn_topk_kernel(const float* __restrict__ qx, const float* __restrict__ qn,
                const float* __restrict__ xn, long long n, int k,
                int32_t* __restrict__ out) {
  __shared__ float red_d[KNN_THREADS / 32];
  __shared__ int red_i[KNN_THREADS / 32];
  __shared__ int red_t[KNN_THREADS / 32];
  __shared__ int winner;
  const long long row = blockIdx.x;
  const float q = qn[row];
  const float* r = qx + row * n;
  const float inf = __int_as_float(0x7f800000);
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    bd[p] = inf;
    bi[p] = INT_MAX;
  }
  for (long long j = threadIdx.x; j < n; j += blockDim.x) {
    float cd = (q + __ldg(xn + j)) - 2.0f * __ldg(r + j);
    int ci = static_cast<int>(j);
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k && lex_less(cd, ci, bd[p], bi[p])) {
        const float td = bd[p];
        const int ti = bi[p];
        bd[p] = cd;
        bi[p] = ci;
        cd = td;
        ci = ti;
      }
    }
  }
  // k rounds: the block's lexicographic minimum of the list heads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int round = 0; round < k; ++round) {
    float d = bd[0];
    int i = bi[0], t = threadIdx.x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(0xffffffffu, d, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      const int ot = __shfl_down_sync(0xffffffffu, t, off);
      if (lex_less(od, oi, d, i)) {
        d = od;
        i = oi;
        t = ot;
      }
    }
    if (lane == 0) {
      red_d[warp] = d;
      red_i[warp] = i;
      red_t[warp] = t;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < n_warps; ++w) {
        if (lex_less(red_d[w], red_i[w], d, i)) {
          d = red_d[w];
          i = red_i[w];
          t = red_t[w];
        }
      }
      out[row * k + round] = i;
      winner = t;
    }
    __syncthreads();
    if (threadIdx.x == winner) {  // pop the head
#pragma unroll
      for (int p = 0; p + 1 < KMAX; ++p) {
        bd[p] = bd[p + 1];
        bi[p] = bi[p + 1];
      }
      bd[KMAX - 1] = inf;
      bi[KMAX - 1] = INT_MAX;
    }
    __syncthreads();
  }
}

template <int KMAX>
static void launch(const float* qx, const float* qn, const float* xn,
                   long long m, long long n, int k, int32_t* out,
                   cudaStream_t s) {
  knn_topk_kernel<KMAX><<<static_cast<unsigned int>(m), KNN_THREADS, 0, s>>>(
      qx, qn, xn, n, k, out);
}

// k must lie in [1, min(n, 64)]
extern "C" int ft_knn_topk(const void* qx, const void* qn, const void* xn,
                           long long m, long long n, int k, void* out,
                           void* stream) {
  if (k < 1 || k > 64 || k > n || n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > 0) {
    const float* a = static_cast<const float*>(qx);
    const float* b = static_cast<const float*>(qn);
    const float* c = static_cast<const float*>(xn);
    int32_t* o = static_cast<int32_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k <= 4) {
      launch<4>(a, b, c, m, n, k, o, s);
    } else if (k <= 16) {
      launch<16>(a, b, c, m, n, k, o, s);
    } else {
      launch<64>(a, b, c, m, n, k, o, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
