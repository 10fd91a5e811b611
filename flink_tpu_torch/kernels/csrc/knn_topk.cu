// knn_topk: for each query row i, the indices of the k training points of
// smallest squared distance
//   d2[i, j] = (qn[i] + xn[j]) - 2 * qx[i, j]
// from the GEMM output qx = Q X^T [m, n] and the squared norms qn [m],
// xn [n], in that float32 order, ordered as lax.top_k(-d2, k) orders
// them: by the total order of float32 (a NaN of negative sign before
// -inf, -0 before +0, a NaN of positive sign after +inf, NaNs of one
// sign by their bits), and on equal bits the lower index first.
//
// Replaces flink_tpu/ml/classification.py KNN.kneighbors.nearest
// (:96-102): the distance expression and `lax.top_k(-d2, k)`.  The GEMM
// stays with cuBLAS (torch.matmul in full float32): 2 * qx equals the
// reference's (2 Q) X^T bit for bit, doubling being exact.  The
// product 2 qx is rounded on its own (__fmul_rn: no fused multiply-add,
// which would keep a doubled |qx| above FLT_MAX finite), as the plain
// version rounds it.
//
// Bound on this card: bytes, the m * n floats of qx read once.
//
// Design: a block of TH threads takes a query row, and each thread
// takes 16-byte words of the row, U loaded (streaming, evict-first)
// before any is used.  The row's head (up to its first 16-byte boundary)
// and tail (after its last whole word) are read as single floats; where
// xn's alignment differs from the row's, xn's body is read as floats too.
// Every distance is a candidate key, an unsigned 64-bit word: the
// distance's bits mapped to the total order over the column index, so
// one integer comparison orders by distance, then by index.
// A thread keeps its k best keys in registers, in descending order
// (KMAX slots; those past k hold 0, below every key, so the k-th best is
// always slot 0 and no register is indexed at run time), under a
// threshold: the least k-th best of the warp's lanes, taken by shuffles
// after every U words (a key above it is beaten by k keys of one lane),
// and its float value: a distance above that is rejected by one float
// comparison, in the common case the only work an element costs.  Only
// the rest are keyed and inserted.  Then each thread writes its k keys
// to shared memory, every warp merges its lanes' lists into its k best
// by k rounds of a shuffle minimum (the winning lane steps on), and
// after the block's one barrier warp 0 merges the warp lists the same
// way and writes the k indices.  Bit-equal to knn_topk_plain, a stable
// sort of the same d2 by the same order.
#include <climits>

#include "common.cuh"

typedef unsigned long long knn_key;

#define KNN_NONE 0xFFFFFFFFFFFFFFFFULL  // above every candidate

// the candidate key of distance d at column j: d's bits in the total
// order of float32 over j
__device__ __forceinline__ knn_key knn_key_of(float d, int j) {
  const unsigned int b = __float_as_uint(d);
  const unsigned int o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<knn_key>(o) << 32) | static_cast<unsigned int>(j);
}

// the distance a key holds: a NaN for a NaN distance and for KNN_NONE,
// so neither rejects anything by a float comparison
__device__ __forceinline__ float knn_value_of(knn_key c) {
  const unsigned int o = static_cast<unsigned int>(c >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// the least key over the warp's lanes
__device__ __forceinline__ knn_key knn_warp_min(knn_key w) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const knn_key o = __shfl_xor_sync(0xFFFFFFFFu, w, off);
    w = o < w ? o : w;
  }
  return w;
}

// one row's k best keys of a thread, descending: best[0] is the k-th
// best; slots past k hold 0; thr (<= best[0]) is the threshold a key
// must beat, thr_value its distance
template <int KMAX>
struct KnnList {
  knn_key best[KMAX];
  knn_key thr;
  float thr_value;

  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int p = 0; p < KMAX; ++p) best[p] = p < k ? KNN_NONE : 0ULL;
    thr = KNN_NONE;
    thr_value = __int_as_float(0x7fffffff);
  }

  __device__ __forceinline__ void offer(float d, int j) {
    if (d > thr_value) return;  // false for a NaN d and a NaN thr_value
    const knn_key c = knn_key_of(d, j);
    if (c >= thr) return;
    // drop best[0], put c in its place in the descending order
#pragma unroll
    for (int p = 0; p + 1 < KMAX; ++p) {
      const knn_key lo = c < best[p] ? c : best[p];
      best[p] = lo > best[p + 1] ? lo : best[p + 1];
    }
    best[KMAX - 1] = c < best[KMAX - 1] ? c : best[KMAX - 1];
    thr = best[0] < thr ? best[0] : thr;
    thr_value = knn_value_of(thr);
  }

  // the warp's least k-th best bounds every lane (call warp-uniformly)
  __device__ __forceinline__ void share() {
    thr = knn_warp_min(best[0]);
    thr_value = knn_value_of(thr);
  }
};

// k rounds of a shuffle minimum over lists in shared memory, a list a
// lane (none where `has` is false): lane 0 writes the k least keys, in
// order, through emit(t, key); each list is ascending from its first
// slot (`step` 1) or from its k-th (`step` -1)
template <typename Emit>
__device__ __forceinline__ void knn_merge(const knn_key* mine, bool has, int k,
                                          int step, Emit emit) {
  int pos = step > 0 ? 0 : k - 1;
  for (int t = 0; t < k; ++t) {
    const knn_key c = has && pos >= 0 && pos < k ? mine[pos] : KNN_NONE;
    const knn_key w = knn_warp_min(c);
    if (c == w && w != KNN_NONE) pos += step;
    if ((threadIdx.x & 31) == 0) emit(t, w);
  }
}

template <int KMAX, int U, int TH>
__global__ void __launch_bounds__(TH)
knn_topk_kernel(const float* __restrict__ qx, const float* __restrict__ qn,
                const float* __restrict__ xn, long long m, long long n, int k,
                int32_t* __restrict__ out) {
  constexpr int NW = TH / 32;
  __shared__ knn_key lists[TH * KMAX];      // each thread's, descending
  __shared__ knn_key warp_best[NW * KMAX];  // each warp's, ascending
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x;
  const float q = qn[row];
  const float* rp = qx + row * n;
  KnnList<KMAX> list;
  list.init(k);
  // the row's head: floats up to its first 16-byte boundary
  const long long h = min(
      static_cast<long long>(((16 - (reinterpret_cast<uintptr_t>(rp) & 15)) & 15) >> 2), n);
  const long long words = (n - h) >> 2;
  const long long tail = h + 4 * words;

  // head and tail: at most 3 + 3 single floats
  {
    const long long e = threadIdx.x;
    const long long j = e < h ? e : tail + (e - h);
    if (e < h + (n - tail))
      list.offer((q + __ldg(xn + j)) - __fmul_rn(2.0f, __ldcs(rp + j)), static_cast<int>(j));
  }

  // the body in 16-byte words of qx; xn's words where it shares qx's
  // alignment, else single floats.  The loop runs alike on a warp's
  // lanes (the shuffles of share()).
  const bool xvec = ((reinterpret_cast<uintptr_t>(xn + h) & 15) == 0);
  const float4* x4 = reinterpret_cast<const float4*>(xn + h);
  const float4* q4 = reinterpret_cast<const float4*>(rp + h);
  for (long long g0 = threadIdx.x - lane; g0 < words; g0 += TH * U) {
    float4 xv[U], qv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + lane + static_cast<long long>(u) * TH;
      if (g < words) {
        if (xvec) {
          xv[u] = __ldg(x4 + g);
        } else {
          const float* xs = xn + h + 4 * g;
          xv[u] = make_float4(__ldg(xs), __ldg(xs + 1), __ldg(xs + 2), __ldg(xs + 3));
        }
        qv[u] = __ldcs(q4 + g);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long g = g0 + lane + static_cast<long long>(u) * TH;
      if (g < words) {
        const int j = static_cast<int>(h + 4 * g);
        list.offer((q + xv[u].x) - __fmul_rn(2.0f, qv[u].x), j);
        list.offer((q + xv[u].y) - __fmul_rn(2.0f, qv[u].y), j + 1);
        list.offer((q + xv[u].z) - __fmul_rn(2.0f, qv[u].z), j + 2);
        list.offer((q + xv[u].w) - __fmul_rn(2.0f, qv[u].w), j + 3);
      }
    }
    list.share();
  }

  // each thread's k keys to shared memory; each warp's k best
#pragma unroll
  for (int p = 0; p < KMAX; ++p)
    if (p < k) lists[threadIdx.x * KMAX + p] = list.best[p];
  __syncwarp();
  knn_key* dst = warp_best + warp * KMAX;
  knn_merge(lists + threadIdx.x * KMAX, true, k, -1,
            [&](int t, knn_key w) { dst[t] = w; });
  __syncthreads();
  // warp 0 merges the warp lists, lane w holding warp w's
  if (warp == 0) {
    int32_t* o = out + row * k;
    knn_merge(warp_best + lane * KMAX, lane < NW, k, 1,
              [&](int t, knn_key w) { o[t] = static_cast<int32_t>(w & 0xFFFFFFFFu); });
  }
}

template <int KMAX, int U, int TH>
static void launch(const float* qx, const float* qn, const float* xn,
                   long long m, long long n, int k, int32_t* out,
                   cudaStream_t s) {
  knn_topk_kernel<KMAX, U, TH><<<static_cast<unsigned int>(m), TH, 0, s>>>(
      qx, qn, xn, m, n, k, out);
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
      launch<4, 4, 256>(a, b, c, m, n, k, o, s);
    } else if (k <= 16) {
      launch<16, 4, 256>(a, b, c, m, n, k, o, s);
    } else {
      launch<64, 2, 64>(a, b, c, m, n, k, o, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
