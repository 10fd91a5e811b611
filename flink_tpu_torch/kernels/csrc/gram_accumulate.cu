// gram_accumulate: the per-row normal equations of one ALS half-step.
// For each row r of a CSR rating matrix (cols, vals grouped by row),
// with the fixed side's factors V [n_cols, f]:
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
// Design: the work is a plan (kernels/gram_accumulate.py gram_plan,
// built once per fit and side): every row's ratings cut into chunks of
// at most W, a chunk never crossing a row, an empty row one empty
// chunk.  A row of one chunk is written by that chunk; the chunks of a
// heavier row (the item side's Zipf head: 252,199 ratings in one row)
// spread over the card and write partial sums into a plan-sized
// workspace, which a second launch sums in chunk order.  No atomics:
// two calls give the same bits.
// - f <= 16 (the path's f = 10): a warp a chunk, F a template
//   parameter.  Lane j takes the chunk's ratings j, j + 32, ... in
//   order, loads each factor row with vector loads (the factor tables
//   are L2-resident) and adds its upper triangle and right-hand side,
//   F (F + 1) / 2 + F sums, to accumulators in its registers, with
//   GRAM_UNROLL ratings' loads in flight (half as many from F = 13 on).
//   The 32 lanes' sums meet in shared memory (a lane's row at an odd
//   stride) and each output
//   entry is their sum in a fixed order (four chains of eight lanes);
//   G[i][j] and G[j][i] read the same packed entry, so G is symmetric
//   bit for bit.
// - 16 < f <= 64: a block a chunk loads its ratings a tile at a time
//   into shared memory as rows [V[c], r_c] of f + 1 floats; each thread
//   owns up to GRAM_ENTRIES entries (i, j) of the augmented [f, f + 1]
//   matrix (column f is the right-hand side) and adds the tile's
//   products in registers, in rating order.  Entries (i, j) and (j, i)
//   add the same products in the same order.
// A partial is the packed upper triangle then the right-hand side,
// F (F + 1) / 2 + F floats, the combine mirrors it like the warp path.
#include "common.cuh"

#define GRAM_MAX_F 64
#define GRAM_THREADS 256
#define GRAM_ENTRIES 17  // ceil(64 * 65 / 256)
#define GRAM_TILE 32
#define GRAM_UNROLL 4  // ratings a lane loads at once on the small-f path

// chunks (warps) a block on the small-f path: the lanes' sums of a
// warp take 32 (F (F + 1) / 2 + F) floats of shared memory, and a
// block's static shared memory stays under 48 KB
__host__ __device__ constexpr int gram_warps(int F) { return F <= 12 ? 4 : 2; }

// packed index of (i, j), i <= j < f, in the upper triangle by rows
__host__ __device__ __forceinline__ int gram_packed(int i, int j, int f) {
  return i * f - i * (i - 1) / 2 + (j - i);
}

template <int F>
struct GramLoad {
  // factor row c (zeros for c < 0) in the widest aligned vector loads
  static __device__ __forceinline__ void row(const float* __restrict__ fixed, int c,
                                             float (&x)[F]) {
    if (c < 0) {
#pragma unroll
      for (int i = 0; i < F; ++i) x[i] = 0.0f;
      return;
    }
    const float* p = fixed + static_cast<long long>(c) * F;
    if constexpr (F % 4 == 0) {
#pragma unroll
      for (int i = 0; i < F; i += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
        x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
      }
    } else if constexpr (F % 2 == 0) {
#pragma unroll
      for (int i = 0; i < F; i += 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p + i));
        x[i] = v.x; x[i + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < F; ++i) x[i] = __ldg(p + i);
    }
  }
};

// Entry e summed over the 32 lanes' rows of `sums` in a fixed order:
// lanes 8k .. 8k + 7 in order for each k (four chains in flight), then
// (k0 + k1) + (k2 + k3).
template <int STRIDE>
__device__ __forceinline__ float gram_lane_sum(const float* sums, int e) {
  float part[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) part[k] = 0.0f;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
#pragma unroll
    for (int k = 0; k < 4; ++k) part[k] += sums[(8 * k + l) * STRIDE + e];
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

template <int F>
__global__ void __launch_bounds__(gram_warps(F) * 32)
gram_small_kernel(const float* __restrict__ fixed, const int32_t* __restrict__ cols,
                  const float* __restrict__ vals, const int32_t* __restrict__ chunk_row,
                  const long long* __restrict__ chunk_span,
                  const int32_t* __restrict__ chunk_part, long long n_chunks,
                  float* __restrict__ grams, float* __restrict__ rhs,
                  float* __restrict__ partial) {
  constexpr int TRI = F * (F + 1) / 2;
  constexpr int NE = TRI + F;
  constexpr int STRIDE = NE | 1;  // odd: lane l's entry e in bank (l * STRIDE + e) % 32
  constexpr int UNROLL = F <= 12 ? GRAM_UNROLL : GRAM_UNROLL / 2;
  constexpr int WARPS = gram_warps(F);
  __shared__ float red[WARPS][32 * STRIDE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chunk = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (chunk >= n_chunks) return;
  const long long lo = chunk_span[2 * chunk], hi = chunk_span[2 * chunk + 1];
  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.0f;
  for (long long base = lo + lane; base < hi; base += 32 * UNROLL) {
    int c[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = base + 32 * u;
      c[u] = k < hi ? cols[k] : -1;
      v[u] = k < hi ? vals[k] : 0.0f;
    }
    float x[UNROLL][F];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) GramLoad<F>::row(fixed, c[u], x[u]);
    // a rating past the chunk adds 0 * 0 + 0: every sum stays exact
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int e = 0;
#pragma unroll
      for (int i = 0; i < F; ++i) {
#pragma unroll
        for (int j = i; j < F; ++j, ++e) acc[e] = fmaf(x[u][i], x[u][j], acc[e]);
      }
#pragma unroll
      for (int i = 0; i < F; ++i) acc[TRI + i] = fmaf(v[u], x[u][i], acc[TRI + i]);
    }
  }
  float* mine = red[warp];
#pragma unroll
  for (int e = 0; e < NE; ++e) mine[lane * STRIDE + e] = acc[e];
  __syncwarp();
  const int part = chunk_part[chunk];
  if (part < 0) {
    const long long r = chunk_row[chunk];
    for (int p = lane; p < F * F + F; p += 32) {
      int e;
      if (p < F * F) {
        const int i = p / F, j = p - (p / F) * F;
        e = i <= j ? gram_packed(i, j, F) : gram_packed(j, i, F);
      } else {
        e = TRI + (p - F * F);
      }
      const float s = gram_lane_sum<STRIDE>(mine, e);
      if (p < F * F) grams[r * (F * F) + p] = s;
      else rhs[r * F + (p - F * F)] = s;
    }
  } else {
    float* out = partial + static_cast<long long>(part) * NE;
    for (int e = lane; e < NE; e += 32) out[e] = gram_lane_sum<STRIDE>(mine, e);
  }
}

__global__ void __launch_bounds__(GRAM_THREADS)
gram_large_kernel(const float* __restrict__ fixed, const int32_t* __restrict__ cols,
                  const float* __restrict__ vals, const int32_t* __restrict__ chunk_row,
                  const long long* __restrict__ chunk_span,
                  const int32_t* __restrict__ chunk_part, int f,
                  float* __restrict__ grams, float* __restrict__ rhs,
                  float* __restrict__ partial) {
  __shared__ float tile[GRAM_TILE * (GRAM_MAX_F + 1)];
  const long long chunk = blockIdx.x;
  const long long lo = chunk_span[2 * chunk], hi = chunk_span[2 * chunk + 1];
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
  const int part = chunk_part[chunk];
  const long long r = chunk_row[chunk];
  const int tri = f * (f + 1) / 2;
  float* out = partial + static_cast<long long>(part < 0 ? 0 : part) * (tri + f);
#pragma unroll
  for (int k = 0; k < GRAM_ENTRIES; ++k) {
    if (threadIdx.x + k * blockDim.x < n_entries) {
      if (part < 0) {
        if (ej[k] < f) grams[(r * f + ei[k]) * f + ej[k]] = acc[k];
        else rhs[r * f + ei[k]] = acc[k];
      } else if (ej[k] == f) {
        out[tri + ei[k]] = acc[k];
      } else if (ej[k] >= ei[k]) {
        out[gram_packed(ei[k], ej[k], f)] = acc[k];
      }
    }
  }
}

// Rows of several chunks: each output entry the sum of the row's
// partials in chunk order, G mirrored from the packed triangle.
__global__ void __launch_bounds__(GRAM_THREADS)
gram_combine_kernel(const float* __restrict__ partial,
                    const int32_t* __restrict__ split_row,
                    const int32_t* __restrict__ split_ptr, int f,
                    float* __restrict__ grams, float* __restrict__ rhs) {
  const long long r = split_row[blockIdx.x];
  const int first = split_ptr[blockIdx.x], last = split_ptr[blockIdx.x + 1];
  const int tri = f * (f + 1) / 2, ne = tri + f;
  for (int p = threadIdx.x; p < f * f + f; p += blockDim.x) {
    int e;
    if (p < f * f) {
      const int i = p / f, j = p % f;
      e = i <= j ? gram_packed(i, j, f) : gram_packed(j, i, f);
    } else {
      e = tri + (p - f * f);
    }
    float s = 0.0f;
    for (int k = first; k < last; ++k) s += partial[static_cast<long long>(k) * ne + e];
    if (p < f * f) grams[r * f * f + p] = s;
    else rhs[r * f + (p - f * f)] = s;
  }
}

template <int F>
static void gram_small_launch(const float* fixed, const int32_t* cols, const float* vals,
                              const int32_t* chunk_row, const long long* chunk_span,
                              const int32_t* chunk_part, long long n_chunks,
                              float* grams, float* rhs, float* partial,
                              cudaStream_t stream) {
  constexpr int WARPS = gram_warps(F);
  const long long blocks = (n_chunks + WARPS - 1) / WARPS;
  gram_small_kernel<F><<<static_cast<unsigned int>(blocks), WARPS * 32, 0, stream>>>(
      fixed, cols, vals, chunk_row, chunk_span, chunk_part, n_chunks, grams, rhs,
      partial);
}

extern "C" int ft_gram_accumulate(const void* fixed, const void* cols,
                                  const void* vals, const void* chunk_row,
                                  const void* chunk_span, const void* chunk_part,
                                  long long n_chunks, const void* split_row,
                                  const void* split_ptr, long long n_split, int f,
                                  void* partial, void* grams, void* rhs,
                                  void* stream) {
  if (f < 1 || f > GRAM_MAX_F || n_chunks < 0 || n_split < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  const auto* fx = static_cast<const float*>(fixed);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* row = static_cast<const int32_t*>(chunk_row);
  const auto* span = static_cast<const long long*>(chunk_span);
  const auto* part = static_cast<const int32_t*>(chunk_part);
  auto* g = static_cast<float*>(grams);
  auto* b = static_cast<float*>(rhs);
  auto* w = static_cast<float*>(partial);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (f) {
#define GRAM_CASE(F) \
    case F: gram_small_launch<F>(fx, c, v, row, span, part, n_chunks, g, b, w, st); break;
    GRAM_CASE(1) GRAM_CASE(2) GRAM_CASE(3) GRAM_CASE(4) GRAM_CASE(5) GRAM_CASE(6)
    GRAM_CASE(7) GRAM_CASE(8) GRAM_CASE(9) GRAM_CASE(10) GRAM_CASE(11)
    GRAM_CASE(12) GRAM_CASE(13) GRAM_CASE(14) GRAM_CASE(15) GRAM_CASE(16)
#undef GRAM_CASE
    default: {
      int threads = ((f * (f + 1) + 31) / 32) * 32;
      if (threads > GRAM_THREADS) threads = GRAM_THREADS;
      gram_large_kernel<<<static_cast<unsigned int>(n_chunks), threads, 0, st>>>(
          fx, c, v, row, span, part, f, g, b, w);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
  gram_combine_kernel<<<static_cast<unsigned int>(n_split), GRAM_THREADS, 0, st>>>(
      w, static_cast<const int32_t*>(split_row), static_cast<const int32_t*>(split_ptr),
      f, g, b);
  return static_cast<int>(cudaGetLastError());
}
