// gather_segment_sum: out[i] = sum of x[cols[k]] over k in
// [indptr[i], indptr[i + 1]), the segment sum of a graph's edges grouped
// by segment (float32 values, int32 indices), in the order of the plan.
//
// Replaces flink_tpu/graph/library.py PageRank.run.step
// (`jax.ops.segment_sum((ranks / deg)[src], dst)`, :40-49) and both
// segment sums of HITS.run.step (:243-255).  The edges do not change
// between supersteps, so the caller builds a plan once per run
// (kernels/gather_segment_sum.py `segment_plan`: the edges stably sorted
// by segment, `cols` the gathered index in that order, `indptr`, and the
// merge-path coordinates of each tile below).
//
// Bound on this card: bytes.  Read cols (4 B an edge), indptr, x and
// write out once each; the gathers of x hit the 50 MB L2 (x is 16.8 MB at
// Graph500 scale 22), at one 32 B sector a gather where the indices have
// no locality.
//
// Design: merge-path CSR (Merrill & Garland).  The rows' ends and the
// edges are merged into one sequence of n + e items; tile b takes items
// [b * GS_TILE, (b + 1) * GS_TILE), from coordinate (rows, edges)
// coords[b] to coords[b + 1], so every block does the same work whatever
// the degrees (Kronecker graphs have rows of 10^5 edges and many empty
// ones).  A block loads its rows' ends and gathers its edges' x values
// into shared memory (coalesced cols reads, GS_ITEMS gathers in flight a
// thread), then each thread walks GS_ITEMS items of the tile in order:
// an edge adds to the running sum, a row end emits it.  A row that
// spans threads is finished by a segmented scan of the threads' carries
// (keys = rows, fixed shuffle order); a row that spans tiles is written
// by gs_fixup, which adds the tiles' carries in tile order and then the
// finishing tile's part.  Every output is written exactly once, with no
// atomics and no zero fill, and every row is summed in an order fixed by
// the plan: the result is the same bit for bit from run to run.
#include <climits>

#include "common.cuh"

#define GS_THREADS 256
#define GS_WARPS (GS_THREADS / 32)
#define GS_ITEMS 8                          // merge-path items a thread walks
#define GS_TILE (GS_THREADS * GS_ITEMS)     // items of a tile (2048)

__global__ void __launch_bounds__(GS_THREADS)
gs_tiles(float* __restrict__ out, const float* __restrict__ x,
         const int* __restrict__ indptr, const int* __restrict__ cols,
         const int* __restrict__ coords, int n, int* __restrict__ head_row,
         float* __restrict__ head_val, int* __restrict__ tail_row,
         float* __restrict__ tail_val) {
  __shared__ int s_end[GS_TILE + 1];   // row ends of the tile's rows
  __shared__ float s_val[GS_TILE];     // x[cols[k]] of the tile's edges
  __shared__ int s_key[GS_THREADS];
  __shared__ float s_sum[GS_THREADS];
  __shared__ int w_key[GS_WARPS];
  __shared__ float w_sum[GS_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const int x0 = coords[2 * b], y0 = coords[2 * b + 1];
  const int nr = coords[2 * b + 2] - x0;  // rows that end in the tile
  const int ne = coords[2 * b + 3] - y0;  // edges of the tile
  const int items = nr + ne;
  // the tile's first row is finished here (and written by gs_fixup) iff
  // a row ends in the tile
  if (tid == 0) head_row[b] = nr > 0 ? x0 : -1;
  for (int i = tid; i <= nr; i += GS_THREADS) {
    const int r = x0 + i;
    s_end[i] = r < n ? indptr[r + 1] : INT_MAX;
  }
  int c[GS_ITEMS];
#pragma unroll
  for (int k = 0; k < GS_ITEMS; ++k) {
    const int i = k * GS_THREADS + tid;
    c[k] = i < ne ? __ldg(cols + y0 + i) : 0;
  }
  float v[GS_ITEMS];
#pragma unroll
  for (int k = 0; k < GS_ITEMS; ++k)
    v[k] = k * GS_THREADS + tid < ne ? __ldg(x + c[k]) : 0.0f;
#pragma unroll
  for (int k = 0; k < GS_ITEMS; ++k) {
    const int i = k * GS_THREADS + tid;
    if (i < ne) s_val[i] = v[k];
  }
  __syncthreads();

  // this thread's start on the merge path: the rows among the first d
  // items are those whose end comes before edge index y0 + d - rows
  const int d = tid * GS_ITEMS < items ? tid * GS_ITEMS : items;
  int lo = d - ne > 0 ? d - ne : 0;
  int hi = d < nr ? d : nr;
  while (lo < hi) {
    const int pivot = (lo + hi) >> 1;
    if (s_end[pivot] <= y0 + d - pivot - 1)
      lo = pivot + 1;
    else
      hi = pivot;
  }
  int tx = lo, ty = d - lo;
  const int count = items - d < GS_ITEMS ? items - d : GS_ITEMS;
  float acc = 0.0f;
  int first = -1;
  float first_val = 0.0f;
  for (int k = 0; k < count; ++k) {
    if (y0 + ty < s_end[tx]) {        // an edge of row x0 + tx
      acc += s_val[ty];
      ++ty;
    } else {                          // row x0 + tx ends
      const int r = x0 + tx;
      if (first < 0) {
        first = r;
        first_val = acc;
      } else {
        out[r] = acc;
      }
      acc = 0.0f;
      ++tx;
    }
  }

  // segmented inclusive scan of the carries (key: the row in progress),
  // in thread order: within the warp, then across the warps
  int key = x0 + tx;
  float sum = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int pk = __shfl_up_sync(0xFFFFFFFFu, key, off);
    const float ps = __shfl_up_sync(0xFFFFFFFFu, sum, off);
    if (lane >= off && pk == key) sum = ps + sum;
  }
  if (lane == 31) {
    w_key[warp] = key;
    w_sum[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    int k2 = lane < GS_WARPS ? w_key[lane] : INT_MIN + lane;
    float s2 = lane < GS_WARPS ? w_sum[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int pk = __shfl_up_sync(0xFFFFFFFFu, k2, off);
      const float ps = __shfl_up_sync(0xFFFFFFFFu, s2, off);
      if (lane >= off && pk == k2) s2 = ps + s2;
    }
    if (lane < GS_WARPS) {
      w_key[lane] = k2;
      w_sum[lane] = s2;
    }
  }
  __syncthreads();
  if (warp > 0 && w_key[warp - 1] == key) sum = w_sum[warp - 1] + sum;
  s_key[tid] = key;
  s_sum[tid] = sum;
  __syncthreads();
  if (first >= 0) {
    const float val = tid > 0 && s_key[tid - 1] == first
                          ? s_sum[tid - 1] + first_val : first_val;
    if (first == x0)
      head_val[b] = val;
    else
      out[first] = val;
  }
  if (tid == GS_THREADS - 1) {
    tail_row[b] = key;
    tail_val[b] = sum;
  }
}

// The first row finished in each tile: the carries of the tiles before
// it that end inside that row, in tile order, then the tile's own part.
__global__ void gs_fixup(long long tiles, const int* __restrict__ head_row,
                         const float* __restrict__ head_val,
                         const int* __restrict__ tail_row,
                         const float* __restrict__ tail_val,
                         float* __restrict__ out) {
  FT_GRID_STRIDE(b, tiles) {
    const int r = head_row[b];
    if (r < 0) continue;
    long long j = b;
    while (j > 0 && tail_row[j - 1] == r) --j;
    if (j == b) {
      out[r] = head_val[b];
      continue;
    }
    float s = tail_val[j];
    for (long long k = j + 1; k < b; ++k) s += tail_val[k];
    out[r] = s + head_val[b];
  }
}

// out: n floats, every one written.  x: the gathered values (at least
// max(cols) + 1 of them).  indptr: n + 1 ints; cols: indptr[n] ints;
// coords: 2 * (tiles + 1) ints, the (rows, edges) coordinate where each
// tile starts on the merge path and the end (n, e).  Scratch: head_row,
// head_val, tail_row, tail_val: tiles entries each.
extern "C" int ft_gather_segment_sum(void* out, const void* x,
                                     const void* indptr, const void* cols,
                                     const void* coords, long long n,
                                     long long tiles, void* head_row,
                                     void* head_val, void* tail_row,
                                     void* tail_val, void* stream) {
  if (n < 1 || n > INT_MAX || tiles < 1 || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gs_tiles<<<static_cast<unsigned int>(tiles), GS_THREADS, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(x),
      static_cast<const int*>(indptr), static_cast<const int*>(cols),
      static_cast<const int*>(coords), static_cast<int>(n),
      static_cast<int*>(head_row), static_cast<float*>(head_val),
      static_cast<int*>(tail_row), static_cast<float*>(tail_val));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gs_fixup<<<grid_for(tiles, 256), 256, 0, st>>>(
      tiles, static_cast<const int*>(head_row),
      static_cast<const float*>(head_val), static_cast<const int*>(tail_row),
      static_cast<const float*>(tail_val), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
