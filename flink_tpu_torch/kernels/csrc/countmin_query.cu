// countmin_query: Count-Min point queries, min over the d rows.
//
// Replaces flink_tpu/ops/sketches.py CountMinSketchAggregate.point_query,
// reached through flink_tpu/streaming/heavy_hitters.py _jit_point_query:
// for query i, out[i] = min over r < d of table[row_i, r, col_r], with
// col_r = (lo_i + r * hi_i) mod w in uint32 arithmetic and row_i the
// slot by the reference's index rule (a negative slot wraps once to
// s + C, then the row clamps into [0, C): ft_gather_row).
//
// Bound on this card: bytes, scattered.  Each query reads 12 B (slot,
// two hash lanes), gathers d random 4-byte cells and writes 4 B; the
// arithmetic is a multiply, an add and a mask or modulo per row.  What
// holds it is the memory's rate for random cells: on an H100 SXM (700 W)
// the gathers alone, from flat cell indices made beforehand, take as
// long as the kernel (about 30 G random cells a second at both of
// chip_smoke's shapes; the same gathers sorted by address are 1.13-1.42x
// faster), about 3.4x the time of 32 B a distinct sector at the card's
// rate (scripts/kernel_probe.py, group countmin_query).
//
// Design: two consecutive queries a thread, a pair a thread.  Where
// the slots and both lanes share their offset mod 8 bytes, each comes in
// one 8-byte load, after a scalar head (slices at any element offset
// stay right), and the estimates leave in one 8-byte store where the
// output shares that offset too; a ragged tail goes query by query.
// Depth is a template parameter (1, 2, 3, 4 and 8; any other depth
// takes a loop whose rows issue the thread's gathers together), so all
// of a thread's 2 * d gathers are issued before the first min.  A
// power-of-two width takes a mask, any other a 32-bit modulo.  The
// gathers are ld.global.nc.L1::no_allocate: the cells are read once,
// so L1 has nothing to give.  Addressing is 64-bit (row * d * w).  An
// integer min: bit-equal to the reference.  Measured and not kept
// (scripts/kernel_probe.cu keeps each as a copy; within 1-3% of each
// other and of the gathers alone): 1, 4 and 8 queries a thread, a grid
// capped at what the SMs hold at the kernel's occupancy (the last
// round leaves SMs idle), cached loads, and the design before (a query
// a thread, a run-time depth loop).
#include "common.cuh"

#define CMQ_THREADS 256

__device__ __forceinline__ int32_t cmq_load(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

template <bool kPow2>
__device__ __forceinline__ uint32_t cmq_col(uint32_t h_lo, uint32_t h_hi, int r,
                                            uint32_t width) {
  const uint32_t h = h_lo + static_cast<uint32_t>(r) * h_hi;
  return kPow2 ? (h & (width - 1u)) : (h % width);
}

// Queries b and b + 1 of a thread: b may be -1 (the head's pair) and
// b + 1 equal to q (the tail); `vec_in` / `vec_out`: both queries lie in
// [0, q) and the inputs / the output are 8-byte aligned at b.
template <int D, bool kPow2>
__device__ __forceinline__ void cmq_pair(
    const int32_t* __restrict__ table, const int32_t* __restrict__ slots,
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    long long b, long long q, int depth, uint32_t width, long long capacity,
    int32_t* __restrict__ out, bool vec_in, bool vec_out) {
  int32_t s[2];
  uint32_t h1[2], h0[2];
  bool ok[2];
  if (vec_in) {
    const int2 vs = __ldg(reinterpret_cast<const int2*>(slots + b));
    const uint2 vh = __ldg(reinterpret_cast<const uint2*>(hi + b));
    const uint2 vl = __ldg(reinterpret_cast<const uint2*>(lo + b));
    s[0] = vs.x; s[1] = vs.y;
    h1[0] = vh.x; h1[1] = vh.y;
    h0[0] = vl.x; h0[1] = vl.y;
    ok[0] = ok[1] = true;
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long i = b + k;
      ok[k] = i >= 0 && i < q;
      s[k] = ok[k] ? slots[i] : 0;
      h1[k] = ok[k] ? hi[i] : 0u;
      h0[k] = ok[k] ? lo[i] : 0u;
    }
  }
  const long long row_cells = static_cast<long long>(depth) * width;
  const int32_t* base[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) base[k] = table + ft_gather_row(s[k], capacity) * row_cells;
  int32_t best[2];
  if constexpr (D > 0) {
    int32_t v[2][D];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < D; ++r)
        v[k][r] = ok[k] ? cmq_load(base[k] + static_cast<long long>(r) * width +
                                   cmq_col<kPow2>(h0[k], h1[k], r, width))
                        : 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      best[k] = v[k][0];
#pragma unroll
      for (int r = 1; r < D; ++r) best[k] = min(best[k], v[k][r]);
    }
  } else {
    for (int r = 0; r < depth; ++r) {
      int32_t v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        v[k] = ok[k] ? cmq_load(base[k] + static_cast<long long>(r) * width +
                                cmq_col<kPow2>(h0[k], h1[k], r, width))
                     : 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) best[k] = r == 0 ? v[k] : min(best[k], v[k]);
    }
  }
  if (vec_out) {
    *reinterpret_cast<int2*>(out + b) = make_int2(best[0], best[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (ok[k]) out[b + k] = best[k];
  }
}

// shift (0 or 1): the head, a query before the first one aligned to 8
// bytes (vec only); the pairs start at b = 2 g - shift, so every whole
// pair but the head's starts aligned.
template <int D, bool kPow2>
__global__ void __launch_bounds__(CMQ_THREADS)
countmin_query_kernel(const int32_t* __restrict__ table,
                      const int32_t* __restrict__ slots,
                      const uint32_t* __restrict__ hi,
                      const uint32_t* __restrict__ lo, long long q, int depth,
                      uint32_t width, long long capacity,
                      int32_t* __restrict__ out, int shift, bool vec,
                      bool vec_out) {
  const long long pairs = (q + shift + 1) / 2;
  for (long long g = static_cast<long long>(blockIdx.x) * CMQ_THREADS + threadIdx.x;
       g < pairs; g += static_cast<long long>(gridDim.x) * CMQ_THREADS) {
    const long long b = 2 * g - shift;
    const bool whole = vec && b >= 0 && b + 2 <= q;
    cmq_pair<D, kPow2>(table, slots, hi, lo, b, q, depth, width, capacity, out, whole,
                       whole && vec_out);
  }
}

// A pair a thread.
template <int D, bool kPow2>
static int cmq_launch(const int32_t* table, const int32_t* slots,
                      const uint32_t* hi, const uint32_t* lo, long long q,
                      int depth, uint32_t width, long long capacity,
                      int32_t* out, cudaStream_t stream) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(slots) & 7u;
  const bool vec = off % 4 == 0 && (reinterpret_cast<uintptr_t>(hi) & 7u) == off &&
                   (reinterpret_cast<uintptr_t>(lo) & 7u) == off;
  const bool vec_out = vec && (reinterpret_cast<uintptr_t>(out) & 7u) == off;
  const int shift = vec && off != 0 ? 1 : 0;
  const long long pairs = (q + shift + 1) / 2;
  const long long blocks = (pairs + CMQ_THREADS - 1) / CMQ_THREADS;
  countmin_query_kernel<D, kPow2><<<static_cast<unsigned int>(blocks), CMQ_THREADS, 0,
                                    stream>>>(table, slots, hi, lo, q, depth, width,
                                              capacity, out, shift, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPow2>
static int cmq_by_depth(const int32_t* table, const int32_t* slots,
                        const uint32_t* hi, const uint32_t* lo, long long q,
                        int depth, uint32_t width, long long capacity,
                        int32_t* out, cudaStream_t stream) {
#define CMQ_CASE(D)                                                              \
  case D:                                                                        \
    return cmq_launch<D, kPow2>(table, slots, hi, lo, q, depth, width, capacity, \
                                out, stream);
  switch (depth) {
    CMQ_CASE(1)
    CMQ_CASE(2)
    CMQ_CASE(3)
    CMQ_CASE(4)
    CMQ_CASE(8)
    default:
      return cmq_launch<0, kPow2>(table, slots, hi, lo, q, depth, width, capacity, out,
                                  stream);
  }
#undef CMQ_CASE
}

// width in [1, 2^32), depth >= 1, capacity >= 1 (the wrapper checks).
extern "C" int ft_countmin_query(const void* table, const void* slots,
                                 const void* hi, const void* lo, long long q,
                                 int depth, long long width,
                                 long long capacity, void* out, void* stream) {
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  const uint32_t w = static_cast<uint32_t>(width);
  auto* t = static_cast<const int32_t*>(table);
  auto* s = static_cast<const int32_t*>(slots);
  auto* h = static_cast<const uint32_t*>(hi);
  auto* l = static_cast<const uint32_t*>(lo);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if ((w & (w - 1u)) == 0u)
    return cmq_by_depth<true>(t, s, h, l, q, depth, w, capacity, o, st);
  return cmq_by_depth<false>(t, s, h, l, q, depth, w, capacity, o, st);
}
