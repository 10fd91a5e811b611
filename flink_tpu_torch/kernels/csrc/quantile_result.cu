// quantile_result: per-slot quantiles of an int32 [C, B] histogram.
//
// Replaces flink_tpu/ops/sketches.py QuantileSketchAggregate.result
// (and result_dense, which the reference defaults through result,
// flink_tpu/ops/device_agg.py:121-130), reached through the window
// engines' fire (_jit_result / _result_contig in
// flink_tpu/streaming/vectorized.py, _jit_result in
// streaming/vectorized_sessions.py): per row, cum = cumsum(hist) in
// float32, total = cum[B - 1]; for each quantile q, target =
// max(q * total, 1) and the answer is bucket_val[first b with
// cum[b] >= target], or bucket_val[0] (= 0) when there is none, which
// is argmax of an all-false row: the empty slot.
//
// Bound on this card: bytes.  A row of B * 4 bytes is read and Q * 4
// written; a scan of B integers is a few operations per byte.
//
// Design: each row is read from memory once.  Every warp runs a
// pipeline of its own (a persistent grid; no block-wide barrier after
// the start, so a row that takes long holds up only its warp): a ring
// of QR_STAGES shared-memory buffers, each holding a span of rows (one
// row, or a few where rows are narrow), filled QR_STAGES - 1 spans
// ahead by bulk copies of the tensor memory accelerator completing on
// the buffer's mbarrier: a dense span as one copy (its rows back to
// back), a gathered span a copy a row.  A copy's unaligned head and
// tail (a row slice at an odd row of 210 buckets is only 8-byte
// aligned) go as 4-byte cp.async into a buffer placed at the same
// address modulo 16, so nothing outside the view is read.
//
// A warp scans a row in one step: lane j owns the contiguous segment of
// `seg` buckets starting at j * seg (seg odd, so the lanes' reads hit
// 32 banks) and sums it; one warp scan of the 32 lane sums gives the
// total and each lane's prefix; each quantile's ballot (all issued
// together) finds the first lane whose inclusive prefix reaches its
// target, and the warp walks that lane's segment 32 buckets at a time
// (a scan and a ballot) to the bucket.  The quantile count is a
// template parameter (2, 4, 8 or 16), so quantiles, targets and votes
// live in registers; the bucket values sit in shared memory after the
// buffers.  The counts are integers summed exactly (they stay below
// 2^24, so the float32 cumsum of the reference is exact in any order
// too) and converted to float32 for the comparisons, so the selected
// bucket is exactly the reference's.  bucket_val is a float32 table of
// B values the caller computes once (the aggregate, from the
// reference's formula); the kernel indexes it, so its values are
// bit-equal to the plain version's.  Dense form (slots == nullptr): rows
// 0 .. S of the given file, which may be a row slice of a larger one;
// gathered form: row = slots[i], a negative slot wrapped once to s + C,
// then clamped into [0, C) (the reference's index rule, ft_gather_row).
// Rows too wide for QR_BLOCK_WARPS rings of QR_STAGES buffers in a
// block's shared memory (~4,470 buckets on this card) are scanned
// from global memory by the same warp routine, 8 warps a block: there a
// staged block of fewer warps is slower (1.05x at 5,183 buckets, 2.6x at
// 10,364).  Addressing is 64-bit.
#include "common.cuh"

constexpr int kMaxQ = 16;

#define QR_THREADS 256      // the global-memory form
#define QR_WARPS (QR_THREADS / 32)
#define QR_BLOCK_WARPS 4    // the staged form: warps a block, each on its own ring
#define QR_STAGES 3
#define QR_SPAN_BYTES 4096  // a stage's rows: at least one, about this many bytes
#define QR_FULL 0xFFFFFFFFu


__device__ __forceinline__ void qr_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void qr_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool kGathered>
__device__ __forceinline__ long long qr_row_index(const int32_t* __restrict__ slots,
                                                  long long i, long long capacity) {
  if constexpr (kGathered) return ft_gather_row(slots[i], capacity);
  return i;
}

__device__ __forceinline__ unsigned qr_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void qr_cp4(unsigned char* dst, const unsigned char* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(qr_smem(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void qr_bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(qr_smem(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void qr_bar_expect(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(qr_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void qr_bar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(qr_smem(bar)) : "memory");
}

__device__ __forceinline__ void qr_bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(qr_smem(bar)), "r"(parity) : "memory");
  }
}

// One warp copies the span [src, src + nbytes) (nbytes a multiple of 4)
// to the shared buffer at dst16 (16-byte aligned), placed at dst16 +
// (src % 16): the 16-byte aligned body as one bulk copy (the tensor
// memory accelerator; lane 0 adds its bytes to the stage's barrier),
// the head and tail (at most 12 bytes each) as 4-byte cp.async.
__device__ __forceinline__ void qr_copy_span(unsigned char* dst16,
                                             const unsigned char* src, int nbytes,
                                             unsigned long long* bar, int lane) {
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* dst = dst16 + shift;
  int head = (16 - shift) & 15;
  if (head > nbytes) head = nbytes;
  const int body = (nbytes - head) & ~15;
  if (lane * 4 < head) qr_cp4(dst + lane * 4, src + lane * 4);
  const int tail = head + body;
  if (tail + lane * 4 < nbytes) qr_cp4(dst + tail + lane * 4, src + tail + lane * 4);
  if (lane == 0 && body > 0) {
    qr_bar_expect(bar, body);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(qr_smem(dst + head)), "l"(src + head), "r"(body), "r"(qr_smem(bar))
        : "memory");
  }
}

// The quantiles of one row (in shared or global memory), by one warp;
// lane k < nq writes out[k].
template <int QM>
__device__ __forceinline__ void qr_scan_row(const int32_t* row, int buckets, int seg,
                                            const float (&q)[QM], int nq,
                                            const float* bucket_val,
                                            float* __restrict__ out, int lane) {
  const int b0 = lane * seg;
  const int b1 = min(b0 + seg, buckets);
  // four independent sums keep four loads in flight (integers: exact in
  // any order)
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  int b = b0;
  for (; b + 4 <= b1; b += 4) {
    s0 += row[b];
    s1 += row[b + 1];
    s2 += row[b + 2];
    s3 += row[b + 3];
  }
  for (; b < b1; ++b) s0 += row[b];
  const int s = (s0 + s1) + (s2 + s3);
  int p = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(QR_FULL, p, off);
    if (lane >= off) p += up;
  }
  const float total = static_cast<float>(__shfl_sync(QR_FULL, p, 31));
  const float pf = static_cast<float>(p);
  // every quantile's vote first (independent, in flight together), then
  // the walks of those a lane reaches
  float target[QM];
  unsigned hit[QM];
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    target[k] = fmaxf(__fmul_rn(q[k], total), 1.0f);
    hit[k] = __ballot_sync(QR_FULL, k < nq && pf >= target[k]);
  }
  int mine = 0;
#pragma unroll
  for (int k = 0; k < QM; ++k) {
    if (hit[k] != 0u) {
      // the first lane reaching the target owns a non-empty segment
      // whose last prefix reaches it: the walk ends inside it
      const int f = __ffs(hit[k]) - 1;
      int carry = __shfl_sync(QR_FULL, p - s, f);
      const int fb1 = min(f * seg + seg, buckets);
      int ans = 0;
      for (int base = f * seg; base < fb1; base += 32) {
        const int b = base + lane;
        int c = b < fb1 ? row[b] : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int up = __shfl_up_sync(QR_FULL, c, off);
          if (lane >= off) c += up;
        }
        c += carry;
        const unsigned h =
            __ballot_sync(QR_FULL, b < fb1 && static_cast<float>(c) >= target[k]);
        if (h != 0u) {
          ans = base + __ffs(h) - 1;
          break;
        }
        carry = __shfl_sync(QR_FULL, c, 31);
      }
      if (lane == k) mine = ans;
    }
  }
  if (lane < nq) out[lane] = bucket_val[mine];
}

template <int QM>
__device__ __forceinline__ void qr_load_qs(float (&q)[QM], const float* __restrict__ qs,
                                           int nq) {
#pragma unroll
  for (int k = 0; k < QM; ++k) q[k] = k < nq ? qs[k] : 0.0f;
}

template <int QM, bool kGathered>
__global__ void __launch_bounds__(QR_BLOCK_WARPS * 32)
quantile_result_staged(const int32_t* __restrict__ hist,
                       const int32_t* __restrict__ slots, long long rows,
                       int buckets, long long capacity, int seg, int span_rows,
                       int row_stride, const float* __restrict__ qs, int nq,
                       const float* __restrict__ bucket_val,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float q[QM];
  qr_load_qs(q, qs, nq);
  const int nbytes = buckets * 4;
  const int stage_bytes = span_rows * row_stride;
  // each warp's ring of buffers, then the block's bucket values (an
  // answer's lookup stays on the SM), then each warp's barriers
  unsigned char* ring = smem + warp * (QR_STAGES * stage_bytes);
  const int rings = warps * QR_STAGES * stage_bytes;
  float* values = reinterpret_cast<float*>(smem + rings);
  auto* bars = reinterpret_cast<unsigned long long*>(smem + rings + ((nbytes + 7) & ~7)) +
               warp * QR_STAGES;
  for (int b = threadIdx.x; b < buckets; b += blockDim.x) values[b] = bucket_val[b];
  if (lane == 0) {
    for (int s = 0; s < QR_STAGES; ++s) qr_bar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the values; from here on every warp runs on its own
  const long long spans = (rows + span_rows - 1) / span_rows;
  const long long step = static_cast<long long>(gridDim.x) * warps;

  // a dense span is one copy of its rows back to back (after the shift
  // of its first byte); a gathered row is a copy of its own, at
  // row_stride apart
  auto issue = [&](long long g, int stage) {
    if (g < spans) {
      unsigned char* st = ring + stage * stage_bytes;
      const long long first = g * span_rows;
      const int n = static_cast<int>(min(static_cast<long long>(span_rows), rows - first));
      if (lane == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if constexpr (!kGathered) {
        qr_copy_span(st, reinterpret_cast<const unsigned char*>(hist + first * buckets),
                     n * nbytes, bars + stage, lane);
      } else {
        for (int r = 0; r < n; ++r) {
          const long long row = qr_row_index<true>(slots, first + r, capacity);
          qr_copy_span(st + r * row_stride,
                       reinterpret_cast<const unsigned char*>(hist + row * buckets),
                       nbytes, bars + stage, lane);
        }
      }
      __syncwarp();
      if (lane == 0) qr_bar_arrive(bars + stage);
    }
    qr_commit();  // an empty group keeps the count of groups in step
  };

  long long g = static_cast<long long>(blockIdx.x) * warps + warp;
#pragma unroll
  for (int s = 0; s < QR_STAGES - 1; ++s) issue(g + s * step, s);
  for (int it = 0; g < spans; ++it, g += step) {
    issue(g + (QR_STAGES - 1) * step, (it + QR_STAGES - 1) % QR_STAGES);
    const int stage = it % QR_STAGES;
    qr_wait<QR_STAGES - 1>();
    qr_bar_wait(bars + stage, static_cast<unsigned>((it / QR_STAGES) & 1));
    __syncwarp();
    const unsigned char* st = ring + stage * stage_bytes;
    const long long first = g * span_rows;
    const int n = static_cast<int>(min(static_cast<long long>(span_rows), rows - first));
    const int dense_shift = static_cast<int>(
        reinterpret_cast<uintptr_t>(hist + first * buckets) & 15);
    for (int r = 0; r < n; ++r) {
      const long long i = first + r;
      const unsigned char* row;
      if constexpr (!kGathered) {
        row = st + dense_shift + r * nbytes;
      } else {
        const long long at = qr_row_index<true>(slots, i, capacity);
        row = st + r * row_stride + (reinterpret_cast<uintptr_t>(hist + at * buckets) & 15);
      }
      qr_scan_row<QM>(reinterpret_cast<const int32_t*>(row), buckets, seg, q, nq, values,
                      out + i * nq, lane);
    }
    __syncwarp();  // every lane is done with the buffer refilled next
  }
  qr_wait<0>();
}

template <int QM, bool kGathered>
__global__ void __launch_bounds__(QR_THREADS)
quantile_result_global(const int32_t* __restrict__ hist,
                       const int32_t* __restrict__ slots, long long rows,
                       int buckets, long long capacity, int seg,
                       const float* __restrict__ qs, int nq,
                       const float* __restrict__ bucket_val,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  float q[QM];
  qr_load_qs(q, qs, nq);
  const long long stride = static_cast<long long>(gridDim.x) * QR_WARPS;
  for (long long i = static_cast<long long>(blockIdx.x) * QR_WARPS + (threadIdx.x >> 5);
       i < rows; i += stride) {
    const long long row = qr_row_index<kGathered>(slots, i, capacity);
    qr_scan_row<QM>(hist + row * buckets, buckets, seg, q, nq, bucket_val,
                    out + i * nq, lane);
  }
}

template <int QM, bool kGathered>
static int qr_launch(const int32_t* hist, const int32_t* slots, long long rows,
                     int buckets, long long capacity, const float* qs, int nq,
                     const float* bucket_val, float* out, cudaStream_t stream) {
  int seg = (buckets + 31) / 32;
  if ((seg & 1) == 0) ++seg;  // an odd stride between lanes: no bank conflicts
  const int row_stride = ((buckets * 4 + 15) & ~15) + 16;
  // per device: the opt-in shared memory limit (the kernel's attribute
  // is raised to it once) and the blocks an SM holds at the last shape
  static int optin_of[64] = {0}, per_sm_of[64] = {0};
  static long long shape_of[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (optin_of[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(quantile_result_staged<QM, kGathered>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(quantile_result_staged<QM, kGathered>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    optin_of[dev] = optin;
  }
  // a stage holds a span of rows of about QR_SPAN_BYTES (at least one);
  // rows too wide for QR_BLOCK_WARPS rings a block (~4,470 buckets) go
  // to the global-memory form, which beats a block of fewer warps there
  int span_rows = QR_SPAN_BYTES / (buckets * 4);
  if (span_rows < 1) span_rows = 1;
  const int warps = QR_BLOCK_WARPS, threads = 32 * warps;
  const long long smem = static_cast<long long>(warps) * QR_STAGES * span_rows * row_stride +
                         ((buckets * 4LL + 7) & ~7LL) + 8LL * QR_STAGES * warps;
  if (smem <= optin_of[dev]) {
    const int bytes = static_cast<int>(smem);
    const long long shape = static_cast<long long>(bytes) * 1024 + threads;
    if (shape_of[dev] != shape) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quantile_result_staged<QM, kGathered>, threads, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      per_sm_of[dev] = per_sm < 1 ? 1 : per_sm;
      shape_of[dev] = shape;
    }
    const long long spans = (rows + span_rows - 1) / span_rows;
    long long blocks = static_cast<long long>(sm_count()) * per_sm_of[dev];
    if (blocks > (spans + warps - 1) / warps) blocks = (spans + warps - 1) / warps;
    quantile_result_staged<QM, kGathered>
        <<<static_cast<unsigned int>(blocks), threads, bytes, stream>>>(
            hist, slots, rows, buckets, capacity, seg, span_rows, row_stride, qs, nq,
            bucket_val, out);
  } else {
    long long blocks = (rows + QR_WARPS - 1) / QR_WARPS;
    const long long cap = static_cast<long long>(sm_count()) * 16;
    if (blocks > cap) blocks = cap;
    quantile_result_global<QM, kGathered>
        <<<static_cast<unsigned int>(blocks), QR_THREADS, 0, stream>>>(
            hist, slots, rows, buckets, capacity, seg, qs, nq, bucket_val, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// each form (dense, gathered) is compiled apart: no branch on it per row
template <bool kGathered>
static int qr_by_q(const int32_t* h, const int32_t* sl, long long rows, int b,
                   long long capacity, const float* q, int nq, const float* bv,
                   float* o, cudaStream_t st) {
  if (nq <= 2) return qr_launch<2, kGathered>(h, sl, rows, b, capacity, q, nq, bv, o, st);
  if (nq <= 4) return qr_launch<4, kGathered>(h, sl, rows, b, capacity, q, nq, bv, o, st);
  if (nq <= 8) return qr_launch<8, kGathered>(h, sl, rows, b, capacity, q, nq, bv, o, st);
  return qr_launch<16, kGathered>(h, sl, rows, b, capacity, q, nq, bv, o, st);
}

extern "C" int ft_quantile_result(const void* hist, const void* slots,
                                  long long rows, long long buckets,
                                  long long capacity, const void* qs, int nq,
                                  const void* bucket_val, void* out,
                                  void* stream) {
  if (nq < 1 || nq > kMaxQ || buckets < 1 || buckets > (1LL << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto* h = static_cast<const int32_t*>(hist);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* q = static_cast<const float*>(qs);
  const auto* bv = static_cast<const float*>(bucket_val);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(buckets);
  return sl != nullptr ? qr_by_q<true>(h, sl, rows, b, capacity, q, nq, bv, o, st)
                       : qr_by_q<false>(h, sl, rows, b, capacity, q, nq, bv, o, st);
}
