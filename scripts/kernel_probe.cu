// The designs measured against clear_rows, hll_update, countmin_update
// and table_insert and not kept, and their floors,
// built beside the kernels' own sources (included here) by
// scripts/kernel_probe.py, which times them on the card.
//
// - ft_probe_clear_range_bulk: the range clear as TMA bulk stores
//   (cp.async.bulk.global.shared::cta) from a 32 KiB shared-memory
//   buffer holding the fill, one thread a block issuing them, at most 8
//   bulk groups in flight a block, 4 blocks an SM.  16-byte aligned
//   ranges only.
// - ft_probe_clear_range: the kernel's range form with 8 blocks an SM
//   walking the 32 KiB chunks instead of a block a chunk (variant 0), and
//   the same with streaming stores (variant 1).  16-byte aligned ranges
//   only.
// - ft_probe_hll_update: the compressed hll_update (uint16 registers)
//   with the rows a thread forced (1, 2, 4 or 8) and one of four ways to
//   apply them: 0 = load every row's word, then CAS the rows below their
//   rank; 1 = CAS first on every row (an atomicCAS expecting an empty
//   word, its return value serving as the load); 2 = as 0, after
//   ordering each tile's 2048 rows by word address in shared memory;
//   3 = the kernel's own (a warp's sample picks 0 or 1 for its other
//   rows).
// - ft_probe_countmin_red: countmin_update's atomics alone, a thread a
//   record adding 1 to its d table cells and its total: variant 0 at
//   cell indices computed beforehand (int32 [n, d], and the slots),
//   loading only them; variant 1 at hashed cells of the same table (a
//   power of two of cells and of slots), loading nothing; variant 2
//   loads the indexed cells instead of adding to them (the memory's
//   rate for the same random words, without the L2's atomics).
// - ft_probe_table_insert: table_insert with G lanes a record (1, 2, 4,
//   8 or 16).
// - ft_probe_stream_sum: quantile_result's floor, a plain streaming read
//   and sum of the same bytes (16-byte loads, a grid-stride loop, one
//   word a block written so the loads stay).
// - ft_probe_gram_gather: gram_accumulate's floors at f = 10 with no
//   row structure (a thread takes ratings i, i + stride, ...): variant
//   0 loads each rating's column, value and factor row and adds them
//   up (the gathers alone); variant 1 adds each rating's upper triangle
//   and right-hand side to 65 sums in registers (the gathers with the
//   FMAs), as the kernel's lanes do.  One word a thread is written.
// - ft_probe_quantile_global: quantile_result's global-memory form
//   launched at any row width (the kernel's launcher takes it only for
//   rows too wide for the staged form), to set the width where one form
//   gives way to the other.
// - ft_probe_edge_lists: edge_popcount's pair pass without its bitmap:
//   the small rows' lists read alone, in the plan's pair order.
// - ft_probe_merge_add: merge_rows' int32 add with a repeated dst as
//   its atomics alone, its loads alone, and the two together.
// - ft_probe_hll_finish_registers: hll_log_finish's first tiled form
//   (each thread's words walked from registers), not kept.
// - ft_probe_hll_finish_parts: hll_log_finish's second tiled form (the
//   rank span staged in shared memory), not kept, whole (mode 0) and with
//   a part taken out (the walk, the estimator, the rank loads, the shared
//   atomics).
// - ft_probe_hll_log_finish: the kernel at forced lanes a key and a
//   forced long-run threshold (words a lane over which the warp sums a
//   run; 1 << 20: never); ft_probe_hll_lanes: the launcher's pick of
//   lanes a key.
// - ft_probe_quantile_red: quantile_update's floors, a thread a record:
//   variant 0 adds 1 at flat cell indices computed beforehand (int64,
//   the 8 B a record that slot and value take; no log, no division: the
//   atomics alone); variant 1 a plain load and store at the same cells
//   (the memory's rate for the same random words without the L2's
//   atomics; races lose counts, nothing reads them); variant 2 reads the
//   slot and the value only (the inputs' stream).
// - ft_probe_countmin_query: countmin_query at depth 4 and a
//   power-of-two width in a form picked by `form`: 0 = the design
//   before (a thread a query, a run-time depth loop, a modulo, __ldg);
//   2 = the kernel's own cmq_launch (2 a thread, a pair a thread);
//   1, 4, 8 = copies of it (pb_cmq_kernel) with that many queries a
//   thread (inputs in loads of up to 4 words), a group a thread; 12 = 2
//   a thread with cached loads (__ldg) in place of L1::no_allocate;
//   101, 102, 104 = 1, 2, 4 a thread on a grid capped at what the SMs
//   hold at the kernel's occupancy.
// - ft_probe_cmq_gathers: countmin_query's floor, its gathers alone: a
//   thread a query loads its 4 cells at flat int64 indices made
//   beforehand ([q, 4], 32 B a query), all four in flight, and stores
//   their min.  Given the indices sorted, the same gathers in ascending
//   address order (what DRAM page locality would be worth).
// - ft_probe_cmq_inputs: countmin_query's inputs alone, its 12 B a
//   query read as a stream (16-byte loads) and 4 B a query written.
// - ft_probe_hll_gathered: hll_estimate's gathered form (a block a
//   row) with the slot's row computed by one of five rules: 0 = the
//   clamp into [0, C) of the design before (slot -1 read row 0), 1 = a
//   negative slot wrapped once, then clamped, in 64 bits, 2 = the
//   kernels' ft_gather_row, 3 = the wrap and clamp in 32 bits by a
//   select, 4 = the same by the slot's sign mask (3 and 4 hold below
//   2^31 rows only).
#include "../flink_tpu_torch/kernels/csrc/clear_rows.cu"
#include "../flink_tpu_torch/kernels/csrc/countmin_query.cu"
#include "../flink_tpu_torch/kernels/csrc/countmin_update.cu"
#include "../flink_tpu_torch/kernels/csrc/hll_update.cu"
#include "../flink_tpu_torch/kernels/csrc/table_insert.cu"
#include "../flink_tpu_torch/kernels/csrc/gram_accumulate.cu"
#include "../flink_tpu_torch/kernels/csrc/quantile_result.cu"
#include "../flink_tpu_torch/kernels/csrc/knn_topk.cu"
#include "../flink_tpu_torch/kernels/csrc/hll_log_finish.cu"

#include <cub/block/block_radix_sort.cuh>

#define PB_BUF_BYTES 32768
#define PB_THREADS 128

__global__ void __launch_bounds__(PB_THREADS)
probe_clear_range_bulk(char* body, long long body_bytes, uint4 fill) {
  __shared__ __align__(128) uint4 buf[PB_BUF_BYTES / 16];
  for (int i = threadIdx.x; i < PB_BUF_BYTES / 16; i += PB_THREADS) buf[i] = fill;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  const long long chunks = (body_bytes + PB_BUF_BYTES - 1) / PB_BUF_BYTES;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long off = c * PB_BUF_BYTES;
    const long long left = body_bytes - off;
    const uint32_t bytes = left < PB_BUF_BYTES ? static_cast<uint32_t>(left)
                                               : PB_BUF_BYTES;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(body + off), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 8;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the range form's kernel with streaming stores (evict first from L2)
__global__ void __launch_bounds__(CR_THREADS)
probe_clear_range_cs(uint4* __restrict__ body, long long body_words, uint4 fill) {
  const long long chunks = (body_words + CR_CHUNK - 1) / CR_CHUNK;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    uint4* p = body + c * CR_CHUNK;
    const long long left = body_words - c * CR_CHUNK;
    if (left >= CR_CHUNK) {
#pragma unroll
      for (int k = 0; k < CR_CHUNK / CR_THREADS; ++k)
        __stcs(p + threadIdx.x + k * CR_THREADS, fill);
    } else {
      for (int i = threadIdx.x; i < static_cast<int>(left); i += CR_THREADS)
        __stcs(p + i, fill);
    }
  }
}

// variant 0: the kernel with 8 blocks an SM walking the chunks; 1: the
// same with streaming stores
extern "C" int ft_probe_clear_range(void* base, long long bytes, int variant,
                                    void* stream) {
  if ((reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(bytes)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const long long words = bytes / 16;
  const long long chunks = (words + CR_CHUNK - 1) / CR_CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks == 0) return static_cast<int>(cudaGetLastError());
  long long blocks = static_cast<long long>(sm_count()) * CR_BLOCKS_PER_SM;
  if (blocks > chunks) blocks = chunks;
  if (variant == 0)
    clear_range_kernel<<<static_cast<unsigned int>(blocks), CR_THREADS, 0, s>>>(
        static_cast<uint4*>(base), words, nullptr, 0, nullptr, 0, zero);
  else
    probe_clear_range_cs<<<static_cast<unsigned int>(blocks), CR_THREADS, 0, s>>>(
        static_cast<uint4*>(base), words, zero);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_probe_clear_range_bulk(void* base, long long bytes,
                                         unsigned long long fill_lo,
                                         unsigned long long fill_hi,
                                         void* stream) {
  if ((reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(bytes)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  uint4 f;
  f.x = static_cast<unsigned int>(fill_lo);
  f.y = static_cast<unsigned int>(fill_lo >> 32);
  f.z = static_cast<unsigned int>(fill_hi);
  f.w = static_cast<unsigned int>(fill_hi >> 32);
  long long blocks = (bytes + PB_BUF_BYTES - 1) / PB_BUF_BYTES;
  const long long cap = 4LL * sm_count();
  if (blocks > cap) blocks = cap;
  if (blocks > 0)
    probe_clear_range_bulk<<<static_cast<unsigned int>(blocks), PB_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<char*>(base), bytes, f);
  return static_cast<int>(cudaGetLastError());
}

// mode 0: load every row's word, then CAS; 1: CAS first on every row
template <int R, typename Src>
__global__ void __launch_bounds__(HU_THREADS)
probe_hll_uniform(uint8_t* __restrict__ regs, Src src, long long n,
                  long long m, long long capacity, int cas_first) {
  const long long first =
      static_cast<long long>(blockIdx.x) * (HU_THREADS * R) + threadIdx.x;
  HuRow rows[R];
  hu_rows<R>(src, regs, first, n, m, capacity, rows);
  unsigned int old[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    old[k] = rows[k].rank && !cas_first ? __ldcg(rows[k].word) : 0u;
  hu_cas<R>(rows, old);
}

// mode 2: mode 0 after ordering the tile's rows by word address
template <typename Src>
__global__ void __launch_bounds__(HU_THREADS)
probe_hll_sorted(uint8_t* __restrict__ regs, Src src, long long n, long long m,
                 long long capacity) {
  constexpr int R = 8;
  using Sort = cub::BlockRadixSort<unsigned int, HU_THREADS, R, unsigned int>;
  __shared__ typename Sort::TempStorage tmp;
  const long long first =
      static_cast<long long>(blockIdx.x) * (HU_THREADS * R) + threadIdx.x;
  HuRow rows[R];
  hu_rows<R>(src, regs, first, n, m, capacity, rows);
  unsigned int key[R], val[R];
  unsigned int* const words = reinterpret_cast<unsigned int*>(regs);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    key[k] = rows[k].rank ? static_cast<unsigned int>(rows[k].word - words)
                          : 0xFFFFFFFFu;
    val[k] = rows[k].rank | (rows[k].shift << 8);
  }
  Sort(tmp).SortBlockedToStriped(key, val);
  unsigned int old[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    rows[k].word = words + key[k];
    rows[k].rank = key[k] == 0xFFFFFFFFu ? 0u : (val[k] & 0xFFu);
    rows[k].shift = val[k] >> 8;
    old[k] = rows[k].rank ? __ldcg(rows[k].word) : 0u;
  }
  hu_cas<R>(rows, old);
}

// mode 3: the kernel's own design (a sampled choice per warp)
template <int R>
static void probe_hll_launch(int mode, uint8_t* regs,
                             const HuCompressed<uint16_t>& src, long long n,
                             long long m, long long capacity, cudaStream_t s) {
  using Src = HuCompressed<uint16_t>;
  const unsigned int grid =
      static_cast<unsigned int>((n + HU_THREADS * R - 1) / (HU_THREADS * R));
  if (mode == 3)
    hll_update_kernel<R, Src><<<grid, HU_THREADS, 0, s>>>(regs, src, n, m, capacity);
  else
    probe_hll_uniform<R, Src><<<grid, HU_THREADS, 0, s>>>(regs, src, n, m,
                                                          capacity, mode);
}

// mode 2 needs R = 8 and a file of fewer than 2^32 - 1 words
extern "C" int ft_probe_hll_update(void* regs, const void* slots,
                                   const void* rank, const void* reg,
                                   long long n, long long m,
                                   long long capacity, int rows_per_thread,
                                   int mode, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* r = static_cast<uint8_t*>(regs);
  const HuCompressed<uint16_t> src{static_cast<const int32_t*>(slots),
                                   static_cast<const uint8_t*>(rank),
                                   static_cast<const uint16_t*>(reg)};
  if (mode == 2) {
    if (rows_per_thread != 8 || capacity * m / 4 >= 0xFFFFFFFFLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned int grid =
        static_cast<unsigned int>((n + HU_THREADS * 8 - 1) / (HU_THREADS * 8));
    probe_hll_sorted<HuCompressed<uint16_t>><<<grid, HU_THREADS, 0, s>>>(r, src, n, m, capacity);
    return static_cast<int>(cudaGetLastError());
  }
  switch (rows_per_thread) {
    case 8: probe_hll_launch<8>(mode, r, src, n, m, capacity, s); break;
    case 4: probe_hll_launch<4>(mode, r, src, n, m, capacity, s); break;
    case 2: probe_hll_launch<2>(mode, r, src, n, m, capacity, s); break;
    case 1: probe_hll_launch<1>(mode, r, src, n, m, capacity, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(CM_THREADS)
probe_countmin_red(int32_t* table, int32_t* total,
                   const int32_t* __restrict__ cells,
                   const int32_t* __restrict__ tslots, long long n, int depth,
                   long long cell_mask, long long slot_mask, int variant) {
  FT_GRID_STRIDE(i, n) {
    if (variant == 2) {
      int acc = __ldcg(total + tslots[i]);
      for (int r = 0; r < depth; ++r) acc ^= __ldcg(table + cells[i * depth + r]);
      if (acc == 0x7FFFFFF5) total[0] = acc;   // never: keeps the loads
    } else if (variant == 1) {
      unsigned long long h = static_cast<unsigned long long>(i) *
                             0x9E3779B97F4A7C15ULL;
      for (int r = 0; r <= depth; ++r) {
        h ^= h >> 31;
        h *= 0xBF58476D1CE4E5B9ULL;
        h ^= h >> 29;
        if (r < depth)
          atomicAdd(table + static_cast<long long>(h & cell_mask), 1);
        else
          atomicAdd(total + static_cast<long long>(h & slot_mask), 1);
      }
    } else {
      for (int r = 0; r < depth; ++r) atomicAdd(table + cells[i * depth + r], 1);
      atomicAdd(total + tslots[i], 1);
    }
  }
}

// variant 1 needs a power of two of cells and of slots
extern "C" int ft_probe_countmin_red(void* table, void* total,
                                     const void* cells, const void* tslots,
                                     long long n, int depth,
                                     long long table_cells,
                                     long long capacity, int variant,
                                     void* stream) {
  if (n > 0)
    probe_countmin_red<<<grid_for(n, CM_THREADS), CM_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(table), static_cast<int32_t*>(total),
        static_cast<const int32_t*>(cells), static_cast<const int32_t*>(tslots),
        n, depth, table_cells - 1, capacity - 1, variant);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_probe_table_insert(void* key_hi, void* key_lo,
                                     void* occupied, long long capacity,
                                     const void* h_hi, const void* h_lo,
                                     const void* mask, const void* region,
                                     long long region_size, long long n,
                                     long long n_rows, int max_probes,
                                     void* slots, void* overflow, int group,
                                     void* stream) {
#define PB_TI(G)                                                            \
  return launch_table_insert<G>(key_hi, key_lo, occupied, capacity, h_hi,  \
                                h_lo, mask, region, region_size, n, n_rows, \
                                max_probes, slots, overflow, stream)
  switch (group) {
    case 1: PB_TI(1);
    case 2: PB_TI(2);
    case 4: PB_TI(4);
    case 8: PB_TI(8);
    case 16: PB_TI(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PB_TI
}

__global__ void __launch_bounds__(256)
probe_stream_sum(const int4* __restrict__ src, long long n16, int* __restrict__ out) {
  int acc = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n16;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int4 v = __ldcs(src + i);
    acc += v.x + v.y + v.z + v.w;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(out + blockIdx.x, acc);
}

// bytes: a multiple of 16 from a 16-byte aligned base; out: grid words
extern "C" int ft_probe_stream_sum(const void* src, long long bytes, void* out,
                                   int blocks, void* stream) {
  probe_stream_sum<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), bytes / 16, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int VARIANT>
__global__ void __launch_bounds__(128)
probe_gram_gather(const float* __restrict__ fixed, const int32_t* __restrict__ cols,
                  const float* __restrict__ vals, long long n, float* __restrict__ out) {
  constexpr int F = 10, TRI = F * (F + 1) / 2, NE = TRI + F, U = 4;
  float acc[VARIANT == 1 ? NE : 1];
#pragma unroll
  for (int e = 0; e < (VARIANT == 1 ? NE : 1); ++e) acc[e] = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       base < n; base += stride * U) {
    int c[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = base + stride * u;
      c[u] = k < n ? cols[k] : -1;
      v[u] = k < n ? vals[k] : 0.0f;
    }
    float x[U][F];
#pragma unroll
    for (int u = 0; u < U; ++u) GramLoad<F>::row(fixed, c[u], x[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (VARIANT == 1) {
        int e = 0;
#pragma unroll
        for (int i = 0; i < F; ++i) {
#pragma unroll
          for (int j = i; j < F; ++j, ++e) acc[e] = fmaf(x[u][i], x[u][j], acc[e]);
        }
#pragma unroll
        for (int i = 0; i < F; ++i) acc[TRI + i] = fmaf(v[u], x[u][i], acc[TRI + i]);
      } else {
        float s = v[u];
#pragma unroll
        for (int i = 0; i < F; ++i) s += x[u][i];
        acc[0] += s;
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < (VARIANT == 1 ? NE : 1); ++e) s += acc[e];
  out[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

// fixed: [*, 10] float32, 8-byte aligned rows; out: blocks * 128 floats
extern "C" int ft_probe_gram_gather(const void* fixed, const void* cols,
                                    const void* vals, long long n, int blocks,
                                    int variant, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(fixed);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  if (variant == 1) probe_gram_gather<1><<<blocks, 128, 0, s>>>(fx, c, v, n, o);
  else probe_gram_gather<0><<<blocks, 128, 0, s>>>(fx, c, v, n, o);
  return static_cast<int>(cudaGetLastError());
}

template <int QM>
static int probe_quantile_global(const int32_t* hist, const int32_t* slots,
                                 long long rows, int buckets, long long capacity,
                                 const float* qs, int nq, const float* bv, float* out,
                                 cudaStream_t s) {
  int seg = (buckets + 31) / 32;
  if ((seg & 1) == 0) ++seg;
  long long blocks = (rows + QR_WARPS - 1) / QR_WARPS;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  if (blocks > cap) blocks = cap;
  if (slots != nullptr)
    quantile_result_global<QM, true><<<static_cast<unsigned int>(blocks), QR_THREADS, 0,
                                        s>>>(hist, slots, rows, buckets, capacity, seg, qs,
                                             nq, bv, out);
  else
    quantile_result_global<QM, false><<<static_cast<unsigned int>(blocks), QR_THREADS, 0,
                                         s>>>(hist, slots, rows, buckets, capacity, seg, qs,
                                              nq, bv, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_probe_quantile_global(const void* hist, const void* slots,
                                        long long rows, long long buckets,
                                        long long capacity, const void* qs, int nq,
                                        const void* bucket_val, void* out,
                                        void* stream) {
  if (nq < 1 || nq > kMaxQ || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* h = static_cast<const int32_t*>(hist);
  const auto* sl = static_cast<const int32_t*>(slots);
  const auto* q = static_cast<const float*>(qs);
  const auto* bv = static_cast<const float*>(bucket_val);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(buckets);
  if (nq <= 2) return probe_quantile_global<2>(h, sl, rows, b, capacity, q, nq, bv, o, st);
  if (nq <= 8) return probe_quantile_global<8>(h, sl, rows, b, capacity, q, nq, bv, o, st);
  return probe_quantile_global<16>(h, sl, rows, b, capacity, q, nq, bv, o, st);
}

// edge_popcount's lists read alone: a warp a sorted pair reads the small
// row's list (its entries added up, no bitmap, no dense rows), as the
// pair pass reads them; one word a warp is written only if the sum hits
// a value it never does, so the loads stay.
__global__ void __launch_bounds__(256)
probe_edge_lists(const int32_t* __restrict__ counts, long long dense_above,
                 const long long* __restrict__ offsets,
                 const int2* __restrict__ entries,
                 const int32_t* __restrict__ small, long long n_pairs,
                 int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  unsigned int acc = 0;
  for (long long q = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       q < n_pairs; q += nwarps) {
    const int sm = small[q];
    const int cnt = counts[sm];
    if (cnt > dense_above) continue;
    const int2* e = entries + offsets[sm];
    for (int i = lane; i < cnt; i += 32) acc += static_cast<unsigned int>(__ldg(e + i).y);
  }
  acc = __reduce_add_sync(0xFFFFFFFFu, acc);
  if (acc == 0x7FFFFFF5u) out[0] = static_cast<int>(acc);
}

extern "C" int ft_probe_edge_lists(const void* counts, long long dense_above,
                                   const void* offsets, const void* entries,
                                   const void* small, long long n_pairs,
                                   void* out, void* stream) {
  if (n_pairs > 0)
    probe_edge_lists<<<grid_for(n_pairs * 32, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(counts), dense_above,
        static_cast<const long long*>(offsets), static_cast<const int2*>(entries),
        static_cast<const int32_t*>(small), n_pairs, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// merge_rows' floors for an int32 add with a repeated dst: a grid-stride
// loop over k * row_words words, as the kernel's 4-byte-word loop:
// variant 0 adds 1 to each dst word (the atomics alone, no src read);
// variant 1 loads the src word and the dst word and adds neither (the
// loads alone); variant 2 loads the src word and adds it atomically
// (the kernel's work, 4-byte words).
__global__ void __launch_bounds__(256)
probe_merge_add(int* __restrict__ base, const int32_t* __restrict__ dst,
                const int32_t* __restrict__ src, long long k,
                long long row_words, int variant) {
  FT_GRID_STRIDE(i, k * row_words) {
    const long long r = i / row_words;
    const long long w = i - r * row_words;
    int* out = base + static_cast<long long>(dst[r]) * row_words + w;
    if (variant == 0) {
      atomicAdd(out, 1);
    } else {
      const int s = __ldcg(base + static_cast<long long>(src[r]) * row_words + w);
      if (variant == 2) atomicAdd(out, s);
      else if ((s ^ __ldcg(out)) == 0x7FFFFFF5) out[0] = s;   // never
    }
  }
}

extern "C" int ft_probe_merge_add(void* base, const void* dst, const void* src,
                                  long long k, long long row_words, int variant,
                                  void* stream) {
  if (k > 0)
    probe_merge_add<<<grid_for(k * row_words, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(base), static_cast<const int32_t*>(dst),
        static_cast<const int32_t*>(src), k, row_words, variant);
  return static_cast<int>(cudaGetLastError());
}

// quantile_update's floors (see the head of this file); one word is
// written only if the inputs hit a value they never do, so the loads stay
__global__ void __launch_bounds__(256)
probe_quantile_red(int32_t* hist, const long long* __restrict__ flat,
                   const int32_t* __restrict__ slots,
                   const float* __restrict__ values, long long n, int variant) {
  FT_GRID_STRIDE(i, n) {
    if (variant == 0) {
      atomicAdd(hist + flat[i], 1);
    } else if (variant == 1) {
      int32_t* c = hist + flat[i];
      *c = __ldcg(c) + 1;
    } else if ((slots[i] ^ __float_as_int(values[i])) == 0x7FFFFFF5) {
      hist[0] = 0;   // never
    }
  }
}

extern "C" int ft_probe_quantile_red(void* hist, const void* flat,
                                     const void* slots, const void* values,
                                     long long n, int variant, void* stream) {
  if (n > 0)
    probe_quantile_red<<<grid_for(n, 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(hist), static_cast<const long long*>(flat),
        static_cast<const int32_t*>(slots), static_cast<const float*>(values),
        n, variant);
  return static_cast<int>(cudaGetLastError());
}

// hll_log_finish's first tiled form, not kept: each thread's four words
// of the rank span walked from registers, the byte loop unrolled over
// them (the kernel now stages the span in shared memory and walks it in
// a short loop).  Same interface and results as ft_hll_log_finish.
#define PH_THREADS 256
#define PH_MAX_TILE 1024
#define PH_WORDS 4
#define PH_FRAC 33

__global__ void __launch_bounds__(PH_THREADS)
probe_hll_finish_registers(const uint8_t* __restrict__ ranks,
                      const int32_t* __restrict__ ends, long long n_keys,
                      int tile, long long m, double alpha_m2,
                      const double* __restrict__ log_tab,
                      double* __restrict__ est,
                      double* __restrict__ inv_sum_out) {
  // run[j] is where the tile's key j starts, run[nk] where the tile ends
  __shared__ int run[PH_MAX_TILE + 1];
  __shared__ unsigned long long acc[PH_MAX_TILE];
  const long long k0 = static_cast<long long>(blockIdx.x) * tile;
  const int nk = static_cast<int>(min(static_cast<long long>(tile), n_keys - k0));
  for (int j = threadIdx.x; j <= nk; j += PH_THREADS)
    run[j] = k0 + j == 0 ? 0 : ends[k0 + j - 1];
  for (int j = threadIdx.x; j < nk; j += PH_THREADS) acc[j] = 0;
  __syncthreads();

  const int lo = run[0], hi = run[nk];
  if (hi > lo) {
    // 16-byte words of memory: byte p of ranks is byte p + off of them
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(ranks) & 15);
    const uint4* words = reinterpret_cast<const uint4*>(ranks - off);
    const int w_end = ((hi - 1 + off) >> 4) + 1;
    for (int w0 = ((lo + off) >> 4) + threadIdx.x * PH_WORDS; w0 < w_end;
         w0 += PH_THREADS * PH_WORDS) {
      uint4 w[PH_WORDS];
#pragma unroll
      for (int g = 0; g < PH_WORDS; ++g)
        w[g] = w0 + g < w_end ? __ldg(words + w0 + g) : make_uint4(0, 0, 0, 0);
      const int p0 = (w0 << 4) - off;  // the position of the words' first byte
      const int first = max(lo, p0), end = min(hi, p0 + 16 * PH_WORDS);
      // the last key j of the tile with run[j] <= first (first < hi)
      int j = 0, top = nk;
      while (top - j > 1) {
        const int mid = (j + top) >> 1;
        if (run[mid] <= first) j = mid; else top = mid;
      }
      int next = run[j + 1];
      unsigned long long s = 0;
#pragma unroll
      for (int g = 0; g < PH_WORDS; ++g) {
        const unsigned int c[4] = {w[g].x, w[g].y, w[g].z, w[g].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned int v = c[q];
          int p = p0 + 16 * g + 4 * q;
#pragma unroll 1
          for (int b = 0; b < 4; ++b, ++p, v >>= 8) {
            if (p < first || p >= end) continue;
            while (p >= next) {  // the run ended: hand its part to the key
              if (s) atomicAdd(acc + j, s);
              s = 0;
              next = run[++j + 1];
            }
            s += 1ULL << (PH_FRAC - (v & 0xFFu));
          }
        }
      }
      if (s) atomicAdd(acc + j, s);
    }
  }
  __syncthreads();



  const double mf = static_cast<double>(m);
  for (int j = threadIdx.x; j < nk; j += PH_THREADS) {
    const long long present = static_cast<long long>(run[j + 1]) - run[j];
    // exact: acc < 2^53, and the scale is a power of two
    const double s = static_cast<double>(acc[j]) * 0x1p-33;
    // registers not present contribute 2^-0 = 1 each
    const double zeros = mf - static_cast<double>(present);
    const double inv_sum = zeros + s;
    double e = alpha_m2 / inv_sum;
    if (e <= 2.5 * mf && zeros > 0.0)
      e = mf * (__ldg(log_tab + m) - __ldg(log_tab + (m - present)));
    est[k0 + j] = e;
    if (inv_sum_out != nullptr) inv_sum_out[k0 + j] = inv_sum;
  }
}


extern "C" int ft_probe_hll_finish_registers(const void* ranks, const void* ends,
                                             long long n_keys, int tile, long long m,
                                             double alpha_m2, const void* log_tab,
                                             void* est, void* inv_sum, void* stream) {
  if (tile < 1 || tile > PH_MAX_TILE) return static_cast<int>(cudaErrorInvalidValue);
  if (n_keys > 0)
    probe_hll_finish_registers<<<static_cast<unsigned int>((n_keys + tile - 1) / tile),
                                 PH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ranks), static_cast<const int32_t*>(ends), n_keys,
        tile, m, alpha_m2, static_cast<const double*>(log_tab),
        static_cast<double*>(est), static_cast<double*>(inv_sum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_probe_hll_log_finish(const void* ranks, const void* ends,
                                       long long n_keys, int group, int long_words,
                                       long long m, double alpha_m2,
                                       const void* log_tab, void* est, void* stream) {
  return lf_launch(ranks, ends, n_keys, group, long_words, m, alpha_m2, log_tab,
                   est, nullptr, stream);
}

extern "C" int ft_probe_hll_lanes(long long n_keys, long long n_cells) {
  return lf_lanes_per_key(n_keys, n_cells);
}

// hll_log_finish with its parts taken out, to see what a block's time
// is made of (the results are wrong where a part is out): MODE bit 0
// skips the walk over the staged bytes, bit 1 the estimator (the sums
// are stored), bit 2 the loads of the rank words (the stage holds
// ranks of 1), bit 3 takes plain stores for the shared atomics.  MODE 0
// is the second tiled form, not kept: a block's rank span staged in
// shared memory in 16 KiB chunks and walked by each thread in a short
// loop, the sums added by 64-bit shared atomics.
#define PS_THREADS 256
#define PS_MAX_TILE 1024
#define PS_CHUNK 16384
#define PS_SPAN (PS_CHUNK / PS_THREADS)
#define PS_FRAC 33
template <int MODE>
__global__ void __launch_bounds__(PS_THREADS)
probe_hll_finish_parts(const uint8_t* __restrict__ ranks,
                      const int32_t* __restrict__ ends, long long n_keys,
                      int tile, long long m, double alpha_m2,
                      const double* __restrict__ log_tab,
                      double* __restrict__ est,
                      double* __restrict__ inv_sum_out) {
  // run[j] is where the tile's key j starts, run[nk] where the tile ends
  __shared__ int run[PS_MAX_TILE + 1];
  __shared__ unsigned long long acc[PS_MAX_TILE];
  __shared__ uint4 stage[PS_CHUNK / 16];
  const long long k0 = static_cast<long long>(blockIdx.x) * tile;
  const int nk = static_cast<int>(min(static_cast<long long>(tile), n_keys - k0));
  for (int j = threadIdx.x; j <= nk; j += PS_THREADS)
    run[j] = k0 + j == 0 ? 0 : ends[k0 + j - 1];
  for (int j = threadIdx.x; j < nk; j += PS_THREADS) acc[j] = 0;
  __syncthreads();

  const int lo = run[0], hi = run[nk];
  // 16-byte words of memory: byte p of ranks is byte p + off of them
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(ranks) & 15);
  const uint4* words = reinterpret_cast<const uint4*>(ranks - off);
  const int w_end = hi > lo ? ((hi - 1 + off) >> 4) + 1 : 0;
  for (int c = (lo + off) >> 4; c < w_end; c += PS_CHUNK / 16) {
    // stage the chunk's words: every load issued before any store
    const int nw = min(PS_CHUNK / 16, w_end - c);
    uint4 v[PS_CHUNK / 16 / PS_THREADS];
#pragma unroll
    for (int i = 0; i < PS_CHUNK / 16 / PS_THREADS; ++i) {
      const int wi = threadIdx.x + i * PS_THREADS;
      if (wi < nw) v[i] = (MODE & 4) ? make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u) : __ldg(words + c + wi);
    }
#pragma unroll
    for (int i = 0; i < PS_CHUNK / 16 / PS_THREADS; ++i) {
      const int wi = threadIdx.x + i * PS_THREADS;
      if (wi < nw) stage[wi] = v[i];
    }
    __syncthreads();
    // the thread's bytes of the chunk, within the span
    const int c0 = (c << 4) - off;  // the position of the chunk's first byte
    const int mine = c0 + PS_SPAN * static_cast<int>(threadIdx.x);
    const int first = max(lo, mine);
    const int end = min(min(hi, c0 + 16 * nw), mine + PS_SPAN);
    if (!(MODE & 1) && first < end) {
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(stage);
      // the last key j of the tile with run[j] <= first (first < hi)
      int j = 0, top = nk;
      while (top - j > 1) {
        const int mid = (j + top) >> 1;
        if (run[mid] <= first) j = mid; else top = mid;
      }
      int next = run[j + 1];
      unsigned long long s = 0;
#pragma unroll 4
      for (int p = first; p < end; ++p) {
        while (p >= next) {  // the run ended: hand its part to the key
          if (s) {
            if (MODE & 8) acc[j] = s; else atomicAdd(acc + j, s);
          }
          s = 0;
          next = run[++j + 1];
        }
        s += 1ULL << (PS_FRAC - bytes[p - c0]);
      }
      if (MODE & 8) acc[j] = s; else atomicAdd(acc + j, s);
    }
    __syncthreads();
  }

  const double mf = static_cast<double>(m);
  for (int j = threadIdx.x; j < nk; j += PS_THREADS) {
    const long long present = static_cast<long long>(run[j + 1]) - run[j];
    // exact: acc < 2^53, and the scale is a power of two
    const double s = static_cast<double>(acc[j]) * 0x1p-33;
    // registers not present contribute 2^-0 = 1 each
    const double zeros = mf - static_cast<double>(present);
    const double inv_sum = zeros + s;
    double e = inv_sum;
    if (!(MODE & 2)) {
      e = alpha_m2 / inv_sum;
      if (e <= 2.5 * mf && zeros > 0.0)
        e = mf * (__ldg(log_tab + m) - __ldg(log_tab + (m - present)));
    }
    est[k0 + j] = e;
    if (inv_sum_out != nullptr) inv_sum_out[k0 + j] = inv_sum;
  }
}


extern "C" int ft_probe_hll_finish_parts(const void* ranks, const void* ends,
                                         long long n_keys, int tile, long long m,
                                         double alpha_m2, const void* log_tab,
                                         void* est, int mode, void* stream) {
  const unsigned int blocks = static_cast<unsigned int>((n_keys + tile - 1) / tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(ranks);
  const int32_t* e = static_cast<const int32_t*>(ends);
  const double* t = static_cast<const double*>(log_tab);
  double* o = static_cast<double*>(est);
#define PH_PARTS(M) \
  case M: probe_hll_finish_parts<M><<<blocks, PS_THREADS, 0, s>>>(r, e, n_keys, tile, m, alpha_m2, t, o, nullptr); break;
  switch (mode) {
    PH_PARTS(0) PH_PARTS(1) PH_PARTS(2) PH_PARTS(3) PH_PARTS(4) PH_PARTS(8) PH_PARTS(7)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PH_PARTS
  return static_cast<int>(cudaGetLastError());
}


// countmin_query as it was before its redesign
__global__ void probe_cmq_old(const int32_t* __restrict__ table,
                              const int32_t* __restrict__ slots,
                              const uint32_t* __restrict__ hi,
                              const uint32_t* __restrict__ lo, long long q,
                              int depth, long long width, long long capacity,
                              int32_t* __restrict__ out) {
  FT_GRID_STRIDE(i, q) {
    long long slot = slots[i];
    slot = slot < 0 ? 0 : (slot >= capacity ? capacity - 1 : slot);
    const uint32_t h_hi = hi[i];
    const uint32_t h_lo = lo[i];
    const int32_t* row = table + slot * depth * width;
    int32_t best = 0;
    for (int r = 0; r < depth; ++r) {
      const uint32_t h = h_lo + static_cast<uint32_t>(r) * h_hi;
      const int32_t v =
          __ldg(row + r * width + static_cast<long long>(h % static_cast<uint32_t>(width)));
      best = r == 0 ? v : min(best, v);
    }
    out[i] = best;
  }
}

// countmin_query's forms measured and not kept, copies of the kernel at
// depth 4 and a power-of-two width: PER queries a thread (1, 2, 4 or 8;
// inputs in loads of up to 4 words), the gathers cached (__ldg) or not
// (kNoAlloc: L1::no_allocate, the kernel's own), on a grid of a group a
// thread or capped at what the SMs hold at the kernel's occupancy (CAP).
#define PB_CMQ_VEC(PER) ((PER) >= 4 ? 4 : (PER))

template <int V, typename T>
__device__ __forceinline__ void pb_cmq_vload(const T* p, T* dst) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    dst[0] = static_cast<T>(v.x); dst[1] = static_cast<T>(v.y);
    dst[2] = static_cast<T>(v.z); dst[3] = static_cast<T>(v.w);
  } else if constexpr (V == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    dst[0] = static_cast<T>(v.x); dst[1] = static_cast<T>(v.y);
  } else {
    dst[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void pb_cmq_vstore(int32_t* p, const int32_t* src) {
  if constexpr (V == 4)
    *reinterpret_cast<int4*>(p) = make_int4(src[0], src[1], src[2], src[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<int2*>(p) = make_int2(src[0], src[1]);
  else
    *p = src[0];
}

// queries [b, b + PER) a thread, as the kernel's pairs
template <int PER, bool kNoAlloc>
__global__ void __launch_bounds__(CMQ_THREADS)
pb_cmq_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ slots,
              const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
              long long q, uint32_t width, long long capacity,
              int32_t* __restrict__ out, int shift, bool vec, bool vec_out) {
  constexpr int V = PB_CMQ_VEC(PER), D = 4;
  const long long groups = (q + shift + PER - 1) / PER;
  for (long long g = static_cast<long long>(blockIdx.x) * CMQ_THREADS + threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * CMQ_THREADS) {
    const long long b = g * PER - shift;
    const bool whole = vec && b >= 0 && b + PER <= q;
    int32_t s[PER];
    uint32_t h1[PER], h0[PER];
    bool ok[PER];
    if (whole) {
#pragma unroll
      for (int k = 0; k < PER; k += V) {
        pb_cmq_vload<V>(slots + b + k, s + k);
        pb_cmq_vload<V>(hi + b + k, h1 + k);
        pb_cmq_vload<V>(lo + b + k, h0 + k);
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) ok[k] = true;
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const long long i = b + k;
        ok[k] = i >= 0 && i < q;
        s[k] = ok[k] ? slots[i] : 0;
        h1[k] = ok[k] ? hi[i] : 0u;
        h0[k] = ok[k] ? lo[i] : 0u;
      }
    }
    int32_t v[PER][D];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int32_t* base = table + ft_gather_row(s[k], capacity) * (D * static_cast<long long>(width));
#pragma unroll
      for (int r = 0; r < D; ++r) {
        const int32_t* p = base + static_cast<long long>(r) * width +
                           cmq_col<true>(h0[k], h1[k], r, width);
        v[k][r] = ok[k] ? (kNoAlloc ? cmq_load(p) : __ldg(p)) : 0;
      }
    }
    int32_t best[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      best[k] = min(min(v[k][0], v[k][1]), min(v[k][2], v[k][3]));
    if (whole && vec_out) {
#pragma unroll
      for (int k = 0; k < PER; k += V) pb_cmq_vstore<V>(out + b + k, best + k);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (ok[k]) out[b + k] = best[k];
    }
  }
}

template <int PER, bool kNoAlloc, bool CAP>
static int pb_cmq_launch(const int32_t* table, const int32_t* slots, const uint32_t* hi,
                         const uint32_t* lo, long long q, uint32_t width,
                         long long capacity, int32_t* out, cudaStream_t stream) {
  auto kernel = pb_cmq_kernel<PER, kNoAlloc>;
  const uintptr_t unit = 4u * PB_CMQ_VEC(PER);        // bytes of a vector
  const uintptr_t off = reinterpret_cast<uintptr_t>(slots) & (unit - 1u);
  const bool vec = off % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(hi) & (unit - 1u)) == off &&
                   (reinterpret_cast<uintptr_t>(lo) & (unit - 1u)) == off;
  const bool vec_out = vec && (reinterpret_cast<uintptr_t>(out) & (unit - 1u)) == off;
  long long head = vec ? static_cast<long long>((unit - off) & (unit - 1u)) / 4 : 0;
  if (head > q) head = q;
  const int shift = head ? PER - static_cast<int>(head) : 0;
  const long long groups = (q + shift + PER - 1) / PER;
  long long blocks = (groups + CMQ_THREADS - 1) / CMQ_THREADS;
  if (CAP) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CMQ_THREADS, 0) !=
            cudaSuccess || n < 1)
      n = 1;
    const long long cap = static_cast<long long>(sm_count()) * n;
    if (blocks > cap) blocks = cap;
  }
  kernel<<<static_cast<unsigned int>(blocks), CMQ_THREADS, 0, stream>>>(
      table, slots, hi, lo, q, width, capacity, out, shift, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ft_probe_countmin_query(const void* table, const void* slots,
                                       const void* hi, const void* lo, long long q,
                                       int depth, long long width,
                                       long long capacity, void* out, int form,
                                       void* stream) {
  const uint32_t w = static_cast<uint32_t>(width);
  if (q <= 0 || depth != 4 || (w & (w - 1u)) != 0u)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* t = static_cast<const int32_t*>(table);
  auto* s = static_cast<const int32_t*>(slots);
  auto* h = static_cast<const uint32_t*>(hi);
  auto* l = static_cast<const uint32_t*>(lo);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      probe_cmq_old<<<grid_for(q, 256), 256, 0, st>>>(t, s, h, l, q, depth, width,
                                                      capacity, o);
      return static_cast<int>(cudaGetLastError());
    case 2:
      return cmq_launch<4, true>(t, s, h, l, q, depth, w, capacity, o, st);
#define PB_CMQ(F, PER, NA, CAP) \
  case F:                       \
    return pb_cmq_launch<PER, NA, CAP>(t, s, h, l, q, w, capacity, o, st);
    PB_CMQ(1, 1, true, false)
    PB_CMQ(4, 4, true, false)
    PB_CMQ(8, 8, true, false)
    PB_CMQ(12, 2, false, false)
    PB_CMQ(101, 1, true, true)
    PB_CMQ(102, 2, true, true)
    PB_CMQ(104, 4, true, true)
#undef PB_CMQ
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void __launch_bounds__(256)
probe_cmq_gathers(const int32_t* __restrict__ table,
                  const long long* __restrict__ cells, long long q,
                  int32_t* __restrict__ out) {
  FT_GRID_STRIDE(i, q) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(cells + 4 * i));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(cells + 4 * i + 2));
    const int32_t v0 = cmq_load(table + a.x);
    const int32_t v1 = cmq_load(table + a.y);
    const int32_t v2 = cmq_load(table + b.x);
    const int32_t v3 = cmq_load(table + b.y);
    out[i] = min(min(v0, v1), min(v2, v3));
  }
}

extern "C" int ft_probe_cmq_gathers(const void* table, const void* cells,
                                    long long q, void* out, void* stream) {
  if (q > 0)
    probe_cmq_gathers<<<grid_for(q, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), static_cast<const long long*>(cells), q,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// q a multiple of 4, all four buffers 16-byte aligned
__global__ void __launch_bounds__(256)
probe_cmq_inputs(const int4* __restrict__ slots, const int4* __restrict__ hi,
                 const int4* __restrict__ lo, long long n4, int4* __restrict__ out) {
  FT_GRID_STRIDE(i, n4) {
    const int4 s = __ldg(slots + i), h = __ldg(hi + i), l = __ldg(lo + i);
    out[i] = make_int4(s.x ^ h.x ^ l.x, s.y ^ h.y ^ l.y, s.z ^ h.z ^ l.z,
                       s.w ^ h.w ^ l.w);
  }
}

extern "C" int ft_probe_cmq_inputs(const void* slots, const void* hi, const void* lo,
                                   long long q, void* out, void* stream) {
  if (q % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    probe_cmq_inputs<<<grid_for(q / 4, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(slots), static_cast<const int4*>(hi),
        static_cast<const int4*>(lo), q / 4, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}


template <int RULE>
__device__ __forceinline__ long long pb_row(int32_t s, long long c) {
  if constexpr (RULE == 0) {
    const long long r = s;
    return r < 0 ? 0 : (r >= c ? c - 1 : r);
  } else if constexpr (RULE == 1) {
    long long r = s;
    if (r < 0) r += c;
    return r < 0 ? 0 : (r >= c ? c - 1 : r);
  } else if constexpr (RULE == 2) {
    return ft_gather_row(s, c);
  } else if constexpr (RULE == 3) {
    const int32_t c32 = static_cast<int32_t>(c);
    const int32_t r = s < 0 ? s + c32 : s;
    return min(max(r, 0), c32 - 1);
  } else {
    const int32_t c32 = static_cast<int32_t>(c);
    const int32_t r = s + (c32 & (s >> 31));
    return min(max(r, 0), c32 - 1);
  }
}

__device__ __forceinline__ void pb_accumulate_word(unsigned int w, float& s, int& z) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = static_cast<int>((w >> (8 * k)) & 0xFFu);
    s += __int_as_float((127 - r) << 23);
    z += (r == 0);
  }
}

// hll_estimate_kernel's gathered form, the row by rule RULE
template <int RULE>
__global__ void probe_hll_gathered(const uint8_t* __restrict__ regs,
                                   const int32_t* __restrict__ slots, long long m,
                                   long long capacity, float alpha_m2,
                                   float* __restrict__ out) {
  const long long row = pb_row<RULE>(slots[blockIdx.x], capacity);
  const uint4* p = reinterpret_cast<const uint4*>(regs + row * m);
  const long long nvec = m / 16;
  float s = 0.0f;
  int z = 0;
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 v = p[i];
    pb_accumulate_word(v.x, s, z);
    pb_accumulate_word(v.y, s, z);
    pb_accumulate_word(v.z, s, z);
    pb_accumulate_word(v.w, s, z);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    z += __shfl_down_sync(0xFFFFFFFFu, z, off);
  }
  __shared__ float ws[32];
  __shared__ int wz[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wz[warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? ws[lane] : 0.0f;
    z = lane < nwarps ? wz[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xFFFFFFFFu, s, off);
      z += __shfl_down_sync(0xFFFFFFFFu, z, off);
    }
    if (lane == 0) {
      const float mf = static_cast<float>(m);
      const float est = alpha_m2 / s;
      const float zf = static_cast<float>(z);
      const float lm = __double2float_rn(log(static_cast<double>(m)));
      const float lz = __double2float_rn(log(static_cast<double>(fmaxf(zf, 1.0f))));
      const float linear = mf * (lm - lz);
      out[blockIdx.x] = (est <= 2.5f * mf && z > 0) ? linear : est;
    }
  }
}

// m a power of two >= 16; rules 3 and 4 need capacity < 2^31
extern "C" int ft_probe_hll_gathered(const void* regs, const void* slots,
                                     long long rows, long long m, long long capacity,
                                     float alpha_m2, void* out, int rule, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long t = m / 16;
  int threads = t >= 256 ? 256 : (t <= 32 ? 32 : static_cast<int>(t));
  threads = (threads + 31) / 32 * 32;
  auto st = static_cast<cudaStream_t>(stream);
  auto* r = static_cast<const uint8_t*>(regs);
  auto* s = static_cast<const int32_t*>(slots);
  auto* o = static_cast<float*>(out);
  const unsigned int grid = static_cast<unsigned int>(rows);
  switch (rule) {
#define PB_RULE(R)                                                                 \
  case R:                                                                          \
    probe_hll_gathered<R><<<grid, threads, 0, st>>>(r, s, m, capacity, alpha_m2, o); \
    break;
    PB_RULE(0)
    PB_RULE(1)
    PB_RULE(2)
    PB_RULE(3)
    PB_RULE(4)
#undef PB_RULE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
