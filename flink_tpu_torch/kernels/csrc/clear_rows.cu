// clear_rows: fill rows of one [C, row_bytes] state component with a
// fill bit pattern, either the rows of a slot list or a contiguous
// range [start, start + count).
//
// Replaces flink_tpu/streaming/vectorized.py _jit_clear, _clear_contig
// and the full re-init after a full-arena fire, and
// flink_tpu/ops/device_agg.py clear_slots / init_state / grow_state's
// fill: every row gets spec.fill (0 for registers and sums, finfo.max /
// finfo.min for Min / Max).  The JAX engine drops and reallocates the
// whole register file after a full fire; the port clears it in place.
//
// Bound on this card: bytes written (count * row_bytes, plus 4 B per
// listed slot read).
//
// Design: the wrapper widens the fill to the widest store W in
// {16, 8, 4, 1} bytes that divides the row and the element pattern, so
// a 4096-byte HLL row is 256 16-byte stores; a grid-stride loop writes
// consecutive W-byte words from consecutive threads.  The list form
// maps a flat index to (list row, word); slots outside [0, C) are
// skipped.
#include "common.cuh"

template <typename W>
__global__ void clear_range_kernel(W* __restrict__ base, long long words,
                                   W fill) {
  FT_GRID_STRIDE(i, words) { base[i] = fill; }
}

template <typename W>
__global__ void clear_list_kernel(W* __restrict__ base,
                                  const int32_t* __restrict__ slots,
                                  long long nslots, long long row_words,
                                  long long capacity, W fill) {
  FT_GRID_STRIDE(i, nslots * row_words) {
    const long long r = i / row_words;
    const long long slot = slots[r];
    if (slot < 0 || slot >= capacity) continue;
    base[slot * row_words + (i - r * row_words)] = fill;
  }
}

template <typename W>
static void launch(void* base, const void* slots, long long nslots,
                   long long start, long long count, long long row_words,
                   long long capacity, W fill, cudaStream_t s) {
  const int threads = 256;
  W* b = static_cast<W*>(base);
  if (slots != nullptr) {
    clear_list_kernel<W><<<grid_for(nslots * row_words, threads), threads,
                           0, s>>>(b, static_cast<const int32_t*>(slots),
                                   nslots, row_words, capacity, fill);
  } else {
    clear_range_kernel<W><<<grid_for(count * row_words, threads), threads,
                            0, s>>>(b + start * row_words,
                                    count * row_words, fill);
  }
}

// width: bytes per store (1, 4, 8 or 16); the fill pattern is the
// little-endian bytes of (fill_lo, fill_hi) truncated to width.
// slots == nullptr selects the range form (start, count).
extern "C" int ft_clear_rows(void* base, const void* slots, long long nslots,
                             long long start, long long count,
                             long long row_words, long long capacity,
                             int width, unsigned long long fill_lo,
                             unsigned long long fill_hi, void* stream) {
  const long long work = slots != nullptr ? nslots : count;
  if (work > 0 && row_words > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (width) {
      case 1:
        launch<uint8_t>(base, slots, nslots, start, count, row_words,
                        capacity, static_cast<uint8_t>(fill_lo), s);
        break;
      case 4:
        launch<uint32_t>(base, slots, nslots, start, count, row_words,
                         capacity, static_cast<uint32_t>(fill_lo), s);
        break;
      case 8:
        launch<unsigned long long>(base, slots, nslots, start, count,
                                   row_words, capacity, fill_lo, s);
        break;
      case 16: {
        uint4 f;
        f.x = static_cast<unsigned int>(fill_lo);
        f.y = static_cast<unsigned int>(fill_lo >> 32);
        f.z = static_cast<unsigned int>(fill_hi);
        f.w = static_cast<unsigned int>(fill_hi >> 32);
        launch<uint4>(base, slots, nslots, start, count, row_words,
                      capacity, f, s);
        break;
      }
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
