// set_rows: write n contiguous source rows into the rows of one
// [C, row_bytes] state component named by a slot list:
// base[slots[i]] = rows[i].
//
// Replaces flink_tpu/state/tpu_backend.py _jit_upload (the host-tier
// promotion's single-row .at[slot].set) and the .at[idx].set of
// restore_columns / restore_entries (one upload per component).  The
// source rows arrive from the host through pinned staging and are
// copied to the device by the wrapper before this launch.
//
// Bound on this card: bytes (n * row_bytes read, the same written, 4 B
// per slot read).
//
// Design: a row scatter with no arithmetic.  The wrapper picks the
// widest store W in {16, 8, 4, 1} bytes that divides the row and the
// alignment of both buffers, so a 4096-byte HLL row is 256 16-byte
// loads and stores; a grid-stride loop maps a flat index to (row,
// word), consecutive threads on consecutive words.  Slots outside
// [0, C) are skipped (-1 is the port's skip mark; XLA's .at[].set would
// wrap a slot in [-C, -1] to s + C: ops/slot_index.py).  With a
// repeated slot the last writer is unspecified, as .at[].set leaves it;
// the backend's slots are unique.
#include "common.cuh"

template <typename W>
__global__ void set_rows_kernel(W* __restrict__ base,
                                const int32_t* __restrict__ slots,
                                const W* __restrict__ rows, long long n,
                                long long row_words, long long capacity) {
  FT_GRID_STRIDE(i, n * row_words) {
    const long long r = i / row_words;
    const long long slot = slots[r];
    if (slot < 0 || slot >= capacity) continue;
    base[slot * row_words + (i - r * row_words)] = rows[i];
  }
}

template <typename W>
static void launch(void* base, const void* slots, const void* rows,
                   long long n, long long row_words, long long capacity,
                   cudaStream_t s) {
  const int threads = 256;
  set_rows_kernel<W><<<grid_for(n * row_words, threads), threads, 0, s>>>(
      static_cast<W*>(base), static_cast<const int32_t*>(slots),
      static_cast<const W*>(rows), n, row_words, capacity);
}

// width: bytes per load/store (1, 4, 8 or 16); row_words = row bytes /
// width.
extern "C" int ft_set_rows(void* base, const void* slots, const void* rows,
                           long long n, long long row_words,
                           long long capacity, int width, void* stream) {
  if (n > 0 && row_words > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (width) {
      case 1:
        launch<uint8_t>(base, slots, rows, n, row_words, capacity, s);
        break;
      case 4:
        launch<unsigned int>(base, slots, rows, n, row_words, capacity, s);
        break;
      case 8:
        launch<unsigned long long>(base, slots, rows, n, row_words, capacity,
                                   s);
        break;
      case 16:
        launch<uint4>(base, slots, rows, n, row_words, capacity, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
