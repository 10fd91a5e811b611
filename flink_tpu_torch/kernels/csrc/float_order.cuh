// float32 min / max with the reference's order (sm_90a), shared by
// scatter_combine and merge_rows.
//
// The reference's .at[].min/max and jax.ops.segment_min/max (XLA on the
// CPU) propagate NaN and order -0 below +0, whatever the row order.  The
// same order, on the bits:
//
//   min: a NaN wins and is stored as FO_NAN_MIN = 0xFFFFFFFF; -0 < +0.
//   max: a NaN wins and is stored as FO_NAN_MAX = 0x7FFFFFFF; +0 > -0.
//
// At most one atomic per value, after a load of the state: a value that
// does not beat what the load saw issues none (the state only moves
// toward the op's winner, so a stale load can only let an atomic through,
// never hold a winner back).  For min, a value whose sign bit is clear
// takes atomicMin on the state's int view (every state with its sign bit
// set is a negative int and stays), and a value whose sign bit is set
// (-0 and the canonical NaN included) takes atomicMax on the unsigned
// view (larger bits = more negative).  Max is the mirror.  FO_NAN_MIN
// wins both of min's comparisons and FO_NAN_MAX both of max's, so a NaN
// that a combine stored stays; a NaN that was in the state before, of
// either sign, keys as the op's NaN, so no value beats it and no atomic
// touches it.
#pragma once

#include <cstdint>

#define FO_NAN_MIN 0xFFFFFFFFu
#define FO_NAN_MAX 0x7FFFFFFFu

__device__ __forceinline__ bool fo_is_nan(unsigned int b) {
  return (b & 0x7FFFFFFFu) > 0x7F800000u;
}

// The value's bits with a NaN made the op's canonical NaN.
template <bool MIN>
__device__ __forceinline__ unsigned int fo_canon(unsigned int b) {
  return fo_is_nan(b) ? (MIN ? FO_NAN_MIN : FO_NAN_MAX) : b;
}

// An int32 key whose signed order is the op's order of the bits (NaN made
// canonical first: FO_NAN_MIN keys to INT_MIN, FO_NAN_MAX to INT_MAX).
__device__ __forceinline__ int fo_key(unsigned int b) {
  return static_cast<int>(b ^ ((static_cast<unsigned int>(
                                   static_cast<int>(b) >> 31)) & 0x7FFFFFFFu));
}

// a (op) b on the bits, for plain stores: a unless b wins strictly, so a
// state keeps its own bits (its NaN's payload too) when nothing beats it.
template <bool MIN>
__device__ __forceinline__ unsigned int fo_pick(unsigned int a, unsigned int b) {
  const unsigned int cb = fo_canon<MIN>(b);
  const int ka = fo_key(fo_canon<MIN>(a)), kb = fo_key(cb);
  return (MIN ? kb < ka : kb > ka) ? cb : a;
}

// true when bits b beat the state's bits cur
template <bool MIN>
__device__ __forceinline__ bool fo_wins(unsigned int b, unsigned int cur) {
  const int kb = fo_key(fo_canon<MIN>(b)), kc = fo_key(fo_canon<MIN>(cur));
  return MIN ? kb < kc : kb > kc;
}

// *p = *p (op) v, atomically, for any other writers of *p; cur is a load
// of *p made before (any earlier value of it).
template <bool MIN>
__device__ __forceinline__ void fo_atomic(unsigned int* p, unsigned int v,
                                          unsigned int cur) {
  if (!fo_wins<MIN>(v, cur)) return;
  const unsigned int b = fo_canon<MIN>(v);
  if ((b >> 31) == 0)   // sign bit clear: the int view
    MIN ? atomicMin(reinterpret_cast<int*>(p), static_cast<int>(b))
        : atomicMax(reinterpret_cast<int*>(p), static_cast<int>(b));
  else                  // sign bit set: the unsigned view, the order reversed
    MIN ? atomicMax(p, b) : atomicMin(p, b);
}
