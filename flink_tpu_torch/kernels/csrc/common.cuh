// Shared helpers for the flink_tpu_torch kernels (sm_90a).
//
// Every kernel is bound through a plain C function that launches on the
// stream it is given and returns cudaGetLastError(); the Python wrapper
// raises when that is not cudaSuccess.  Kernels allocate nothing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Grid size for a grid-stride loop over n items: enough blocks to fill
// the 132 SMs several times over, no more than the work needs.
static inline unsigned int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 32LL;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

// The current device's SM count (132 on an H100 SXM), read once per
// device.
static inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
    cached[dev] = sms;
  }
  return cached[dev];
}

#define FT_GRID_STRIDE(i, n)                                              \
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +    \
                     threadIdx.x;                                         \
       i < (n); i += static_cast<long long>(gridDim.x) * blockDim.x)
