// Shared definitions of the fedrann_tpu_torch CUDA kernels.
//
// A staged slot is one int64: (canonical_code << 1) | is_fwd for a sampled
// valid window, PAD_SLOT (INT64_MAX) for everything else. The largest
// canonical code is below 2^62 - 1 (the all-ones 31-mer's reverse
// complement is 0), so no real slot reaches PAD_SLOT, and sorting slots
// ascending orders them by (code, strand) with the padding last.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int64_t PAD_SLOT = INT64_MAX;
constexpr int SELECT_BLOCK = 1024;  // membership.SELECT_BLOCK

// Sum of one int per thread over the whole block. Every thread must call
// it; `acc` is a __shared__ int. Ends with a barrier, so shared-memory
// writes made before the call are visible after it.
__device__ __forceinline__ int block_sum(int v, int* acc) {
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicAdd(acc, v);
  __syncthreads();
  const int total = *acc;
  __syncthreads();  // *acc may be reset by the next call
  return total;
}

// Order-preserving compaction over the whole block: returns the slot of
// this thread's item among the items kept by the block, in thread order
// (warp ballots plus a block prefix of the warp counts), or -1 when `keep`
// is false; *count receives the block's number of kept items. Every thread
// must call it; blockDim.x is a multiple of 32; `scratch` is a __shared__
// int[33]. Calls may follow each other with no barrier between them: a
// warp rewrites its count only after a __syncwarp, which all its lanes
// reach after reading the previous call's base.
__device__ __forceinline__ int block_compact(bool keep, int* scratch,
                                             int* count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  __syncwarp();
  if (lane == 0) scratch[warp] = __popc(mask);
  __syncthreads();
  if (warp == 0) {
    const int own = lane < n_warps ? scratch[lane] : 0;
    int incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < n_warps) scratch[lane] = incl - own;
    if (lane == 31) scratch[32] = incl;
  }
  __syncthreads();
  *count = scratch[32];
  return keep ? scratch[warp] + __popc(mask & ((1u << lane) - 1u)) : -1;
}

// Ascending bitonic sort of n (a power of two) int64 keys in shared
// memory by the whole block. The caller synchronises before the call (the
// keys must be in place); the last stage ends with a barrier.
__device__ __forceinline__ void bitonic_sort(int64_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        const int l = i + j;
        const bool up = (i & k) == 0;
        const int64_t a = s[i], b = s[l];
        if ((a > b) == up) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
  }
}
