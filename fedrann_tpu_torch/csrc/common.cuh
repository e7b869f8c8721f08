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

// Exclusive prefix sum of one int per thread over the whole block, in
// thread order; *total receives the block's sum. Every thread must call
// it; blockDim.x is a multiple of 32; `scratch` is a __shared__ int[33].
// Ends with a barrier. Two calls in a row must use different scratch
// arrays (a fast warp may write the next call's count before a slow one
// has read this call's prefix).
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < n_warps ? scratch[lane] : 0;
    int w_incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w_incl, o);
      if (lane >= o) w_incl += u;
    }
    if (lane < n_warps) scratch[lane] = w_incl - own;
    if (lane == 31) scratch[32] = w_incl;
  }
  __syncthreads();
  *total = scratch[32];
  return scratch[warp] + incl - v;
}

// Ascending sort of the n int64 keys s[0, n) in shared memory by the
// whole block (n need not be a power of two). A bitonic network over
// pow2(n) slots in its all-ascending form: the first step of each merge
// compares slot i with its mirror in the merge block, the later steps i
// with i + j. Slots past n are virtual +inf: a comparator that reaches one
// leaves both slots as they are, so nothing past n is read or written and
// the buffer needs only n slots. A step of span j <= 32 stays inside the
// 64 slots of one warp's pairs, so it waits at a warp barrier; only wider
// steps wait for the block. The caller synchronises before the call (the
// keys must be in place); the call ends with a block barrier.
__device__ __forceinline__ void bitonic_sort_n(int64_t* s, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n2 >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        const int l = j == (k >> 1) ? (i | (k - 1)) - (i & (k - 1)) : i + j;
        if (l < n) {
          const int64_t a = s[i], b = s[l];
          if (a > b) {
            s[i] = b;
            s[l] = a;
          }
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // span of the next step
      if (j > 32 || next > 32 || (k == n2 && j == 1)) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  if (n2 < 2) __syncthreads();
}
