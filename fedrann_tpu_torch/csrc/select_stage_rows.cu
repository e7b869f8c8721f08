// Kernel B: per-read candidate selection and row sort -> staged rows.
//
// Replaces the TPU kernel `sort_rows_pallas` (bench/pallas_sort.py:96,
// `_sort_kernel` :66, `_cmp_exchange` :38) and computes what its production
// twin computes: fedrann_tpu/kmers/membership.py `select_candidates`
// (:282-337) after the sampling mask, i.e. the blocked selection, the cap
// slice, the narrow sort, the `width` slice and the exact dropped count.
//
// One thread block per read row, the row's slots in shared memory:
//   blocked (w > 2 * SELECT_BLOCK and not keep_all): each 1024-slot block
//     is bitonic-sorted in shared memory and its first `cap` slots (the
//     smallest; padding sorts last) are appended to a survivor buffer; the
//     survivors, padded to a power of two, are bitonic-sorted and the first
//     `width` = min(hit_buffer, n_blocks * cap) are written;
//   full: the whole row, padded to a power of two, is sorted and the first
//     `hit_buffer` slots are written.
// dropped = candidates - staged candidates, exactly as the JAX stage counts
// them (per-block cap overflow included). Keys are distinct-or-identical
// int64s with no payload, so the unstable network gives the same bytes as
// any sort.
//
// Bound on the card: shared-memory bandwidth and barriers. A 1024-slot
// block takes 55 compare-exchange stages with a barrier each; the row's
// global traffic is one read of its slots and one write of `width` slots.
// The wrapper sizes the dynamic shared memory (survivor buffer plus one
// block) and raises when a row does not fit the 227 KB a block may use.

#include "common.cuh"

namespace {

__global__ void select_stage_rows_kernel(const int64_t* __restrict__ slots,
                                         int64_t w, int64_t hit_buffer,
                                         int blocked, int cap, int n_blocks,
                                         int sort_n,
                                         int64_t* __restrict__ staged,
                                         int64_t width,
                                         int32_t* __restrict__ dropped) {
  extern __shared__ int64_t smem[];
  __shared__ int acc;
  int64_t* surv = smem;  // sort_n slots
  const int64_t r = blockIdx.x;
  const int64_t* row = slots + r * w;

  if (!blocked) {
    int local = 0;
    for (int i = threadIdx.x; i < sort_n; i += blockDim.x) {
      const int64_t v = i < w ? row[i] : PAD_SLOT;
      surv[i] = v;
      local += v != PAD_SLOT;
    }
    const int n_cand = block_sum(local, &acc);
    bitonic_sort(surv, sort_n);
    for (int64_t i = threadIdx.x; i < width; i += blockDim.x)
      staged[r * width + i] = surv[i];
    if (threadIdx.x == 0)
      dropped[r] = static_cast<int32_t>(
          n_cand > hit_buffer ? n_cand - hit_buffer : 0);
    return;
  }

  int64_t* blk = smem + sort_n;  // SELECT_BLOCK slots
  int64_t n_cand = 0, survivors = 0;
  for (int b = 0; b < n_blocks; ++b) {
    int local = 0;
    for (int i = threadIdx.x; i < SELECT_BLOCK; i += blockDim.x) {
      const int64_t c = static_cast<int64_t>(b) * SELECT_BLOCK + i;
      const int64_t v = c < w ? row[c] : PAD_SLOT;
      blk[i] = v;
      local += v != PAD_SLOT;
    }
    const int cnt = block_sum(local, &acc);
    bitonic_sort(blk, SELECT_BLOCK);
    for (int i = threadIdx.x; i < cap; i += blockDim.x)
      surv[b * cap + i] = blk[i];
    n_cand += cnt;
    survivors += cnt < cap ? cnt : cap;
    __syncthreads();  // blk is refilled by the next block
  }
  for (int i = n_blocks * cap + threadIdx.x; i < sort_n; i += blockDim.x)
    surv[i] = PAD_SLOT;
  __syncthreads();
  bitonic_sort(surv, sort_n);
  for (int64_t i = threadIdx.x; i < width; i += blockDim.x)
    staged[r * width + i] = surv[i];
  if (threadIdx.x == 0)
    dropped[r] = static_cast<int32_t>(
        n_cand - (survivors < width ? survivors : width));
}

}  // namespace

extern "C" int fk_select_stage_rows(const int64_t* slots, int64_t rows,
                                    int64_t w, int64_t hit_buffer,
                                    int blocked, int cap, int n_blocks,
                                    int sort_n, int smem_bytes,
                                    int64_t* staged, int64_t width,
                                    int32_t* dropped, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_stage_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_stage_rows_kernel<<<static_cast<unsigned>(rows), 512, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      slots, w, hit_buffer, blocked, cap, n_blocks, sort_n, staged, width,
      dropped);
  return static_cast<int>(cudaGetLastError());
}
