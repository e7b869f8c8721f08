// Kernel B: per-read candidate selection and row sort -> staged rows.
//
// Replaces the TPU kernel `sort_rows_pallas` (bench/pallas_sort.py:96,
// `_sort_kernel` :66, `_cmp_exchange` :38) and computes what its production
// twin computes: fedrann_tpu/kmers/membership.py `select_candidates`
// (:282-337) after the sampling mask, i.e. the blocked selection, the cap
// slice, the narrow sort, the `width` slice and the exact dropped count.
//
// Short rows (the row's sort buffer fits a block's shared memory): one
// thread block per read row, the row's slots in shared memory:
//   blocked (w > 2 * SELECT_BLOCK and not keep_all): each 1024-slot block
//     is bitonic-sorted in shared memory and its first `cap` slots (the
//     smallest; padding sorts last) are appended to a survivor buffer; the
//     survivors, padded to a power of two, are bitonic-sorted and the first
//     `width` = min(hit_buffer, n_blocks * cap) are written;
//   full: the whole row, padded to a power of two, is sorted and the first
//     `hit_buffer` slots are written.
// Long rows (keep_all past 16,384 windows, or >= ~3.1% sampling at the
// 262,144-base bucket) take a device-memory path, one launch per pass over
// all rows (rows are independent, so no pass synchronises across rows):
//   1. blocked rows: one thread block per (row, 1024-slot block) sorts its
//      block in shared memory and writes its first `cap` slots to a survivor
//      buffer (R, n_blocks * cap), its candidate count and min(count, cap);
//   2. the survivors (or, for full rows, the row itself) are cut into chunks
//      of `chunk` slots (a power of two, padding past the row's end), each
//      bitonic-sorted in shared memory;
//   3. sorted runs are merged pairwise in device memory until one is left:
//      element a at index i of run A goes to i + lower_bound(B, a), element
//      b at index j of run B to j + upper_bound(A, b), positions that are
//      unique with duplicate keys. A run keeps only its first `width`
//      slots: no slot past them can reach the first `width` of the row;
//   4. dropped = candidates - min(survivors, width) from the pass-1 counts
//      (the chunk counts for full rows), never from the cut runs.
// dropped = candidates - staged candidates, exactly as the JAX stage counts
// them (per-block cap overflow included). Keys are distinct-or-identical
// int64s with no payload, so the unstable network gives the same bytes as
// any sort.
//
// Bound on the card: shared-memory bandwidth and barriers. A 1024-slot
// block takes 55 compare-exchange stages with a barrier each; a short row's
// global traffic is one read of its slots and one write of `width` slots.
// The long path adds one device-memory round trip of the survivors per
// merge pass, each element a binary search of log2(run) reads in its
// partner run (L2-resident at these sizes).

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


// ---- long rows: the device-memory path ----

// Pass 1 (blocked rows): one thread block per (row, 1024-slot block).
__global__ void select_blocks_kernel(const int64_t* __restrict__ slots,
                                     int64_t w, int n_blocks, int cap,
                                     int64_t* __restrict__ surv,
                                     int64_t n_surv,
                                     int32_t* __restrict__ cand,
                                     int32_t* __restrict__ kept) {
  __shared__ int64_t blk[SELECT_BLOCK];
  __shared__ int acc;
  const int64_t r = blockIdx.x / n_blocks;
  const int b = static_cast<int>(blockIdx.x % n_blocks);
  const int64_t* row = slots + r * w;
  int local = 0;
  for (int i = threadIdx.x; i < SELECT_BLOCK; i += blockDim.x) {
    const int64_t c = static_cast<int64_t>(b) * SELECT_BLOCK + i;
    const int64_t v = c < w ? row[c] : PAD_SLOT;
    blk[i] = v;
    local += v != PAD_SLOT;
  }
  const int cnt = block_sum(local, &acc);
  bitonic_sort(blk, SELECT_BLOCK);
  int64_t* out = surv + r * n_surv + static_cast<int64_t>(b) * cap;
  for (int i = threadIdx.x; i < cap; i += blockDim.x) out[i] = blk[i];
  if (threadIdx.x == 0) {
    cand[r * n_blocks + b] = cnt;
    kept[r * n_blocks + b] = cnt < cap ? cnt : cap;
  }
}

// Pass 2: one thread block per (row, chunk) sorts `chunk` slots of the
// row's first n_valid (padding past them) in shared memory and writes its
// first `keep`. `cand`, when given, receives each chunk's candidate count.
__global__ void sort_chunks_kernel(const int64_t* __restrict__ src,
                                   int64_t src_stride, int64_t n_valid,
                                   int chunk, int n_chunks, int keep,
                                   int64_t* __restrict__ out,
                                   int64_t out_stride,
                                   int32_t* __restrict__ cand) {
  extern __shared__ int64_t buf[];
  __shared__ int acc;
  const int64_t r = blockIdx.x / n_chunks;
  const int c = static_cast<int>(blockIdx.x % n_chunks);
  const int64_t base = static_cast<int64_t>(c) * chunk;
  const int64_t* row = src + r * src_stride;
  int local = 0;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int64_t v = base + i < n_valid ? row[base + i] : PAD_SLOT;
    buf[i] = v;
    local += v != PAD_SLOT;
  }
  const int cnt = block_sum(local, &acc);
  if (cand != nullptr && threadIdx.x == 0) cand[r * n_chunks + c] = cnt;
  if (base < n_valid) bitonic_sort(buf, chunk);  // else all padding
  for (int i = threadIdx.x; i < keep; i += blockDim.x)
    out[r * out_stride + base + i] = buf[i];
}

// Pass 3: merge sorted runs of `run` slots (the first m of each valid)
// pairwise into runs of 2 * run slots of which the first m2 are written.
// One thread per input slot; rows are `stride` apart in `in`.
__global__ void merge_runs_kernel(const int64_t* __restrict__ in,
                                  int64_t stride, int64_t row_blocks,
                                  int64_t run, int64_t m, int64_t m2,
                                  int64_t* __restrict__ out,
                                  int64_t out_stride) {
  const int64_t r = blockIdx.x / row_blocks;
  const int64_t p =
      (blockIdx.x % row_blocks) * static_cast<int64_t>(blockDim.x) +
      threadIdx.x;
  const int64_t k = p / run;  // run index within the row
  const int64_t i = p - k * run;
  if (i >= m) return;
  const int64_t* self = in + r * stride + k * run;
  const int64_t* other = in + r * stride + (k ^ 1) * run;
  const int64_t v = self[i];
  const bool first = (k & 1) == 0;
  int64_t lo = 0, hi = m;
  while (lo < hi) {  // first: #other < v; second: #other <= v
    const int64_t mid = (lo + hi) >> 1;
    const int64_t o = other[mid];
    if (o < v || (!first && o == v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int64_t pos = i + lo;
  if (pos < m2) out[r * out_stride + (k >> 1) * 2 * run + pos] = v;
}

// Pass 4: dropped[r] = sum(cand) - min(sum(kept), width) over a row's
// `groups` counts.
__global__ void stage_dropped_kernel(const int32_t* __restrict__ cand,
                                     const int32_t* __restrict__ kept,
                                     int groups, int64_t width,
                                     int32_t* __restrict__ dropped) {
  __shared__ int acc;
  const int64_t r = blockIdx.x;
  int c = 0, s = 0;
  for (int i = threadIdx.x; i < groups; i += blockDim.x) {
    c += cand[r * groups + i];
    s += kept[r * groups + i];
  }
  const int n_cand = block_sum(c, &acc);
  const int survivors = block_sum(s, &acc);
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

// The long-row path: passes 1-4 above, each one launch over all rows.
// Scratch comes from the caller: surv (rows, n_blocks * cap) for blocked
// rows; buf_a (rows, n_chunks * chunk) when n_chunks >= 2 and buf_b of the
// same size when n_chunks >= 4; cand and kept (rows, groups) int32 with
// groups = n_blocks (blocked) or n_chunks (full rows, kept == cand).
// n_chunks is a power of two; the last pass writes into staged.
extern "C" int fk_select_stage_long(const int64_t* slots, int64_t rows,
                                    int64_t w, int blocked, int cap,
                                    int n_blocks, int64_t n_surv, int chunk,
                                    int n_chunks, int64_t width,
                                    int64_t* surv, int64_t* buf_a,
                                    int64_t* buf_b, int32_t* cand,
                                    int32_t* kept, int64_t* staged,
                                    int32_t* dropped, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int64_t* src = slots;
  if (blocked) {
    select_blocks_kernel<<<static_cast<unsigned>(rows * n_blocks), 512, 0,
                           st>>>(slots, w, n_blocks, cap, surv, n_surv, cand,
                                 kept);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = surv;
  }
  const int smem_bytes = chunk * static_cast<int>(sizeof(int64_t));
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sort_chunks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not sticky: clear it for the next launch
      return static_cast<int>(err);
    }
  }
  const int64_t n_pad = static_cast<int64_t>(chunk) * n_chunks;
  const int keep = static_cast<int>(width < chunk ? width : chunk);
  int64_t* out = n_chunks == 1 ? staged : buf_a;
  sort_chunks_kernel<<<static_cast<unsigned>(rows * n_chunks), 1024,
                       smem_bytes, st>>>(
      src, blocked ? n_surv : w, blocked ? n_surv : w, chunk, n_chunks, keep,
      out, n_chunks == 1 ? width : n_pad, blocked ? nullptr : cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t* cur = buf_a;
  int64_t* other = buf_b;
  const int threads = 256;
  const int64_t row_blocks = n_pad / threads;
  for (int64_t run = chunk; run < n_pad; run *= 2) {
    const bool last = 2 * run == n_pad;
    const int64_t m = run < width ? run : width;
    const int64_t m2 = 2 * run < width ? 2 * run : width;
    out = last ? staged : other;
    merge_runs_kernel<<<static_cast<unsigned>(rows * row_blocks), threads, 0,
                        st>>>(cur, n_pad, row_blocks, run, m, m2, out,
                              last ? width : n_pad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    other = cur;
    cur = out;
  }
  stage_dropped_kernel<<<static_cast<unsigned>(rows), 256, 0, st>>>(
      cand, kept, blocked ? n_blocks : n_chunks, width, dropped);
  return static_cast<int>(cudaGetLastError());
}
