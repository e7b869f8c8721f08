// Kernel B: per-read candidate selection and row sort -> staged rows; on
// its one-block path fused with kernel A's window codes.
//
// Replaces the TPU kernels `sort_rows_pallas` (bench/pallas_sort.py:96, its
// pallas_call :128, `_sort_kernel` :66, `_cmp_exchange` :38) and, fused,
// `canonical_and_sample` (bench/pallas_kernels.py:128), and computes what
// their production twin computes: fedrann_tpu/kmers/membership.py
// `stage_candidates` (:254-279), one device program from bases to staged
// rows: the window codes and the sampling mask, then `select_candidates`
// (:282-337), i.e. the blocked selection, the cap slice, the narrow sort,
// the `width` slice and the exact dropped count.
//
// Rows whose survivor buffer fits a block's shared memory (`fk_stage_rows`,
// kernels A and B fused): one thread block of 256 threads per row (1,024
// where the buffer leaves room for only one block an SM), 4 slots a thread
// (1) per 1024-slot block. The slots are computed from the bases by
// window_slots (window_codes.cuh), O(1) operations a window, with the next
// block's bases loaded one block ahead, from the rows' source: a byte
// matrix, or the packer's 2-bit stream with each row's length or valid
// bits (the pipeline's upload). The (R, W) slot plane never reaches device
// memory: the function reads one byte of bases per window (a quarter byte
// packed) and writes `width` staged slots (at the main path's 2,048 x
// 16,384 chunk from bytes 33.5 MB in, 16.8 MB out, 0.015 ms at 3.35
// TB/s), so integer work bounds it: the window codes and the hash, 43
// integer-pipe instructions a valid sampled window at k <= 16 from bytes,
// 40 packed (window_codes.cuh counts them), ~0.05 ms over 132 SMs x 64
// INT32 lanes x 1.98 GHz. Then:
//   1. each 1024-slot block's candidates (slots other than PAD_SLOT) are
//      compacted into the survivor buffer in shared memory by a block
//      prefix sum (`block_scan`) and counted;
//   2. a block holding at most `cap` candidates keeps all of them, unsorted:
//      the JAX stage keeps its `cap` smallest slots, padding last, and
//      those are exactly its candidates. A block holding more (rare: cap is
//      the sampling mean + 6 sigma) sorts only its candidates, in place,
//      and keeps the first `cap`;
//   3. the survivors are sorted once, sized by their count, not by the
//      blocks' capacity: `bitonic_sort_n` runs the bitonic network over
//      pow2(count) slots with virtual +inf padding, so the buffer holds
//      only the survivors (plus one 1024-slot block being compacted), and
//      its steps of span <= 32 wait at warp barriers, not block barriers.
//      A network and not warp register sorts plus a merge: the survivors
//      already sit in shared memory, a network of 55 steps (1,024 keys)
//      of which 15 wait for the block is short, and it needs no
//      merge-path partitioning;
//   4. the first `width` slots are written, padding after them; dropped =
//      candidates - min(survivors, width).
// Full-width rows (keep_all, or w <= 2 * SELECT_BLOCK) take the same
// kernel with cap = SELECT_BLOCK: every candidate survives, so compaction
// only removes the padding, and the whole row's candidates are sorted.
// Long rows whose survivors do not fit one block (keep_all past 28,928
// windows; blocked rows at >= 6.5% sampling at the 262,144-base bucket,
// >= 14.5% at 131,072; membership.stage_launch_plan decides) take kernel
// A's plane and a device-memory path, one launch per pass over all rows
// (rows are independent, so no pass synchronises across rows):
//   1. blocked rows: one thread block per (row, 1024-slot block) compacts
//      its candidates as above and writes `cap` slots (its candidates, or
//      the sorted first cap of them, then padding) to a survivor buffer
//      (R, n_blocks * cap), with its candidate count and min(count, cap);
//   2. the survivors (or, for full rows, the row itself) are cut into chunks
//      of `chunk` slots (a power of two, padding past the row's end), each
//      sorted in shared memory;
//   3. sorted runs are merged pairwise in device memory until one is left:
//      element a at index i of run A goes to i + lower_bound(B, a), element
//      b at index j of run B to j + upper_bound(A, b), positions that are
//      unique with duplicate keys. A run keeps only its first `width`
//      slots: no slot past them can reach the first `width` of the row;
//   4. dropped = candidates - min(survivors, width) from the pass-1 counts
//      (the chunk counts for full rows), never from the cut runs.
// dropped = candidates - staged candidates, exactly as the JAX stage counts
// them (per-block cap overflow included). Keys are distinct-or-identical
// int64s with no payload, so any correct sort of the same multiset gives
// the same bytes, whatever order the compaction left them in.

#include "window_codes.cuh"

namespace {

constexpr int SELECT_THREADS = 256;  // a row's block, and pass 1's
// a row whose survivor buffer leaves room for only one block an SM (past
// WIDE_SMEM of the SM's 228 KB) takes WIDE_THREADS: with 256 the SM's
// other threads would idle, and the survivor sort (~13,000 slots at the
// 262,144-base bucket) runs 4x wider
constexpr int WIDE_THREADS = 1024;
constexpr int WIDE_SMEM = 114 * 1024;

// Thread t's SELECT_BLOCK / THREADS slots of 1024-slot block b of a row of
// w slots (padding past w, and for a block past the row). 16-byte loads
// where the row is 16-byte aligned.
template <int THREADS>
__device__ __forceinline__ void load_slots(
    const int64_t* __restrict__ row, int64_t w, int64_t b, int n_blocks,
    bool aligned, int64_t (&v)[SELECT_BLOCK / THREADS]) {
  constexpr int PER = SELECT_BLOCK / THREADS;
  const int64_t c = b * SELECT_BLOCK + PER * threadIdx.x;
  if (PER % 2 == 0 && b < n_blocks && aligned && c + PER <= w) {
    const longlong2* p = reinterpret_cast<const longlong2*>(row + c);
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const longlong2 x = p[i];
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    v[i] = b < n_blocks && c + i < w ? row[c + i] : PAD_SLOT;
}

// Appends this thread's candidates among v to buf (the block's running
// end), compacted by a block prefix sum; returns the block's count.
template <int PER>
__device__ __forceinline__ int compact_slots(const int64_t (&v)[PER],
                                             int64_t* buf, int* scratch) {
  int own = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) own += v[i] != PAD_SLOT;
  int count;
  int pos = block_scan(own, scratch, &count);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (v[i] != PAD_SLOT) buf[pos++] = v[i];
  return count;
}

// One block of THREADS per row, its slots computed from its bases one
// 1024-slot block at a time (kernels A and B fused; WIDE: k > 16). Threads
// 0..WINDOW_CHUNKS-1 hold the chunks of the next block's bases, loaded
// while the block before it is computed. One stage serves every block:
// compact_slots' barrier lies between a block's reads of it and the next
// block's writes. Shared memory holds the row's survivors plus one
// 1024-slot block being compacted. Full-width rows come with cap =
// SELECT_BLOCK and width = hit_buffer.
template <int THREADS, bool WIDE, int SRC>
__global__ void __launch_bounds__(THREADS)
select_stage_rows_kernel(const WindowParams p, int cap, int n_blocks,
                         int64_t* __restrict__ staged, int64_t width,
                         int32_t* __restrict__ dropped) {
  constexpr int PER = SELECT_BLOCK / THREADS;
  using Raw = typename RowSource<SRC>::Raw;
  extern __shared__ int64_t surv[];
  __shared__ int scratch[2][33];
  __shared__ WindowStage stage;
  const int64_t r = blockIdx.x;
  const RowSource<SRC> src(p, r);
  const int chunk =
      threadIdx.x < WINDOW_CHUNKS ? static_cast<int>(threadIdx.x) : -1;
  Raw next{};  // this thread's chunk of the next block
  if (chunk >= 0) next = src.fetch(0, chunk);
  int n_surv = 0, n_cand = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const Raw held = next;
    if (chunk >= 0 && b + 1 < n_blocks) next = src.fetch(b + 1, chunk);
    WindowChunk bits{};
    if (chunk >= 0) bits = RowSource<SRC>::chunk(held);
    int64_t v[PER];
    window_slots<PER, WIDE>(p, b, chunk, bits, stage, v);
    const int count = compact_slots(v, surv + n_surv, scratch[b & 1]);
    n_cand += count;
    if (count > cap) {  // keep the block's cap smallest candidates
      __syncthreads();
      bitonic_sort_n(surv + n_surv, count);
      n_surv += cap;
    } else {
      n_surv += count;
    }
  }
  __syncthreads();
  bitonic_sort_n(surv, n_surv);
  for (int64_t i = threadIdx.x; i < width; i += blockDim.x)
    staged[r * width + i] = i < n_surv ? surv[i] : PAD_SLOT;
  if (threadIdx.x == 0)
    dropped[r] = static_cast<int32_t>(
        n_cand - (n_surv < width ? n_surv : width));
}

// Launches the one-block kernel over `rows` rows with 256 threads or, past
// WIDE_SMEM of survivor buffer, 1,024. Full-width rows (blocked = 0) keep
// every candidate.
template <bool WIDE, int SRC>
int launch_stage_rows(const WindowParams& p, int64_t rows, int64_t w,
                      int64_t hit_buffer, int blocked, int cap, int n_blocks,
                      int smem_bytes, int64_t* staged, int64_t width,
                      int32_t* dropped, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (!blocked) {
    cap = SELECT_BLOCK;
    n_blocks = static_cast<int>((w + SELECT_BLOCK - 1) / SELECT_BLOCK);
    width = hit_buffer;
  }
  const bool wide = smem_bytes > WIDE_SMEM;
  const void* kernel = wide
      ? reinterpret_cast<const void*>(
            select_stage_rows_kernel<WIDE_THREADS, WIDE, SRC>)
      : reinterpret_cast<const void*>(
            select_stage_rows_kernel<SELECT_THREADS, WIDE, SRC>);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    select_stage_rows_kernel<WIDE_THREADS, WIDE, SRC>
        <<<static_cast<unsigned>(rows), WIDE_THREADS, smem_bytes, st>>>(
            p, cap, n_blocks, staged, width, dropped);
  } else {
    select_stage_rows_kernel<SELECT_THREADS, WIDE, SRC>
        <<<static_cast<unsigned>(rows), SELECT_THREADS, smem_bytes, st>>>(
            p, cap, n_blocks, staged, width, dropped);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool WIDE>
int launch_stage_rows_src(int src, const WindowParams& p, int64_t rows,
                          int64_t w, int64_t hit_buffer, int blocked, int cap,
                          int n_blocks, int smem_bytes, int64_t* staged,
                          int64_t width, int32_t* dropped, void* stream) {
  if (src == SRC_PACKED)
    return launch_stage_rows<WIDE, SRC_PACKED>(
        p, rows, w, hit_buffer, blocked, cap, n_blocks, smem_bytes, staged,
        width, dropped, stream);
  if (src == SRC_BITS)
    return launch_stage_rows<WIDE, SRC_BITS>(
        p, rows, w, hit_buffer, blocked, cap, n_blocks, smem_bytes, staged,
        width, dropped, stream);
  return launch_stage_rows<WIDE, SRC_BYTES>(
      p, rows, w, hit_buffer, blocked, cap, n_blocks, smem_bytes, staged,
      width, dropped, stream);
}

// The static shared memory of one instance of the one-block kernel.
template <int THREADS, bool WIDE, int SRC>
cudaError_t static_smem(int32_t* most) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(
                 select_stage_rows_kernel<THREADS, WIDE, SRC>));
  if (err == cudaSuccess && static_cast<int32_t>(attr.sharedSizeBytes) > *most)
    *most = static_cast<int32_t>(attr.sharedSizeBytes);
  return err;
}

template <int THREADS, bool WIDE>
cudaError_t static_smem_sources(int32_t* most) {
  cudaError_t err = static_smem<THREADS, WIDE, SRC_BYTES>(most);
  if (err == cudaSuccess) err = static_smem<THREADS, WIDE, SRC_PACKED>(most);
  if (err == cudaSuccess) err = static_smem<THREADS, WIDE, SRC_BITS>(most);
  return err;
}

// ---- long rows: the device-memory path ----

// Pass 1 (blocked rows): one thread block per (row, 1024-slot block).
__global__ void __launch_bounds__(SELECT_THREADS)
select_blocks_kernel(const int64_t* __restrict__ slots, int64_t w,
                     int n_blocks, int cap, int64_t* __restrict__ surv,
                     int64_t n_surv, int32_t* __restrict__ cand,
                     int32_t* __restrict__ kept) {
  __shared__ int64_t blk[SELECT_BLOCK];
  __shared__ int scratch[33];
  const int64_t r = blockIdx.x / n_blocks;
  const int b = static_cast<int>(blockIdx.x % n_blocks);
  const int64_t* row = slots + r * w;
  int64_t v[SELECT_BLOCK / SELECT_THREADS];
  load_slots<SELECT_THREADS>(row, w, b, n_blocks,
                             (reinterpret_cast<uintptr_t>(row) & 15) == 0, v);
  const int count = compact_slots(v, blk, scratch);
  int64_t* out = surv + r * n_surv + static_cast<int64_t>(b) * cap;
  __syncthreads();
  if (count > cap) bitonic_sort_n(blk, count);
  for (int i = threadIdx.x; i < cap; i += blockDim.x)
    out[i] = i < count ? blk[i] : PAD_SLOT;
  if (threadIdx.x == 0) {
    cand[r * n_blocks + b] = count;
    kept[r * n_blocks + b] = count < cap ? count : cap;
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
  if (base < n_valid) bitonic_sort_n(buf, chunk);  // else all padding
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

// Rows whose survivors fit shared memory, staged from their bases:
// kernels A and B fused, the slots computed in the block
// (window_codes.cuh) from the rows' source src (SRC_BYTES, SRC_PACKED or
// SRC_BITS, which says what `bases` and `aux` hold: WindowParams).
// smem_bytes holds min(w, (n_blocks - 1) * cap + SELECT_BLOCK) slots
// (membership.stage_launch_plan); full-width rows (blocked = 0) keep every
// candidate. s1 = fmix32(seed32), s2 = fmix32(s1 ^ 0x9E3779B9), computed
// by the caller.
extern "C" int fk_stage_rows(const uint8_t* bases, const void* aux, int src,
                             int64_t rows, int64_t length, int64_t w, int k,
                             uint32_t s1, uint32_t s2, uint32_t threshold,
                             int keep_all, int64_t hit_buffer, int blocked,
                             int cap, int n_blocks, int smem_bytes,
                             int64_t* staged, int64_t width, int32_t* dropped,
                             void* stream) {
  if (src < SRC_BYTES || src > SRC_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const WindowParams p{bases, aux, length,
                       src == SRC_BYTES ? length : (length + 3) / 4,
                       w, k, s1, s2, threshold, keep_all};
  if (k > 16)
    return launch_stage_rows_src<true>(src, p, rows, w, hit_buffer, blocked,
                                       cap, n_blocks, smem_bytes, staged,
                                       width, dropped, stream);
  return launch_stage_rows_src<false>(src, p, rows, w, hit_buffer, blocked,
                                      cap, n_blocks, smem_bytes, staged,
                                      width, dropped, stream);
}

// The most static shared memory (bytes) any one-block kernel holds, both
// code widths at both thread counts from every source, into *bytes: the
// allowance membership.STATIC_SMEM keeps beside the survivor buffer must
// cover it.
extern "C" int fk_stage_rows_static_smem(int32_t* bytes) {
  int32_t most = 0;
  cudaError_t err = static_smem_sources<SELECT_THREADS, false>(&most);
  if (err == cudaSuccess)
    err = static_smem_sources<WIDE_THREADS, false>(&most);
  if (err == cudaSuccess)
    err = static_smem_sources<SELECT_THREADS, true>(&most);
  if (err == cudaSuccess) err = static_smem_sources<WIDE_THREADS, true>(&most);
  *bytes = most;
  return static_cast<int>(err);
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
    select_blocks_kernel<<<static_cast<unsigned>(rows * n_blocks),
                           SELECT_THREADS, 0, st>>>(
        slots, w, n_blocks, cap, surv, n_surv, cand, kept);
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
