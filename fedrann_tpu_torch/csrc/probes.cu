// Capability probes: the counterparts of the Mosaic probes of
// bench/probe_mosaic.py and bench/probe_mosaic2.py on Hopper. Each is a
// micro-kernel whose answer says what one access pattern of the staging
// and embed kernels costs on this card:
//
//   fk_probe_smem_scratch  (P1, probe_mosaic.py:32 `probe_smem_scratch`):
//     a block with n int32 of dynamic shared memory fills it with n and
//     returns its last entry. Sizes past the opt-in limit are refused by
//     cudaFuncSetAttribute (a non-sticky error, cleared before returning);
//   fk_probe_smem_input    (P2 probe_mosaic.py:55, P5 probe_mosaic2.py:30):
//     one block per grid step stages its (rb, hb) int32 block in shared
//     memory and sums x_blk[i, i & 1023] for i < rb; sums[step] receives it
//     (the TPU kernel overwrote one output, so its value is the last step's);
//   fk_probe_dyn_rows      (P3 probe_mosaic.py:92, P6 probe_mosaic2.py:47):
//     the dynamic-row gather-accumulate of kernel C, e[dst] (+)= q[src] over
//     nh hits, with src = idx[i] or row 0 and dst = row[i] or row 0, `steps`
//     times over the hits (the TPU's sequential grid). Each thread owns one
//     column and walks the hits in order, so float sums are taken in the
//     TPU's fori_loop order with no atomics; the block's column strip of e
//     lives in shared memory like the TPU's VMEM output block;
//   fk_probe_bsearch       (P4, probe_mosaic.py:146 `probe_scalar_bsearch`):
//     kernel C's lookup, a lower-bound binary search in a sorted int32 table
//     held in shared memory, one thread per query; the integer sum of the
//     positions is taken per block and added atomically (integer addition,
//     so the result does not depend on the order).
//
// Bound on the card: these are latency probes. P3/P6 run nh dependent
// shared-memory read-modify-writes per thread with the q row read from L2;
// P4 runs log2(n) dependent shared-memory loads per query.

#include "common.cuh"

namespace {

__global__ void smem_scratch_kernel(int n, int32_t* __restrict__ out) {
  extern __shared__ int32_t scratch[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) scratch[i] = n;
  __syncthreads();
  if (threadIdx.x == 0) out[0] = scratch[n - 1];
}

__global__ void smem_input_kernel(const int32_t* __restrict__ x, int rb,
                                  int hb, int32_t* __restrict__ sums) {
  extern __shared__ int32_t blk[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * rb * hb;
  for (int i = threadIdx.x; i < rb * hb; i += blockDim.x) blk[i] = x[base + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t acc = 0;
    for (int i = 0; i < rb; ++i) acc += blk[i * hb + (i & 1023)];
    sums[blockIdx.x] = acc;
  }
}

constexpr int DYN_COLS = 32;  // columns (threads) per block

__global__ void dyn_rows_kernel(const float* __restrict__ q, int d,
                                const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ row, int nh,
                                int rb, int src_dyn, int dst_dyn,
                                int accumulate, int steps,
                                float* __restrict__ e) {
  extern __shared__ float strip[];  // (rb, DYN_COLS)
  const int col = blockIdx.x * DYN_COLS + threadIdx.x;
  const bool live = col < d;
  for (int r = 0; r < rb; ++r) strip[r * DYN_COLS + threadIdx.x] = 0.0f;
  if (live) {
    for (int s = 0; s < steps; ++s) {
#pragma unroll 4
      for (int i = 0; i < nh; ++i) {
        const int src = src_dyn ? idx[i] : 0;
        const int dst = dst_dyn ? row[i] : 0;
        const float v = q[static_cast<int64_t>(src) * d + col];
        float* cell = strip + dst * DYN_COLS + threadIdx.x;
        *cell = accumulate ? *cell + v : v;
      }
    }
    for (int r = 0; r < rb; ++r)
      e[static_cast<int64_t>(r) * d + col] = strip[r * DYN_COLS + threadIdx.x];
  }
}

__global__ void bsearch_kernel(const int32_t* __restrict__ table, int n,
                               const int32_t* __restrict__ queries, int nq,
                               int32_t* __restrict__ out) {
  extern __shared__ int32_t t[];
  __shared__ int acc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) t[i] = table[i];
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  int pos = 0;
  if (qi < nq) {
    const int32_t v = queries[qi];
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (t[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos = lo;
  }
  const int total = block_sum(pos, &acc);
  if (threadIdx.x == 0) atomicAdd(out, total);
}

// Opt in to `bytes` of dynamic shared memory for `kernel`; a refusal is
// cleared from the runtime's error state and returned.
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" int fk_probe_smem_scratch(int n, int32_t* out, void* stream) {
  const int bytes = n * static_cast<int>(sizeof(int32_t));
  cudaError_t err = opt_in(smem_scratch_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_scratch_kernel<<<1, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      n, out);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

extern "C" int fk_probe_smem_input(const int32_t* x, int steps, int rb,
                                   int hb, int32_t* sums, void* stream) {
  const int bytes = rb * hb * static_cast<int>(sizeof(int32_t));
  const cudaError_t err = opt_in(smem_input_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  smem_input_kernel<<<steps, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, rb, hb, sums);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fk_probe_dyn_rows(const float* q, int d, const int32_t* idx,
                                 const int32_t* row, int nh, int rb,
                                 int src_dyn, int dst_dyn, int accumulate,
                                 int steps, float* e, void* stream) {
  const int bytes = rb * DYN_COLS * static_cast<int>(sizeof(float));
  const cudaError_t err = opt_in(dyn_rows_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dyn_rows_kernel<<<(d + DYN_COLS - 1) / DYN_COLS, DYN_COLS, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      q, d, idx, row, nh, rb, src_dyn, dst_dyn, accumulate, steps, e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fk_probe_bsearch(const int32_t* table, int n,
                                const int32_t* queries, int nq, int32_t* out,
                                void* stream) {
  if (nq <= 0) return static_cast<int>(cudaSuccess);
  const int bytes = n * static_cast<int>(sizeof(int32_t));
  const cudaError_t err = opt_in(bsearch_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsearch_kernel<<<(nq + 255) / 256, 256, bytes,
                   static_cast<cudaStream_t>(stream)>>>(table, n, queries, nq,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}
