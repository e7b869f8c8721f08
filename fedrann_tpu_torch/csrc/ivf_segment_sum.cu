// K9: the IVF k-means's segment sum (knn/ivf.py _segment_sum).
//
// Computes what the JAX package's _kmeans does with jax.ops.segment_sum
// (fedrann_tpu/knn/ivf.py:83, in _kmeans :61; an XLA scatter-add, no
// pl.pallas_call): sums[c] = the float32 sum of the rows assigned to
// cluster c. The order is fixed: each cluster's rows are added in row
// order, one float32 add at a time, from +0.0 (or from the sums it is
// given, so that rows streamed in chunks add as one pass would), bfloat16
// rows widened to float32 first. That is bitwise jax.ops.segment_sum on a
// CPU, and two launches give the same bits.
//
// Inputs: the row ids sorted stably by cluster (`order`, int64) and the
// (C + 1,) bounds of each cluster's run in it, both torch ops on the card
// (a stable sort and a searchsorted) with no host sync.
//
// Bound on the card: the bytes, each row read once (N * d * itemsize),
// the sorted ids (N * 8) and the bounds, and the sums written (C * d * 4):
// 537 MB at N = 262,144, d = 512 float32, 0.160 ms at 3.35 TB/s.
//
// Design: a warp a unit of (cluster, 128 columns), a lane 4 adjacent
// columns (one 16-byte float32 or 8-byte bfloat16 load a member), so
// splitting d over warps changes no bit and small C still fills the card.
// A lane walks its cluster's members in order, AHEAD rows at a time: it
// starts the AHEAD row loads (and the next AHEAD ids) before the first
// add, so loads stay in flight while the adds keep their order. Adds are
// __fadd_rn: nothing may contract them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;      // four warps, a unit each
constexpr int COLS = 128;         // columns of a unit, 4 a lane
constexpr int AHEAD = 4;          // member rows a lane loads before adding

// the 4 columns col.. of row i as float32; `vec`: one aligned vector load
template <bool BF16>
__device__ __forceinline__ void load4(const void* rows, int64_t i, int64_t d,
                                      int64_t col, bool vec, float v[4]) {
  if (BF16) {
    const uint16_t* p = static_cast<const uint16_t*>(rows) + i * d + col;
    if (vec) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(w.x << 16);
      v[1] = __uint_as_float(w.x & 0xFFFF0000u);
      v[2] = __uint_as_float(w.y << 16);
      v[3] = __uint_as_float(w.y & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = col + u < d ? __uint_as_float(
                                 static_cast<uint32_t>(__ldg(p + u)) << 16)
                           : 0.0f;
      }
    }
  } else {
    const float* p = static_cast<const float*>(rows) + i * d + col;
    if (vec) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = col + u < d ? __ldg(p + u) : 0.0f;
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    ivf_segment_sum_kernel(const void* __restrict__ rows, int64_t d,
                           const int64_t* __restrict__ order,
                           const int64_t* __restrict__ bounds,
                           int64_t n_clusters, int64_t slices, bool vec,
                           bool accumulate, float* __restrict__ out) {
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * (THREADS / 32)
                       + threadIdx.x / 32;
  if (unit >= n_clusters * slices) return;
  const int64_t c = unit / slices;
  const int64_t col = (unit - c * slices) * COLS + (threadIdx.x % 32) * 4;
  if (col >= d) return;
  const int w = static_cast<int>(d - col < 4 ? d - col : 4);
  float* dst = out + c * d + col;
  float acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = accumulate && u < w ? dst[u] : 0.0f;
  const int64_t start = bounds[c], end = bounds[c + 1];
  int64_t ids[AHEAD];
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) ids[a] = start + a < end ? order[start + a]
                                                           : 0;
  for (int64_t m = start; m < end; m += AHEAD) {
    float v[AHEAD][4];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      if (m + a < end) load4<BF16>(rows, ids[a], d, col, vec, v[a]);
    }
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      const int64_t next = m + AHEAD + a;
      ids[a] = next < end ? order[next] : 0;
    }
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      if (m + a < end) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = __fadd_rn(acc[u], v[a][u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < w) dst[u] = acc[u];
  }
}

}  // namespace

// Segment sums of rows (N, d) float32, or bfloat16 bits when is_bf16, into
// out (n_clusters, d) float32: cluster c's rows are order[bounds[c] :
// bounds[c + 1]] (int64 row ids, bounds (n_clusters + 1,) int64), added in
// that order, from 0 or, with accumulate, from out's own values.
extern "C" int fk_ivf_segment_sum(const void* rows, int64_t d, int is_bf16,
                                  const int64_t* order, const int64_t* bounds,
                                  int64_t n_clusters, int accumulate,
                                  float* out, void* stream) {
  const int64_t slices = (d + COLS - 1) / COLS;
  const int64_t units = n_clusters * slices;
  if (units <= 0) return static_cast<int>(cudaSuccess);
  const uintptr_t align = is_bf16 ? 8 : 16;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % align
                                     == 0;
  const unsigned blocks = static_cast<unsigned>(
      (units + THREADS / 32 - 1) / (THREADS / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ivf_segment_sum_kernel<true><<<blocks, THREADS, 0, s>>>(
        rows, d, order, bounds, n_clusters, slices, vec, accumulate != 0,
        out);
  } else {
    ivf_segment_sum_kernel<false><<<blocks, THREADS, 0, s>>>(
        rows, d, order, bounds, n_clusters, slices, vec, accumulate != 0,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}
