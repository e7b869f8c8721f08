// K5: the sign table of the sparse random projection (project stage), and
// K8: the same projection stored dense (--projection-dtype f32|bf16).
//
// Computes what the JAX package's build_precompute_signs computes in XLA
// (fedrann_tpu/project/srp.py:151, with _srp_sign_chunk :202 and
// _pack_signs :219; no pl.pallas_call), bitwise: the (L+1, ceil(2d/16))
// table of 2-bit codes, row j packing [P[j] | P[j+L]]. Field i of row j
// draws feature f = j, component i for i < d, and feature L + j,
// component i - d after that; h = splitmix64(f * GOLDEN + c + seed_mix) in
// wrapping uint64; the field is nonzero iff (h >> 1) <= bound (bound =
// int(density * 2^63) - 1; none when it is negative) and plus iff h & 1.
// Codes are 0 zero, 1 plus, 2 minus, field i at bits 2 * (i % 16) of word
// i / 16; row L is all zero.
//
// Bound on the card: the integer pipe. Each field is one splitmix64 on
// 64-bit values, which the 32-bit integer pipe does in pieces:
// SIGN_FIELD_INSTR below counts them. The bytes are the table written once,
// (L+1) * ceil(2d/16) * 4 (41 MB at L = 161,372, d = 512: 0.012 ms at
// 3.35 TB/s), against ~3.5e9 instructions there (0.21 ms at 16.7 T/s).
//
// Design: one thread a 32-bit output word, so the stores are coalesced and
// nothing is shared. f * GOLDEN + seed_mix is hoisted per row and half; a
// word that lies in one half (every word when d is a multiple of 16) takes
// the unrolled loop over its 16 fields, whose inputs differ only by the
// field's component; a word across the halves' seam or past 2d takes each
// field's own half.
//
// K8 computes what the JAX package's build_precompute_paired computes in
// XLA (fedrann_tpu/project/srp.py:90, with _srp_chunk :39; no
// pl.pallas_call), bitwise: the (L+1, 2d) table whose row j is [P[j] |
// P[j+L]], in float32 or rounded to bfloat16 (nearest even). Field i draws
// the same h as K5's; its entry is +mags[j] where h & 1, -mags[j]
// otherwise, and +0.0 where the field is zero (mags[j] = icf[j] * scale in
// float32, which equals JAX's sign * scale * icf bitwise); row L is all
// zero.
//
// Bound on the card: the table's bytes written once, (L+1) * 2d * 4 in
// float32 (1.269 GB at L = 309,830, d = 512: 0.379 ms at 3.35 TB/s), or the
// integer pipe, PAIRED_FIELD_INSTR a field (6.0e9 there, 0.361 ms at 16.7
// T/s), which bounds the bfloat16 table (half the bytes).
//
// Design: one thread a 16-byte vector of one half of a row (4 float32 or 8
// bfloat16 entries), so the stores are coalesced and nothing is shared or
// written twice; the row's base and magnitude are read once a thread.
// Where d * itemsize is not a multiple of 16 (no half row starts on a
// 16-byte boundary) each thread writes its entries one by one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
constexpr uint64_t MIX1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t MIX2 = 0x94D049BB133111EBull;
constexpr int THREADS = 256;

// Integer-pipe instructions of one field on the unrolled path, counted at
// the source in 32-bit pieces: the 64-bit add of the component (2; GOLDEN
// is folded into the hoisted base), three xor-shifts (a 64-bit shift is 2
// funnel shifts, a 64-bit xor 2: 12), the nonzero test as one 64-bit
// unsigned compare of h against 2 * bound + 1 (2), the sign bit (1), the
// code's select (2) and its shift-or into the word (2). The two 64-bit
// multiplies by constants (a wide multiply-add and two multiply-adds each)
// issue to the FMA pipe (IMAD), not the integer pipe, and are not counted.
constexpr int SIGN_FIELD_INSTR = 21;
static_assert(SIGN_FIELD_INSTR == 2 + 12 + 2 + 1 + 2 + 2, "the count above");

// Integer-pipe instructions of one K8 entry, counted at the source as
// SIGN_FIELD_INSTR: the 64-bit add of the component (2), three xor-shifts
// (12), the nonzero test (2), the sign bit (1) and the two selects of
// +mag, -mag and +0.0 (2). The multiplies go to the FMA pipe; the
// bfloat16 rounding and packing, and the stores, are not counted.
constexpr int PAIRED_FIELD_INSTR = 19;
static_assert(PAIRED_FIELD_INSTR == 2 + 12 + 2 + 1 + 2, "the count above");

__device__ __forceinline__ uint64_t splitmix64(uint64_t z) {
  z = (z ^ (z >> 30)) * MIX1;
  z = (z ^ (z >> 27)) * MIX2;
  return z ^ (z >> 31);
}

// code of the field whose splitmix64 input (less GOLDEN) is x: h <= limit
// is (h >> 1) <= bound for bound >= 0
__device__ __forceinline__ uint32_t code(uint64_t x, uint64_t limit,
                                         bool any) {
  const uint64_t h = splitmix64(x + GOLDEN);
  return (any && h <= limit) ? 2u - static_cast<uint32_t>(h & 1) : 0u;
}

__global__ void __launch_bounds__(THREADS)
    srp_signs_kernel(uint64_t seed_mix, int64_t lib_size, int64_t d,
                     int64_t n_words, uint64_t limit, bool any,
                     uint32_t* __restrict__ out) {
  const int64_t word = static_cast<int64_t>(blockIdx.x) * THREADS
                       + threadIdx.x;
  if (word >= (lib_size + 1) * n_words) return;
  const int64_t j = word / n_words;
  const int64_t i0 = (word - j * n_words) * 16;
  uint32_t bits = 0;
  if (j < lib_size) {
    const uint64_t left = static_cast<uint64_t>(j) * GOLDEN + seed_mix;
    const uint64_t right =
        static_cast<uint64_t>(lib_size + j) * GOLDEN + seed_mix;
    if (i0 + 16 <= d || (i0 >= d && i0 + 16 <= 2 * d)) {
      const uint64_t base = i0 < d ? left + static_cast<uint64_t>(i0)
                                   : right + static_cast<uint64_t>(i0 - d);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        bits |= code(base + u, limit, any) << (2 * u);
      }
    } else {
      for (int u = 0; u < 16 && i0 + u < 2 * d; ++u) {
        const int64_t i = i0 + u;
        const uint64_t x = i < d ? left + static_cast<uint64_t>(i)
                                 : right + static_cast<uint64_t>(i - d);
        bits |= code(x, limit, any) << (2 * u);
      }
    }
  }
  out[word] = bits;
}

// entry of the field whose splitmix64 input (less GOLDEN) is x
__device__ __forceinline__ float paired_entry(uint64_t x, uint64_t limit,
                                              bool any, float mag) {
  const uint64_t h = splitmix64(x + GOLDEN);
  return (any && h <= limit) ? ((h & 1) ? mag : -mag) : 0.0f;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// V entries (4 float32 or 8 bfloat16: 16 bytes) of one half of a row a
// thread; `groups` vectors a half, the last one ragged where V does not
// divide d; `vec`: d * itemsize is a multiple of 16, so every vector is a
// 16-byte aligned store
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    srp_paired_kernel(uint64_t seed_mix, int64_t lib_size, int64_t d,
                      int64_t groups, uint64_t limit, bool any,
                      const float* __restrict__ mags, bool vec,
                      void* __restrict__ out) {
  constexpr int V = BF16 ? 8 : 4;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * THREADS
                       + threadIdx.x;
  if (item >= (lib_size + 1) * 2 * groups) return;
  const int64_t j = item / (2 * groups);
  const int64_t r = item - j * 2 * groups;
  const int64_t half = r / groups;
  const int64_t i0 = (r - half * groups) * V;  // column within the half
  float v[V];
  if (j < lib_size) {
    const float mag = mags[j];
    const uint64_t base = static_cast<uint64_t>(half * lib_size + j) * GOLDEN
                          + seed_mix + static_cast<uint64_t>(i0);
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = paired_entry(base + u, limit, any, mag);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = 0.0f;
  }
  const int64_t at = j * 2 * d + half * d + i0;
  if (BF16) {
    uint16_t* dst = static_cast<uint16_t*>(out) + at;
    if (vec) {
      uint4 w;
      w.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
      w.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
      w.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
      w.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
      *reinterpret_cast<uint4*>(dst) = w;
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (i0 + u < d) dst[u] = static_cast<uint16_t>(bf16_bits(v[u]));
      }
    }
  } else {
    float* dst = static_cast<float*>(out) + at;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (i0 + u < d) dst[u] = v[u];
      }
    }
  }
}

}  // namespace

// The sign table of srp.build_precompute_signs: out (lib_size + 1,
// n_words) int32 bit patterns, n_words = ceil(2d / 16); seed_mix =
// splitmix64(seed); bound = int(density * 2^63) - 1 (negative: no nonzero).
extern "C" int fk_srp_signs(uint64_t seed_mix, int64_t lib_size, int64_t d,
                            int64_t n_words, int64_t bound, int32_t* out,
                            void* stream) {
  const int64_t total = (lib_size + 1) * n_words;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const bool any = bound >= 0;
  const uint64_t limit = any ? 2 * static_cast<uint64_t>(bound) + 1 : 0;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1)
                                                / THREADS);
  srp_signs_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      seed_mix, lib_size, d, n_words, limit, any,
      reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}


// The dense paired table of srp.build_precompute_paired: out (lib_size + 1,
// 2d) float32, or bfloat16 bits when is_bf16; mags (lib_size,) float32,
// icf[j] * scale; seed_mix and bound as fk_srp_signs's.
extern "C" int fk_srp_paired(uint64_t seed_mix, int64_t lib_size, int64_t d,
                             int64_t bound, const float* mags, int is_bf16,
                             void* out, void* stream) {
  const int v = is_bf16 ? 8 : 4;
  const int64_t groups = (d + v - 1) / v;
  const int64_t total = (lib_size + 1) * 2 * groups;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const bool any = bound >= 0;
  const uint64_t limit = any ? 2 * static_cast<uint64_t>(bound) + 1 : 0;
  const bool vec = d % v == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1)
                                                / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    srp_paired_kernel<true><<<blocks, THREADS, 0, s>>>(
        seed_mix, lib_size, d, groups, limit, any, mags, vec, out);
  } else {
    srp_paired_kernel<false><<<blocks, THREADS, 0, s>>>(
        seed_mix, lib_size, d, groups, limit, any, mags, vec, out);
  }
  return static_cast<int>(cudaGetLastError());
}
