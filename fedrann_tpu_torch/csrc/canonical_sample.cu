// Kernel A: canonical window codes + sampling filter -> staged slots.
//
// Replaces the TPU kernel `canonical_and_sample` (bench/pallas_kernels.py:93,
// body `_kernel` :42), meeting the production contract of
// fedrann_tpu/kmers/codec.py `canonical_window_codes` plus the
// `sample_hash32 < threshold` filter of membership.select_candidates, for
// every k <= 31 (one int64 code per window, no u32 word tuples).
//
// One thread per window (r, i) of the (R, W) output, W = L - k + 1: it
// reads the k bases of its window, builds the forward code and the reverse
// complement, takes the canonical min (a palindrome counts as forward),
// checks validity (no base >= 4) and the fmix32 sampling hash, and writes
// (canon << 1) | is_fwd, or PAD_SLOT.
//
// Bound on the card: device memory, ~9 bytes a window (one 8-byte store;
// the k byte loads of neighbouring threads overlap and hit L1, so the base
// reads are ~1 byte per window): 0.090 ms at the main path's 2,048 x
// 16,384 chunk. The kernel does not reach it: chip_smoke.py measures ~20%
// of that bound (0.445-0.455 ms on an NVIDIA H100 80GB HBM3, 700.00 W), so
// the store stream is not what limits it. Nothing is kept between windows:
// each thread rebuilds its window's code from k byte loads and k
// shift-or steps per strand, then hashes it, and that integer work is the
// larger cost. A rolling code (one base in and one out per window) would
// cut it; fusing this kernel into kernel B would also keep the slot plane
// out of device memory.

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void canonical_sample_kernel(const uint8_t* __restrict__ bases,
                                        int64_t rows, int64_t length,
                                        int64_t w, int k, uint32_t s1,
                                        uint32_t s2, uint32_t threshold,
                                        int keep_all,
                                        int64_t* __restrict__ out) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= rows * w) return;
  const int64_t r = idx / w;
  const int64_t i = idx - r * w;
  const uint8_t* p = bases + r * length + i;
  uint64_t code = 0, rc = 0;
  bool valid = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = p[j];
    valid &= b < 4;
    const uint64_t v = b & 3u;
    code = (code << 2) | v;
    rc |= (v ^ 3u) << (2 * j);
  }
  const bool is_fwd = code <= rc;
  const uint64_t canon = is_fwd ? code : rc;
  // sample_hash32 over the (hi, lo) 32-bit halves of the canonical code
  const uint32_t h1 = fmix32(static_cast<uint32_t>(canon) ^ s1);
  const uint32_t h2 = fmix32(static_cast<uint32_t>(canon >> 32) ^ s2 ^ h1);
  const bool keep = valid && (keep_all || fmix32(h1 ^ h2) < threshold);
  out[idx] = keep ? static_cast<int64_t>((canon << 1) | (is_fwd ? 1u : 0u))
                  : PAD_SLOT;
}

}  // namespace

// s1 = fmix32(seed32), s2 = fmix32(s1 ^ 0x9E3779B9), computed by the caller.
extern "C" int fk_canonical_sample(const uint8_t* bases, int64_t rows,
                                   int64_t length, int64_t w, int k,
                                   uint32_t s1, uint32_t s2,
                                   uint32_t threshold, int keep_all,
                                   int64_t* out, void* stream) {
  const int64_t n = rows * w;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  canonical_sample_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      bases, rows, length, w, k, s1, s2, threshold, keep_all, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
