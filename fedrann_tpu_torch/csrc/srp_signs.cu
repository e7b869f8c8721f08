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
// integer pipe, PAIRED_FIELD_INSTR an entry (4.76e9 there, 0.285 ms at
// 16.7 T/s), which bounds the bfloat16 table (half the bytes: 0.189 ms).
//
// Design: a block a band of PAIRED_BAND rows and 4 KB of a row (a thread
// a 16-byte vector, 4 float32 or 8 bfloat16 entries, in each row of the
// band), so the stores are coalesced and nothing is shared or written
// twice. A thread's half and column are fixed by its place in the block,
// in 32-bit math with no division; per row it adds GOLDEN to its hash
// base and reads the row's magnitude once. The hash is splitmix64 in
// 32-bit halves (a funnel shift and a shift a xor-shift, a wide
// multiply-add and two multiply-adds a product), its first xor-shift's
// high word and that word's share of the first product taken once a
// vector (vector_hash); the entry is the magnitude with its sign bit
// flipped where h & 1 is 0, or +0.0 by a select. bfloat16 rounds the
// magnitude once a row (round to nearest even is symmetric in the sign)
// and packs two entries a word. A bound below 0 draws no entry: the table
// is zeroed by a memset. Where d * itemsize is not a multiple of 16 (no
// half row starts on a 16-byte boundary) each thread writes its entries
// one by one.
//
// What holds it back (NVIDIA H100 80GB HBM3, 700 W, at L = 309,830, d =
// 512; tools/k8_k9_variants.py, chip_smoke.py): the float32 table takes
// ~0.40-0.41 ms, 3-6% above a fill_ of its shape (~0.39 ms: the stores);
// the bfloat16 one ~0.36-0.38 ms against a ~0.195 ms fill_: bound by the
// SM's instruction rate, its row loop running 24.9 instructions an entry
// (sm_90a SASS of the shared path: 15.9 on the integer pipe,
// PAIRED_FIELD_INSTR's 15 and the packing, and 8.0 IMAD).

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
// SIGN_FIELD_INSTR, where a vector's entries share their inputs' bits 30..
// (vector_hash): the add of the component to the low word (1), the first
// xor-shift's xor with the shared x >> 30 (1), the other two xor-shifts
// (8), the nonzero test (2), the sign bit (1) and the sign's xor and the
// select of +0.0 (2). A field alone takes 19: the 64-bit add (2) and the
// whole first xor-shift (4). The multiplies go to the FMA pipe; the
// bfloat16 packing, the per-row and per-vector work and the stores are
// not counted.
constexpr int PAIRED_FIELD_INSTR = 15;
static_assert(PAIRED_FIELD_INSTR == 1 + 1 + 8 + 2 + 1 + 2, "the count above");

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

constexpr int PAIRED_THREADS = 256;  // float32 vectors of a row a block
constexpr int PAIRED_BAND = 8;       // rows a block, one after another

// z ^ (z >> S) of z = (hi:lo), 0 < S < 32
template <int S>
__device__ __forceinline__ void xorshift(uint32_t& lo, uint32_t& hi) {
  lo ^= __funnelshift_r(lo, hi, S);
  hi ^= hi >> S;
}

// z * M mod 2^64 of z = (hi:lo): one wide multiply-add, two multiply-adds
template <uint64_t M>
__device__ __forceinline__ void mul64(uint32_t& lo, uint32_t& hi) {
  const uint64_t p = static_cast<uint64_t>(lo) * static_cast<uint32_t>(M);
  hi = static_cast<uint32_t>(p >> 32) + lo * static_cast<uint32_t>(M >> 32)
       + hi * static_cast<uint32_t>(M);
  lo = static_cast<uint32_t>(p);
}

// splitmix64's output h, as (hi:lo), from (hi:lo) = z1 * MIX1 of its input
// x's first xor-shift z1 = x ^ (x >> 30)
__device__ __forceinline__ void paired_hash_tail(uint32_t& lo,
                                                 uint32_t& hi) {
  xorshift<27>(lo, hi);
  mul64<MIX2>(lo, hi);
  xorshift<31>(lo, hi);
}

// The V fields of one thread's vector in a row, whose splitmix64 inputs
// are base + u, u < V: nz[u] whether h <= limit, and h's low word in
// lo[u] (its bit 0 the sign). Where no carry leaves bit 29 of base + u
// (every vector but one in ~2^27), bits 30.. of every input are base's,
// so x >> 30, z1's high word and that word's term of z1 * MIX1 are the
// vector's, taken once: a field then starts from its low word alone.
template <int V>
__device__ __forceinline__ void vector_hash(uint64_t base, uint64_t limit,
                                            bool* nz, uint32_t* lo_out) {
  const uint32_t lo0 = static_cast<uint32_t>(base);
  const uint32_t hi0 = static_cast<uint32_t>(base >> 32);
  if ((lo0 & 0x3FFFFFFFu) <= 0x40000000u - V) {
    const uint32_t k = __funnelshift_r(lo0, hi0, 30);  // (x >> 30)'s low word
    const uint32_t z_hi = hi0 ^ (hi0 >> 30);
    // z1 * MIX1's high word takes z_hi * MIX1's low word
    const uint64_t shared = static_cast<uint64_t>(
                                z_hi * static_cast<uint32_t>(MIX1)) << 32;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const uint32_t z_lo = (lo0 + u) ^ k;
      const uint64_t p = static_cast<uint64_t>(z_lo)
                         * static_cast<uint32_t>(MIX1) + shared;
      uint32_t lo = static_cast<uint32_t>(p);
      uint32_t hi = static_cast<uint32_t>(p >> 32)
                    + z_lo * static_cast<uint32_t>(MIX1 >> 32);
      paired_hash_tail(lo, hi);
      nz[u] = ((static_cast<uint64_t>(hi) << 32) | lo) <= limit;
      lo_out[u] = lo;
    }
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const uint64_t x = base + u;
      uint32_t lo = static_cast<uint32_t>(x);
      uint32_t hi = static_cast<uint32_t>(x >> 32);
      xorshift<30>(lo, hi);
      mul64<MIX1>(lo, hi);
      paired_hash_tail(lo, hi);
      nz[u] = ((static_cast<uint64_t>(hi) << 32) | lo) <= limit;
      lo_out[u] = lo;
    }
  }
}

// A band of rows x THREADS vectors (a float32 vector is 4 entries, a
// bfloat16 one 8, so a block spans 4 KB of a row either way): `groups`
// vectors a half, the last one ragged where V does not divide d; `vec`: d
// * itemsize is a multiple of 16 and the table 16-byte aligned, so every
// vector is one aligned store. base_mix = seed_mix + GOLDEN. An entry is
// `neg` (the negated magnitude's bits) with its sign bit flipped where h &
// 1, or 0 where the field is zero; bfloat16 entries go two to a word.
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(BF16 ? PAIRED_THREADS / 2
                                       : PAIRED_THREADS)
    srp_paired_kernel(uint64_t base_mix, uint32_t lib_size, uint32_t d,
                      uint32_t groups, uint64_t limit,
                      const float* __restrict__ mags,
                      void* __restrict__ out) {
  constexpr int V = BF16 ? 8 : 4;
  constexpr int THREADS = BF16 ? PAIRED_THREADS / 2 : PAIRED_THREADS;
  const uint32_t v = blockIdx.y * THREADS + threadIdx.x;
  if (v >= 2 * groups) return;
  const uint32_t half = v >= groups;
  const uint32_t i0 = (v - (half ? groups : 0u)) * V;  // column in the half
  const uint32_t j0 = blockIdx.x * PAIRED_BAND;
  const uint32_t j_end = min(j0 + PAIRED_BAND, lib_size + 1);
  // field (half, j, i0) draws feature half * L + j, component i0
  uint64_t base = static_cast<uint64_t>(half * lib_size + j0) * GOLDEN
                  + base_mix + i0;
  const uint64_t width = 2ull * d;  // entries a row
  for (uint32_t j = j0; j < j_end; ++j, base += GOLDEN) {
    const size_t at = j * width + half * d + i0;
    uint32_t w[4] = {0u, 0u, 0u, 0u};  // the vector's 16 bytes
    if (j < lib_size) {
      const uint32_t mag = __float_as_uint(__ldg(mags + j));
      bool nz[V];
      uint32_t lo[V];
      vector_hash<V>(base, limit, nz, lo);
      if (BF16) {
        const uint32_t neg =
            __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(mag)))
            ^ 0x8000u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = (nz[2 * k] ? neg ^ ((lo[2 * k] << 15) & 0x8000u) : 0u)
                 | (nz[2 * k + 1] ? (neg << 16) ^ (lo[2 * k + 1] << 31) : 0u);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          w[u] = nz[u] ? (mag ^ 0x80000000u) ^ (lo[u] << 31) : 0u;
        }
      }
    }
    if (VEC) {
      *reinterpret_cast<uint4*>(static_cast<char*>(out)
                                + at * (BF16 ? 2 : 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else if (BF16) {
      uint16_t* dst = static_cast<uint16_t*>(out) + at;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (i0 + u < d) {
          dst[u] = static_cast<uint16_t>(w[u / 2] >> (16 * (u % 2)));
        }
      }
    } else {
      uint32_t* dst = static_cast<uint32_t*>(out) + at;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (i0 + u < d) dst[u] = w[u];
      }
    }
  }
}

template <bool BF16>
void launch_paired(dim3 grid, bool vec, uint64_t base_mix, uint32_t lib_size,
                   uint32_t d, uint32_t groups, uint64_t limit,
                   const float* mags, void* out, cudaStream_t s) {
  constexpr int threads = BF16 ? PAIRED_THREADS / 2 : PAIRED_THREADS;
  if (vec) {
    srp_paired_kernel<BF16, true><<<grid, threads, 0, s>>>(
        base_mix, lib_size, d, groups, limit, mags, out);
  } else {
    srp_paired_kernel<BF16, false><<<grid, threads, 0, s>>>(
        base_mix, lib_size, d, groups, limit, mags, out);
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
  const int64_t rows = lib_size + 1;
  if (lib_size < 0 || d <= 0) return static_cast<int>(cudaSuccess);
  const int threads = is_bf16 ? PAIRED_THREADS / 2 : PAIRED_THREADS;
  if (2 * lib_size + 1 > UINT32_MAX || 2 * d > UINT32_MAX
      || (2 * groups + threads - 1) / threads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bound < 0) {  // no field is nonzero: +0.0 everywhere
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(rows * 2 * d * (is_bf16 ? 2 : 4)), s));
  }
  const uint64_t limit = 2 * static_cast<uint64_t>(bound) + 1;
  const bool vec = d % v == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((rows + PAIRED_BAND - 1)
                                        / PAIRED_BAND),
                  static_cast<unsigned>((2 * groups + threads - 1)
                                        / threads));
  const uint64_t base_mix = seed_mix + GOLDEN;
  if (is_bf16) {
    launch_paired<true>(grid, vec, base_mix, static_cast<uint32_t>(lib_size),
                        static_cast<uint32_t>(d),
                        static_cast<uint32_t>(groups), limit, mags, out, s);
  } else {
    launch_paired<false>(grid, vec, base_mix,
                         static_cast<uint32_t>(lib_size),
                         static_cast<uint32_t>(d),
                         static_cast<uint32_t>(groups), limit, mags, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
